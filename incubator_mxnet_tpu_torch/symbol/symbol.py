"""Symbol graphs: the part export and import need.

Counterpart of the JAX package's ``symbol/symbol.py`` (reference
``python/mxnet/symbol/symbol.py``): a :class:`Symbol` is a handle on output
entries of a small Python DAG of :class:`_Node` over the op registry; its
variables are the graph's free inputs (data, parameters and auxiliary
states). ``list_arguments``/``list_outputs``/``list_auxiliary_states``,
``get_internals``, ``infer_shape``/``infer_shape_partial``/``infer_type``,
``tojson``/``save`` and ``load_json``/``load`` keep the reference's
meaning, and the json is the JAX package's, field for field, so either
package loads the other's files.

Shape inference is forward only, as in the JAX package: a parameter
variable's shape comes from its op's data input by the per-op rules below
(the forward slice of the reference's ``FInferShape``), and an op's output
shapes from running it on tensors on the ``meta`` device (shapes, no
memory, no kernel). ``bind``, ``simple_bind``, ``Executor``, symbol
construction by op (``mx.sym.FullyConnected(...)``) and its arithmetic, and
the graph partitioner are not ported yet.
"""

from __future__ import annotations

import ast
import inspect
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import registry as _registry

__all__ = ["Group", "Symbol", "Variable", "load", "load_json", "var"]


# ---------------------------------------------------------------------------
# graph nodes
# ---------------------------------------------------------------------------
class _Node:
    """One vertex: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]], num_outputs: int = 1):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = num_outputs

    @property
    def is_variable(self) -> bool:
        return self.op is None


class _NameManager:
    """Auto-naming of op nodes (reference ``mx.name.NameManager``):
    fullyconnected0, fullyconnected1, ..."""

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def get(self, hint: str) -> str:
        with self._lock:
            idx = self._counters.get(hint, 0)
            self._counters[hint] = idx + 1
        return f"{hint}{idx}"


_name_manager = _NameManager()


# ---------------------------------------------------------------------------
# per-op symbolic metadata (the JAX package's tables)
# ---------------------------------------------------------------------------
#: auxiliary inputs: written by the forward in training, not trained
_AUX_INPUTS: Dict[str, Tuple[str, ...]] = {
    "BatchNorm": ("moving_mean", "moving_var"),
}

#: optional inputs and the attribute condition under which they exist
_OPTIONAL_INPUTS: Dict[str, Dict[str, Any]] = {
    "FullyConnected": {"bias": lambda a: not a.get("no_bias", False)},
    "Convolution": {"bias": lambda a: not a.get("no_bias", False)},
    "Deconvolution": {"bias": lambda a: not a.get("no_bias", False)},
    "LeakyReLU": {"gamma": lambda a: a.get("act_type") == "prelu"},
}


def _optional_inputs(op: str, attrs) -> List[str]:
    """The optional inputs op ``op`` with ``attrs`` has."""
    return [n for n, cond in _OPTIONAL_INPUTS.get(op, {}).items()
            if cond(attrs)]


def _fc_shapes(dshape, a):
    nh = int(a["num_hidden"])
    in_units = (int(np.prod(dshape[1:])) if a.get("flatten", True)
                else dshape[-1])
    out = {"weight": (nh, in_units)}
    if not a.get("no_bias", False):
        out["bias"] = (nh,)
    return out


def _conv_shapes(dshape, a):
    nf = int(a["num_filter"])
    kernel = a["kernel"]
    kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
    g = int(a.get("num_group", 1))
    out = {"weight": (nf, dshape[1] // g) + kernel}
    if not a.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _deconv_shapes(dshape, a):
    nf = int(a["num_filter"])
    kernel = a["kernel"]
    kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
    g = int(a.get("num_group", 1))
    out = {"weight": (dshape[1], nf // g) + kernel}
    if not a.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _bn_shapes(dshape, a):
    c = dshape[a.get("axis", 1)]
    return {"gamma": (c,), "beta": (c,),
            "moving_mean": (c,), "moving_var": (c,)}


def _ln_shapes(dshape, a):
    c = dshape[a.get("axis", -1)]
    return {"gamma": (c,), "beta": (c,)}


def _in_shapes(dshape, a):
    return {"gamma": (dshape[1],), "beta": (dshape[1],)}


def _emb_shapes(dshape, a):
    return {"weight": (int(a["input_dim"]), int(a["output_dim"]))}


def _prelu_shapes(dshape, a):
    if a.get("act_type") == "prelu":
        return {"gamma": (dshape[1],)}
    return {}


_PARAM_SHAPE_INFER = {
    "FullyConnected": _fc_shapes,
    "Convolution": _conv_shapes,
    "Deconvolution": _deconv_shapes,
    "BatchNorm": _bn_shapes,
    "LayerNorm": _ln_shapes,
    "InstanceNorm": _in_shapes,
    "GroupNorm": _in_shapes,
    "RMSNorm": lambda d, a: {"gamma": (d[a.get("axis", -1)],)},
    "Embedding": _emb_shapes,
    "LeakyReLU": _prelu_shapes,
}


def _op_input_params(opdef) -> Tuple[List[str], List[str], bool]:
    """(required inputs, optional parameters, variadic) of an op, from its
    function's signature: the parameters without a default are its
    tensor inputs, in order. An op that is a torch builtin (no Python
    signature) takes one input."""
    try:
        sig = inspect.signature(opdef.fn)
    except ValueError:
        return ["data"], [], False
    required, optional, variadic = [], [], False
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            variadic = True
            continue
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            continue
        if p.default is inspect.Parameter.empty:
            required.append(p.name)
        else:
            optional.append(p.name)
    return required, optional, variadic


# ---------------------------------------------------------------------------
# Symbol
# ---------------------------------------------------------------------------
class Symbol:
    """A handle on one or more output entries of a symbol graph."""

    def __init__(self, entries: List[Tuple[_Node, int]]):
        self._entries = entries

    # -- identity -------------------------------------------------------------
    @property
    def name(self) -> str:
        if len(self._entries) != 1:
            return "grouped"
        node, idx = self._entries[0]
        if node.num_outputs > 1 and not node.is_variable:
            return f"{node.name}_output{idx}"
        return node.name

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def attr(self, key: str):
        v = self._entries[0][0].attrs.get(key)
        return None if v is None else str(v)

    def list_attr(self) -> Dict[str, str]:
        return {k: str(v) for k, v in self._entries[0][0].attrs.items()}

    # -- traversal ------------------------------------------------------------
    def _topo_nodes(self) -> List[_Node]:
        seen: Dict[int, _Node] = {}
        order: List[_Node] = []
        stack = [(n, False) for n, _ in reversed(self._entries)]
        while stack:               # iterative: a deep net overflows recursion
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen[id(node)] = node
            stack.append((node, True))
            stack.extend((p, False) for p, _ in reversed(node.inputs)
                         if id(p) not in seen)
        return order

    def list_arguments(self) -> List[str]:
        aux = set(self._aux_node_names())
        return [n.name for n in self._topo_nodes()
                if n.is_variable and n.name not in aux]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, idx in self._entries:
            if node.is_variable:
                outs.append(node.name)
            elif node.num_outputs > 1:
                outs.append(f"{node.name}_output{idx}")
            else:
                outs.append(f"{node.name}_output")
        return outs

    def _aux_node_names(self) -> List[str]:
        names = []
        for n in self._topo_nodes():
            if n.is_variable or n.op not in _AUX_INPUTS:
                continue
            for (parent, _), pname in zip(n.inputs,
                                          self._input_param_names(n)):
                if pname in _AUX_INPUTS[n.op] and parent.is_variable:
                    names.append(parent.name)
        return names

    @staticmethod
    def _input_param_names(node: _Node) -> List[str]:
        """The op parameter each of ``node.inputs`` binds, in order."""
        req, _opt, variadic = _op_input_params(_registry.get(node.op))
        if variadic and not req:
            return [f"arg{i}" for i in range(len(node.inputs))]
        names = list(req) + _optional_inputs(node.op, node.attrs)
        names += [n for n in node.attrs.get("__extra_inputs__", ())
                  if n not in names]
        return names[:len(node.inputs)] + [
            f"in{i}" for i in range(len(names), len(node.inputs))]

    def list_auxiliary_states(self) -> List[str]:
        seen, out = set(), []
        for n in self._aux_node_names():
            if n not in seen:
                seen.add(n)
                out.append(n)
        return out

    def get_internals(self) -> "Symbol":
        """Every node's outputs as one group (reference
        ``Symbol.get_internals``)."""
        entries = []
        for n in self._topo_nodes():
            for i in range(1 if n.is_variable else n.num_outputs):
                entries.append((n, i))
        return Symbol(entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError(f"no output named {index!r}: {names}")
            index = names.index(index)
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    # -- inference ------------------------------------------------------------
    def infer_shape(self, **known):
        """(argument, output, auxiliary) shapes from the given input
        shapes; raises if one stays unknown."""
        return self._infer_shape_impl(known, partial=False)

    def infer_shape_partial(self, **known):
        """:meth:`infer_shape`, with None where a shape stays unknown."""
        return self._infer_shape_impl(known, partial=True)

    def _infer_shape_impl(self, known, partial):
        shapes: Dict[str, Optional[Tuple[int, ...]]] = {}
        for n in self._topo_nodes():
            if not n.is_variable:
                continue
            if n.name in known:
                shapes[n.name] = tuple(known[n.name])
            elif "__shape__" in n.attrs:
                shapes[n.name] = tuple(n.attrs["__shape__"])
            else:
                shapes[n.name] = None
        out_shapes: Dict[Tuple[int, int], Tuple[int, ...]] = {}

        def entry_shape(node, idx):
            if node.is_variable:
                return shapes.get(node.name)
            return out_shapes.get((id(node), idx))

        for n in self._topo_nodes():
            if n.is_variable:
                continue
            pnames = self._input_param_names(n)
            data_shape = entry_shape(*n.inputs[0]) if n.inputs else None
            infer = _PARAM_SHAPE_INFER.get(n.op)
            if infer is not None and data_shape is not None:
                pshapes = infer(data_shape, n.attrs)
                for (parent, _), pname in zip(n.inputs, pnames):
                    if (parent.is_variable and shapes.get(parent.name) is None
                            and pname in pshapes):
                        shapes[parent.name] = tuple(pshapes[pname])
            in_shapes = [entry_shape(p, i) for p, i in n.inputs]
            if any(s is None for s in in_shapes):
                continue
            kwargs = {k: v for k, v in n.attrs.items()
                      if not k.startswith("__")}
            metas = [torch.empty(s, device="meta") for s in in_shapes]
            try:
                out = _call_node_fn(_registry.get(n.op), n, metas, kwargs,
                                    is_train=False)
            except Exception:
                if partial:
                    continue
                raise
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                out_shapes[(id(n), i)] = tuple(o.shape)

        arg_shapes = [shapes.get(a) for a in self.list_arguments()]
        aux_shapes = [shapes.get(a) for a in self.list_auxiliary_states()]
        outs = [entry_shape(n, i) for n, i in self._entries]
        if not partial:
            missing = [a for a, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            if missing or any(s is None for s in outs):
                raise ValueError(
                    f"infer_shape incomplete; unknown: {missing}; provide "
                    "shapes for the data variables (forward-only inference)")
        return arg_shapes, outs, aux_shapes

    def infer_type(self, **known):
        """Forward type inference: every leaf not given is float32 (the
        reference's behaviour for nets)."""
        args = self.list_arguments()
        return ([known.get(a, np.float32) for a in args],
                [np.float32 for _ in self._entries],
                [np.float32 for _ in self.list_auxiliary_states()])

    # -- serialization --------------------------------------------------------
    def tojson(self) -> str:
        nodes = self._topo_nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            attrs = {k: (v if isinstance(v, str) else repr(v))
                     for k, v in n.attrs.items()}
            out_nodes.append({
                "op": "null" if n.is_variable else n.op,
                "name": n.name,
                "attrs": attrs,
                "inputs": [[nid[id(p)], i, 0] for p, i in n.inputs],
                "num_outputs": n.num_outputs,
            })
        payload = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "heads": [[nid[id(n)], i, 0] for n, i in self._entries],
            "attrs": {"framework": "incubator_mxnet_tpu_torch",
                      "json_version": 1},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())


# ---------------------------------------------------------------------------
# node evaluation (shared with the executor)
# ---------------------------------------------------------------------------
def _call_node_fn(opdef, node: _Node, in_arrays, kwargs, is_train,
                  rng=None):
    """Call a registered op for a node: the required inputs by position,
    the optional ones by name, ``training`` and ``rng`` where the op
    takes them."""
    kw = dict(kwargs)
    kw.pop("__extra_inputs__", None)
    try:
        params = inspect.signature(opdef.fn).parameters
    except ValueError:
        params = {}
    if "training" in params:
        kw["training"] = bool(is_train)
    if opdef.needs_rng:
        if rng is None:
            from .. import random as _random
            from ..ndarray.ndarray import _context_of

            rng = _random.generator(_context_of(in_arrays[0]))
        kw["rng"] = rng
    req, _opt, variadic = _op_input_params(opdef)
    if variadic and not req:
        return opdef.fn(*in_arrays, **kw)
    pnames = Symbol._input_param_names(node)
    pos = list(in_arrays[:len(req)])
    for pname, arr in zip(pnames[len(req):], in_arrays[len(req):]):
        kw[pname] = arr
    return opdef.fn(*pos, **kw)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------
def var(name: str, shape=None, dtype=None, init=None, **kwargs) -> Symbol:
    """A symbol variable (reference ``mx.sym.Variable``); ``init`` is an
    initializer's name."""
    attrs = dict(kwargs)
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype).replace("torch.", "") \
            if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    if init is not None:
        attrs["__init__"] = str(init)
    return Symbol([(_Node(None, name, attrs, []), 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    """One symbol of the outputs of ``symbols``, in order."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


# ---------------------------------------------------------------------------
# json
# ---------------------------------------------------------------------------
def _parse_attr(v: str):
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_json(json_str: str) -> Symbol:
    """A symbol of a :meth:`Symbol.tojson` string (either package's)."""
    payload = json.loads(json_str)
    nodes: List[_Node] = []
    for spec in payload["nodes"]:
        attrs = {k: _parse_attr(v) for k, v in spec.get("attrs", {}).items()}
        inputs = [(nodes[i], oi) for i, oi, _ in spec.get("inputs", [])]
        op = None if spec["op"] == "null" else spec["op"]
        if op is not None and _registry.get(op) is None:
            raise ValueError(f"symbol JSON references unknown op {op!r}")
        nodes.append(_Node(op, spec["name"], attrs, inputs,
                           spec.get("num_outputs", 1)))
    return Symbol([(nodes[i], oi) for i, oi, _ in payload["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
