"""Symbol graph evaluation.

Counterpart of the JAX package's ``executor.py``: :func:`_interpret`
evaluates a symbol's DAG node by node with the port's registered ops, on
whatever tensors it is given, so torch's autograd records it as any
forward and a registered op with a kernel (``flash_attention``) launches
it. ``Executor``, ``bind`` and ``simple_bind`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

from .ops import registry as _registry
from .symbol.symbol import _AUX_INPUTS, Symbol, _call_node_fn

__all__ = []


def _interpret(symbol: Symbol, arg_arrays: Dict[str, Any],
               aux_arrays: Dict[str, Any], is_train: bool, rng=None):
    """Evaluate the DAG; returns ``(outputs, new_aux)``. In training a
    BatchNorm node folds its batch statistics into its auxiliary states,
    ``momentum * old + (1 - momentum) * batch``, as the reference writes
    them (``new_aux`` holds the new tensors; the caller writes them
    back)."""
    values: Dict = {}
    new_aux: Dict[str, Any] = dict(aux_arrays)
    for node in symbol._topo_nodes():
        if node.is_variable:
            if node.name in arg_arrays:
                values[(id(node), 0)] = arg_arrays[node.name]
            elif node.name in aux_arrays:
                values[(id(node), 0)] = aux_arrays[node.name]
            else:
                raise ValueError(
                    f"variable {node.name!r} is not bound; bound args: "
                    f"{sorted(arg_arrays)} aux: {sorted(aux_arrays)}")
            continue
        opdef = _registry.get(node.op)
        ins = [values[(id(p), i)] for p, i in node.inputs]
        kwargs = {k: v for k, v in node.attrs.items()
                  if not k.startswith("__")}
        out = _call_node_fn(opdef, node, ins, kwargs, is_train, rng)
        if (node.op in _AUX_INPUTS and is_train
                and isinstance(out, tuple) and len(out) == 3):
            out, bmean, bvar = out
            momentum = float(node.attrs.get("momentum", 0.9))
            pnames = Symbol._input_param_names(node)
            for (parent, _), pname in zip(node.inputs, pnames):
                if not parent.is_variable:
                    continue
                batch = {"moving_mean": bmean, "moving_var": bvar}.get(pname)
                if batch is not None:
                    old = new_aux[parent.name]
                    new_aux[parent.name] = (momentum * old
                                            + (1 - momentum)
                                            * batch.detach())
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            values[(id(node), i)] = o
    outputs = [values[(id(n), i)] for n, i in symbol._entries]
    return outputs, new_aux
