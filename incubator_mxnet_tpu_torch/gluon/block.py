"""Block, HybridBlock, CachedOp and SymbolBlock.

Counterpart of the JAX package's ``gluon/block.py`` on ``torch.nn.Module``.

Two names for each parameter, as in the reference:

* the structural name, the module attribute path (``0.weight``,
  ``layer0.attn.qkv.weight``), which equals the JAX package's structural
  name (``_collect_params_with_prefix``): ``save_parameters``,
  ``parallel.collect_params``, ``load_jax_params`` and the export's
  variables speak it;
* ``Parameter.name``, the prefix name (``dense0_weight``) that
  ``_BlockScope``, ``prefix``, ``name_scope()`` and ``params=`` make, as
  the reference's: :meth:`Block.collect_params` returns a
  :class:`~.parameter.ParameterDict` keyed by it.

Parameters are declared on the ``meta`` device (shape only, no memory) and
materialize on a real device in :meth:`Block.initialize` or when weights are
loaded, the way MXNet defers initialization. A dimension declared 0 (a
``Dense`` without ``in_units``, a conv without ``in_channels``) is unknown
until the block's first forward: ``initialize`` then records the
initializer and places a parameter with no elements on the device, and the
first call runs the block's :meth:`Block.infer_shape` on its input and
draws the parameter in place (the same tensor object, so a trainer made
before that trains it). Whether a layer trains (dropout on) follows
``autograd.is_training()``, as in MXNet, not torch's per-module
``training`` flag.

A block called on NDArrays returns NDArrays, as the JAX package's blocks
do, and records for autograd only under ``autograd.record()``; called on
tensors it returns tensors. Its ``forward`` gets tensors; a
:class:`HybridBlock` that defines ``hybrid_forward(F, x, ...)`` gets
NDArrays there, with ``F`` the port's ``mx.nd``, as in MXNet 1.x.

``hybridize()`` runs a :class:`HybridBlock` called on NDArrays on the card
through a :class:`CachedOp`: one CUDA graph a call signature, or a
forward/backward pair of graphs under ``autograd.record()``. On the CPU a
hybridized block runs eagerly. ``export`` writes the reference's
``-symbol.json`` and ``-NNNN.params``, recorded from one forward through
the op registry (``ops.registry.GraphRecorder``); :class:`SymbolBlock`
runs such a graph again (``executor._interpret``).
"""

from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
from torch.utils.hooks import RemovableHandle

from .. import autograd
from ..device import Context, resolve
from ..ndarray.ndarray import NDArray
from ..ops import registry as _registry
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)

__all__ = ["Block", "CachedOp", "Constant", "DeferredInitializationError",
           "HybridBlock", "Parameter", "ParameterDict", "SymbolBlock"]


# ---------------------------------------------------------------------------
# naming (reference _BlockScope / _name_counter)
# ---------------------------------------------------------------------------
class _BlockScope:
    """Counter-based naming scope of one block (reference
    ``_BlockScope``): a child made inside ``with parent.name_scope():``
    takes the parent's prefix and a per-parent counter."""

    _tls = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old = None

    @classmethod
    def _current(cls):
        return getattr(cls._tls, "current", None)

    @classmethod
    def create(cls, prefix, params, hint) -> Tuple[str, ParameterDict]:
        current = cls._current()
        if current is None:
            if prefix is None:
                prefix = _name_counter(hint) + "_"
            if params is not None:
                return prefix, ParameterDict(params.prefix, params)
            return prefix, ParameterDict(prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        parent = current._block._params
        full_prefix = parent.prefix + prefix
        if params is not None:
            return full_prefix, ParameterDict(params.prefix, params)
        return full_prefix, ParameterDict(full_prefix, parent._shared)

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old = self._current()
        type(self)._tls.current = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        type(self)._tls.current = self._old


_global_counters: Dict[str, int] = {}


def _name_counter(hint: str) -> str:
    count = _global_counters.get(hint, 0)
    _global_counters[hint] = count + 1
    return f"{hint}{count}"


def _camel_to_snake(name: str) -> str:
    return re.sub("([a-z0-9])([A-Z])", r"\1_\2",
                  re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)).lower()


def _wrap(out):
    """Tensors (or a tuple/list of them) as NDArrays."""
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    if isinstance(out, torch.Tensor):
        own = out.contiguous()
        _registry.alias(out, own)
        return NDArray(own)
    return out


def _unwrap(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap(o) for o in out)
    return out._data if isinstance(out, NDArray) else out


class Block(torch.nn.Module):
    """``torch.nn.Module`` with MXNet's Block surface (reference
    ``gluon.Block``): ``prefix``/``params`` naming and sharing,
    ``collect_params``, ``initialize``, hooks, save and load."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        super().__init__()
        self.training = False
        # a parameter of this block waits for its shape (a dim declared 0)
        self._shapes_pending = False
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, _camel_to_snake(type(self).__name__))
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params: Dict[str, Parameter] = {}
        self._mx_fwd_hooks: "OrderedDict[int, object]" = OrderedDict()
        self._mx_pre_hooks: "OrderedDict[int, object]" = OrderedDict()

    # -- identity -------------------------------------------------------------
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def params(self) -> ParameterDict:
        """This block's own ParameterDict (shared ones included)."""
        return self._params

    def name_scope(self):
        """``with self.name_scope():`` children made inside take this
        block's prefix."""
        return self._scope

    # -- registration ---------------------------------------------------------
    def _bind_param(self, leaf: str, p: Parameter) -> None:
        torch.nn.Module.register_parameter(self, leaf, p._var)
        self._reg_params[leaf] = p
        p._bind(self, leaf)
        if p.shape is None or 0 in p.shape:
            self._shapes_pending = True

    def register_parameter(self, name: str, param) -> None:
        """torch's registration, with a :class:`Parameter` handle on the
        tensor (named ``prefix + name``)."""
        super().register_parameter(name, param)
        if param is not None:
            p = self._reg_params.get(name)
            if p is None or p._var is not param:
                p = Parameter._adopt(self._params.prefix + name, param)
                self._reg_params[name] = p
                p._bind(self, name)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            # reference style: self.weight = self.params.get("weight", ...)
            if name not in self._reg_params:
                self._bind_param(name, value)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def _declare(self, name: str, shape, grad_req: str = "write",
                 init=None, dtype="float32", **kwargs) -> None:
        """Declare parameter ``name`` of ``shape`` and ``dtype`` through
        ``self.params.get`` (so ``params=`` shares it) and bind its tensor
        to this block's slot ``name``. A dim of 0 is unknown until the
        first forward (:meth:`infer_shape`). ``grad_req="null"`` declares
        state that no gradient reaches (BatchNorm running statistics):
        ``requires_grad=False``, and trainers leave it out. ``init`` (an
        initializer or its name) is the parameter's own, which
        :meth:`initialize` prefers to its global one."""
        p = self._params.get(name, shape=tuple(int(s) for s in shape),
                             grad_req=grad_req, init=init, dtype=dtype,
                             **kwargs)
        self._bind_param(name, p)

    def register_child(self, block: "Block", name: Optional[str] = None):
        """Register ``block`` as child ``name`` (default: its index)."""
        self.add_module(name or str(len(self._modules)), block)
        return block

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call, with the arguments as
        given (NDArrays when called on NDArrays, as in the reference); a
        result that is not None replaces the arguments, as in torch.
        Returns a handle whose ``remove()`` takes the hook off."""
        handle = RemovableHandle(self._mx_pre_hooks)
        self._mx_pre_hooks[handle.id] = hook
        return handle

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each call; a result that is
        not None replaces the output. Returns a removable handle."""
        handle = RemovableHandle(self._mx_fwd_hooks)
        self._mx_fwd_hooks[handle.id] = hook
        return handle

    # -- parameters -----------------------------------------------------------
    def _handles(self):
        """``(structural name, Parameter)`` of every parameter, each once,
        in registration order (own first, then the children's)."""
        seen = set()
        for mname, mod in self.named_modules():
            if not isinstance(mod, Block):
                for leaf, t in mod._parameters.items():
                    if t is not None and id(t) not in seen:
                        seen.add(id(t))
                        name = f"{mname}.{leaf}" if mname else leaf
                        yield name, Parameter._adopt(name, t)
                continue
            for leaf, p in mod._reg_params.items():
                if mod._parameters.get(leaf) is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{mname}.{leaf}" if mname else leaf), p

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's and its children's parameters by
        ``Parameter.name`` (reference ``Block.collect_params``), those
        matching the regular expression ``select`` if given."""
        out = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        for _, p in self._handles():
            if pattern is None or pattern.match(p.name):
                out._params[p.name] = p
        return out

    def _collect_params_with_prefix(self) -> "OrderedDict[str, Parameter]":
        """Parameters by structural name (reference
        ``_collect_params_with_prefix``)."""
        return OrderedDict(self._handles())

    def _slot(self, name: str) -> Parameter:
        owner, _, leaf = name.rpartition(".")
        mod = self.get_submodule(owner) if owner else self
        return mod._reg_params[leaf]

    def set_param(self, name: str, value: torch.Tensor) -> None:
        """Replace parameter ``name`` (dotted path) by ``value``, keeping
        its attributes; every block holding it sees the new tensor."""
        p = self._slot(name)
        p._set_var(torch.nn.Parameter(
            value, requires_grad=p._var.requires_grad))
        self._clear_cached_ops()

    def infer_shape(self, *args) -> dict:
        """The full shapes of this block's parameters declared with a dim
        of 0, from the inputs of its first forward: ``{name: shape}``, or
        None after setting ``Parameter.shape`` (the reference's style).
        Layers with such parameters override it."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer its parameter shapes; "
            "pass in_units/in_channels")

    def _finish_deferred(self, *args) -> None:
        """Before the first forward: fill the unknown dims from the input
        and draw those parameters with the initializer ``initialize``
        recorded, in place."""
        pending = [(leaf, p) for leaf, p in self._reg_params.items()
                   if self._parameters.get(leaf) is not None
                   and not p._known()]
        for leaf, p in pending:
            if getattr(p._var, "_mx_init", None) is None:
                raise DeferredInitializationError(
                    f"parameter {leaf} of {type(self).__name__} was not "
                    "initialized; call .initialize() before the first "
                    "forward")
        if pending:
            shapes = self.infer_shape(*args)
            for leaf, p in pending:
                p._finish_deferred_init(None if shapes is None
                                        else shapes[leaf])
        self._shapes_pending = False

    def _pending(self) -> bool:
        return any(isinstance(m, Block) and m._shapes_pending
                   for m in self.modules())

    # -- call -----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not (self._mx_pre_hooks or self._mx_fwd_hooks):
            return self._call(*args, **kwargs)
        for hook in list(self._mx_pre_hooks.values()):
            got = hook(self, args)
            if got is not None:
                args = got if isinstance(got, tuple) else (got,)
        out = self._call(*args, **kwargs)
        for hook in list(self._mx_fwd_hooks.values()):
            got = hook(self, args, out)
            if got is not None:
                out = got
        return out

    def _call(self, *args, **kwargs):
        on_nd = any(isinstance(a, NDArray) for a in args)
        if on_nd:
            args = [a._data if isinstance(a, NDArray) else a for a in args]
        if self._shapes_pending:
            self._finish_deferred(*args)
        if not on_nd:
            return super().__call__(*args, **kwargs)
        with torch.set_grad_enabled(autograd.is_recording()):
            out = super().__call__(*args, **kwargs)
        return _wrap(out)

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, init=None, ctx: Optional[Context] = None,
                   verbose: bool = False, force_reinit: bool = False):
        """Draw every parameter not drawn yet (all with ``force_reinit``)
        on ``ctx`` (default ``gpu(0)``) in its dtype with its own
        initializer (``_declare``'s ``init``) if it has one, else with
        ``init`` (an initializer or its name; None is ``"uniform"``,
        ``Uniform(0.07)``, as in MXNet); returns ``self``. A parameter
        whose shape waits for the first forward gets no elements on
        ``ctx`` now and is drawn by that forward (values drawn in fp32,
        then cast, as the reference)."""
        for name, p in list(self._handles()):
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit, _name=name)
        for mod in self.modules():
            if isinstance(mod, Block):
                mod._shapes_pending = any(
                    not p._known() for leaf, p in mod._reg_params.items()
                    if mod._parameters.get(leaf) is not None)
        return self

    def cast(self, dtype) -> "Block":
        """Cast every parameter to ``dtype`` (a torch dtype or its name,
        e.g. ``"bfloat16"``) in place, keeping each parameter object, so a
        Trainer made before the cast trains the cast weights (as the JAX
        package's ``Parameter.cast`` does); clears the cached graphs;
        returns ``self``."""
        for _, p in self._handles():
            p.cast(dtype)
        self._clear_cached_ops()
        return self

    def zero_grad(self, set_to_none: bool = False) -> None:
        """Zeros into every gradient (MXNet's ``zero_grad``; torch's
        ``set_to_none`` drops them instead)."""
        if set_to_none:
            return super().zero_grad(set_to_none=True)
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx) -> None:
        """Move every parameter to ``ctx`` in place."""
        self.collect_params().reset_ctx(ctx)
        self._clear_cached_ops()

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """Hybridize every :class:`HybridBlock` child (a plain Block runs
        eagerly, as in the reference)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def _clear_cached_ops(self) -> None:
        for mod in self.modules():
            if isinstance(mod, HybridBlock):
                mod._cached_op = None

    # -- serialization --------------------------------------------------------
    def save_parameters(self, filename: str) -> None:
        """Save every parameter under its structural name with
        ``mx.nd.save`` (reference ``Block.save_parameters``; the JAX
        package writes the same container, so either package loads the
        other's file). A parameter still waiting for its shape is left
        out, as the reference leaves out one with no data."""
        from ..ndarray import ndarray as _nd

        _nd.save(filename, {n: NDArray(p.detach())
                            for n, p in self.named_parameters()
                            if p.device.type != "meta" and 0 not in p.shape})

    def load_parameters(self, filename: str, ctx: Optional[Context] = None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False) -> "Block":
        """Load a ``save_parameters`` file (reference
        ``Block.load_parameters``). Each value takes its parameter's type;
        a drawn parameter is written in place (same tensor and address, so
        a trainer or a captured graph that holds it sees the new values),
        one not drawn yet (or waiting for its shape) is placed on ``ctx``
        (default ``gpu(0)``). A missing parameter raises unless
        ``allow_missing``, an unknown name unless ``ignore_extra``."""
        from ..device import cpu
        from ..ndarray import ndarray as _nd

        loaded = {k: v._data for k, v in _nd.load(filename,
                                                 ctx=cpu()).items()}
        return self._load_parameters_dict(loaded, filename, ctx,
                                          allow_missing, ignore_extra)

    def _load_parameters_dict(self, loaded, source: str = "<dict>",
                  ctx: Optional[Context] = None, allow_missing: bool = False,
                  ignore_extra: bool = False) -> "Block":
        """:meth:`load_parameters` over an in-memory ``{name: tensor}``
        dict."""
        params = dict(self.named_parameters())
        for name, p in params.items():
            if name not in loaded:
                if not allow_missing:
                    raise KeyError(
                        f"parameter {name} missing in {source}; available:"
                        f" {sorted(loaded)[:8]}...")
                continue
            v = torch.as_tensor(loaded[name])
            if v.dim() != p.dim() or any(d and d != s for d, s in
                                         zip(p.shape, v.shape)):
                if not (p.device.type == "meta" and p.shape == (0,)):
                    raise ValueError(f"parameter {name}: declared shape "
                                     f"{tuple(p.shape)} does not match "
                                     f"saved shape {tuple(v.shape)}")
            if p.device.type == "meta" or 0 in p.shape:
                dev = resolve(ctx) if p.device.type == "meta" else p.device
                self.set_param(name, v.to(device=dev, dtype=p.dtype))
            else:
                with torch.no_grad():
                    p.copy_(v)
        for mod in self.modules():
            if isinstance(mod, Block) and mod._shapes_pending:
                mod._shapes_pending = any(
                    0 in q.shape for q in mod._parameters.values()
                    if q is not None)
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise KeyError(f"{source} has extra parameters "
                               f"{sorted(extra)[:8]}")
        return self

    def save_params(self, filename: str) -> None:
        """Legacy save under the prefix names, less this block's prefix
        (reference ``Block.save_params``)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename: str, ctx=None, allow_missing=False,
                    ignore_extra=False) -> None:
        """Load a :meth:`save_params` file (reference
        ``Block.load_params``)."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, restore_prefix=self.prefix)

    @property
    def device(self) -> torch.device:
        """Device of the parameters (``meta`` before initialization)."""
        return next(self.parameters()).device


# ---------------------------------------------------------------------------
# CachedOp: the captured forward behind hybridize()
# ---------------------------------------------------------------------------
#: captures and replays of every CachedOp in the process
cached_op_counts = {"captures": 0, "replays": 0}


class _Replay(torch.autograd.Function):
    """A :class:`~..parallel.superstep.PairGraph` as one node of torch's
    graph: the forward replays the captured forward, the backward the
    captured backward. The arguments after the pair are the inputs and
    the parameters the gradients go to (torch's edges)."""

    @staticmethod
    def forward(ctx, pair, *args):
        ctx.pair = pair
        pair.claim(ctx)
        outs = pair.run_forward(args[:pair.n_inputs])
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, pair.out_diff)
                                      if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.pair.run_backward(grads))


class CachedOp:
    """The captured replay of a :class:`HybridBlock` (reference
    ``src/imperative/cached_op.cc``) on the card: one CUDA graph a call
    signature (the parameters' and inputs' shapes and dtypes, training
    and recording, as the reference's ``_sig``). Not recording, the
    forward is captured once and replayed (``superstep.GraphCache``);
    recording, the forward and its backward are captured as a pair of
    graphs (``superstep.capture_pair``) and run as one autograd node.
    Parameters stay where they are: the graphs read them in place, so an
    optimizer's in-place update or ``load_parameters`` shows in the next
    replay. A capture that fails raises; nothing falls back to eager."""

    #: signatures a CachedOp keeps graphs for (least recently used goes)
    SIZE = 8

    def __init__(self, block: "HybridBlock", **flags):
        # static_alloc/static_shape: a CUDA graph fixes its memory anyway
        self._block = block
        self._graphs = None
        self._pairs: "OrderedDict[tuple, list]" = OrderedDict()
        self._single: Dict[tuple, bool] = {}
        self.captures = 0
        self.replays = 0

    @staticmethod
    def _sig(params, inputs, training, recording):
        return (tuple((tuple(p.shape), str(p.dtype)) for p in params),
                tuple((tuple(x.shape), str(x.dtype)) for x in inputs),
                training, recording)

    def __call__(self, *args: NDArray):
        block = self._block
        named = list(block.named_parameters())
        params = [p for _, p in named]
        inputs = [a._data for a in args]
        training = autograd.is_training()
        recording = autograd.is_recording()
        device = inputs[0].device
        key = self._sig(params, inputs, training, recording)

        def forward(*xs, values=None):
            with autograd._RecordingStateScope(None, training):
                out = torch.nn.Module.__call__(block, *xs) if values is None \
                    else torch.func.functional_call(block, values, xs)
            flat = out if isinstance(out, (tuple, list)) else (out,)
            return tuple(flat), not isinstance(out, (tuple, list))

        grads = recording and any(t.requires_grad for t in params + inputs)
        _tls.depth = getattr(_tls, "depth", 0) + 1
        try:
            if not grads:
                outs, one = self._replay_forward(key, inputs, params, forward,
                                                 device)
            else:
                pair = self._pair(key, inputs, named, forward, device)
                outs = list(_Replay.apply(pair, *inputs, *[
                    p for p in params if p.requires_grad]))
                one = pair.single
                self._count(0)
        finally:
            _tls.depth -= 1
        if recording and not grads:
            autograd.mark_recorded(outs)
        nds = [NDArray(o) for o in outs]
        return nds[0] if one else nds

    def _replay_forward(self, key, inputs, params, forward, device):
        from ..parallel import superstep

        if self._graphs is None:
            self._graphs = superstep.GraphCache(device, size=self.SIZE)
        before = self._graphs.captures

        def body_of(static):
            def body(i):
                with torch.no_grad():
                    outs, one = forward(*static)
                self._single[key] = one
                return outs
            return body

        outs = self._graphs.run(key, inputs, body_of, 1, params)[0]
        self._count(self._graphs.captures - before)
        # the graph's outputs are rewritten by its next replay
        return [o.clone() for o in outs], self._single[key]

    def _count(self, captured: int) -> None:
        self.captures += captured
        self.replays += 1
        cached_op_counts["captures"] += captured
        cached_op_counts["replays"] += 1

    def _pair(self, key, inputs, named, forward, device):
        """A free forward/backward pair of ``key``'s graphs (captured
        when every one is waiting for its backward). The capture runs the
        block on aliases of its parameters (``detach()``: the same
        memory, read in place by every replay) and differentiates with
        respect to them, so it touches no gradient accumulator of the
        parameters (torch ties one to the stream it was made on; one made
        by an eager step on the default stream would break the capture)."""
        from ..parallel import superstep

        params = [p for _, p in named]
        addrs = tuple(p.data_ptr() for p in params)
        full = (key, addrs)
        pairs = self._pairs.get(full)
        if pairs is None:
            for old in [f for f in self._pairs if f[1] != addrs]:
                del self._pairs[old]
            pairs = self._pairs[full] = []
            while len(self._pairs) > self.SIZE:
                self._pairs.popitem(last=False)
        self._pairs.move_to_end(full)
        for pair in pairs:
            if not pair.busy() and pair.current():
                return pair
        aliases = {n: p.detach().requires_grad_(p.requires_grad)
                   for n, p in named}
        with superstep.dispatch(device):
            pair = superstep.capture_pair(
                lambda *xs: forward(*xs, values=aliases), inputs,
                list(aliases.values()), params, device)
        self.captures += 1
        cached_op_counts["captures"] += 1
        pairs.append(pair)
        return pair


#: ``depth`` > 0 inside a CachedOp's call: the blocks it calls run eagerly
#: (into its capture)
_tls = threading.local()


def _on_card(args) -> bool:
    return bool(args) and all(isinstance(a, NDArray) and a._data.is_cuda
                              for a in args)


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class HybridBlock(Block):
    """A Block that can run as a captured graph (reference
    ``HybridBlock``). Write ``forward(x, ...)`` on tensors, as the port's
    layers do, or ``hybrid_forward(F, x, *args, **params)`` with ``F`` the
    port's ``mx.nd`` and this block's parameters passed as NDArrays by
    name, as in MXNet 1.x. ``hybridize()`` routes a call on NDArrays on
    the card through a :class:`CachedOp`; the first call, which fills
    deferred shapes, runs eagerly."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op: Optional[CachedOp] = None
        self._cached_op_args: dict = {}

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs) -> None:
        """Capture this block's calls on the card (``active``), recursively;
        clears the captured graphs."""
        self._active = active
        self._cached_op = None
        self._cached_op_args = dict(static_alloc=static_alloc,
                                    static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _resolve_params(self, *args) -> Dict[str, NDArray]:
        """This block's parameters as NDArrays by slot name (deferred
        shapes filled from ``args`` first)."""
        if self._shapes_pending:
            self._finish_deferred(*[_unwrap(a) for a in args])
        return {leaf: NDArray(self._parameters[leaf])
                for leaf in self._reg_params
                if self._parameters.get(leaf) is not None}

    def forward(self, x, *args):
        from .. import ndarray as F

        params = self._resolve_params(x, *args)
        nds = [NDArray(a) if isinstance(a, torch.Tensor) else a
               for a in (x,) + args]
        return _unwrap(self.hybrid_forward(F, *nds, **params))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} defines neither forward nor "
            "hybrid_forward")

    def _call(self, *args, **kwargs):
        if args and isinstance(args[0], NDArray) and all(
                isinstance(a, NDArray) for a in args):
            # the signature export() replays: a call on NDArrays, as the
            # reference records it (past torch's slow __setattr__)
            self.__dict__["_last_input_spec"] = [
                (a.shape, a._data.dtype) for a in args]
        if (self._active and not kwargs and _on_card(args)
                and not _registry._recorders and not _capturing()
                and not getattr(_tls, "depth", 0) and not self._pending()):
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._cached_op_args)
            return self._cached_op(*args)
        return super()._call(*args, **kwargs)

    # -- export -------------------------------------------------------------
    def export(self, path: str, epoch: int = 0):
        """Write ``path-symbol.json`` and ``path-{epoch:04d}.params``
        (reference ``HybridBlock.export``), loadable by
        :meth:`SymbolBlock.imports` of either package. The graph is
        recorded from one inference forward on zeros of the last call's
        signature: every registered-op call becomes a node, the inputs
        ``data`` (``data0``, ``data1``, ... for several) and the
        parameters, under their structural names, its variables. An op
        that is not registered, or an array that is neither an input, a
        parameter nor an op's output (a constant made inside the
        forward), raises ``ValueError``."""
        from ..symbol.symbol import Symbol, _Node, _name_manager, \
            _optional_inputs

        spec = getattr(self, "_last_input_spec", None)
        if not spec:
            raise RuntimeError(
                "export() needs a recorded input signature; run one "
                "forward pass first")
        dev = next((p.device for p in self.parameters()
                    if p.device.type != "meta"), torch.device("cpu"))
        ins = [torch.zeros(s, dtype=dt, device=dev) for s, dt in spec]
        id2entry = {}
        for i, x in enumerate(ins):
            id2entry[id(x)] = (_Node(None, _export_input_name(i, len(ins)),
                                     {}, []), 0)
        for pname, p in self.named_parameters():
            id2entry[id(p)] = (_Node(None, pname, {}, []), 0)

        rec = _registry.GraphRecorder()
        _registry._recorders.append(rec)
        try:
            with autograd.pause(train_mode=False):
                out = self.forward(*ins)
        finally:
            _registry._recorders.pop()

        for opname, kwargs, in_list, out_list in rec.entries:
            if opname == "__alias__":
                if id(in_list[0]) in id2entry:
                    id2entry[id(out_list[0])] = id2entry[id(in_list[0])]
                continue
            opdef = _registry.get(_INVOKE_ALIASES.get(opname, opname))
            if opdef is None:
                raise ValueError(
                    f"export: op {opname!r} is not a registered op; this "
                    "forward cannot be exported to symbol json")
            extra = kwargs.get("__tensor_params__", ())
            attrs = {k: _sanitize(v) for k, v in kwargs.items()
                     if k not in ("rng", "training", "__tensor_params__")
                     and v is not None}
            implied = _optional_inputs(opdef.name, attrs)
            extra = tuple(n for n in extra if n not in implied)
            if extra:
                attrs["__extra_inputs__"] = extra
            parents = []
            for x in in_list:
                if id(x) not in id2entry:
                    raise ValueError(
                        f"export: op {opname!r} consumes an array that is "
                        "neither an input, a parameter, nor a recorded op "
                        "output (constant captured inside forward)")
                parents.append(id2entry[id(x)])
            node = _Node(opdef.name, _name_manager.get(opdef.name.lower()),
                         attrs, parents, num_outputs=len(out_list))
            for j, o in enumerate(out_list):
                id2entry[id(o)] = (node, j)

        outs = out if isinstance(out, (tuple, list)) else (out,)
        heads = []
        for o in outs:
            o = _unwrap(o)
            if id(o) not in id2entry:
                raise ValueError("export: an output was not produced by a "
                                 "recorded op")
            heads.append(id2entry[id(o)])
        Symbol(heads).save(f"{path}-symbol.json")
        self.save_parameters(f"{path}-{epoch:04d}.params")
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"

    def export_for_serving(self, path: str, epoch: int = 0,
                           buckets=(1, 2, 4, 8)):
        """:meth:`export` plus ``path-serving.json``: the request
        signature (input names, per-example feature shapes, dtypes) and
        the batch buckets, which ``serving.ModelServer.from_exported``
        reads (reference ``export_for_serving``)."""
        import json

        from ..base import numpy_dtype

        sym_file, params_file = self.export(path, epoch)
        spec = {
            "version": 1,
            "symbol": os.path.basename(sym_file),
            "params": os.path.basename(params_file),
            "buckets": [int(b) for b in buckets],
            "inputs": [
                {"name": _export_input_name(i, len(self._last_input_spec)),
                 "features": [int(d) for d in shape[1:]],
                 "dtype": str(numpy_dtype(dtype) or
                              str(dtype).replace("torch.", ""))}
                for i, (shape, dtype) in enumerate(self._last_input_spec)],
        }
        spec_file = f"{path}-serving.json"
        with open(spec_file, "w") as f:
            json.dump(spec, f, indent=1)
        return spec_file


def _export_input_name(i: int, n: int) -> str:
    """Input names shared by ``export`` and ``export_for_serving``."""
    return "data" if n == 1 else f"data{i}"


#: invoke names of NDArray methods -> the registered op they are
#: (operands already in the op's order), as the reference's export maps
_INVOKE_ALIASES = {
    "add": "elemwise_add", "sub": "elemwise_sub", "rsub": "elemwise_sub",
    "mul": "elemwise_mul", "div": "elemwise_div", "rdiv": "elemwise_div",
    "rmod": "broadcast_mod", "pow": "broadcast_power",
    "rpow": "broadcast_power", "neg": "negative", "eq": "broadcast_equal",
    "ne": "broadcast_not_equal", "gt": "broadcast_greater",
    "ge": "broadcast_greater_equal", "lt": "broadcast_lesser",
    "le": "broadcast_lesser_equal", "sdpa": "scaled_dot_product_attention"}


def _sanitize(v):
    """An attribute as the json keeps it (dtypes by name)."""
    import numbers

    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    if isinstance(v, (tuple, list)):
        return tuple(_sanitize(x) for x in v)
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    try:
        import numpy as np

        return np.dtype(v).name
    except Exception:
        raise ValueError(f"export: op attribute {v!r} is not serializable")


class SymbolBlock(HybridBlock):
    """A symbol graph as a block (reference ``SymbolBlock``). The graph's
    free variables that are not ``inputs`` become this block's
    parameters, under their own names; auxiliary states (BatchNorm's
    running statistics) have ``grad_req="null"``. A shape left unknown is
    filled from the first call's inputs by ``infer_shape_partial``. The
    forward evaluates the graph with the port's registered ops
    (``executor._interpret``), so torch differentiates it as any forward,
    and in training writes the new auxiliary states back."""

    def __init__(self, outputs, inputs, params=None, prefix=None):
        super().__init__(prefix=prefix, params=params)
        from ..symbol.symbol import Group, Symbol

        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._sym_outputs = outputs
        self._input_names = [
            s.name if isinstance(s, Symbol) else str(s) for s in ins]
        arg_names = outputs.list_arguments()
        self._sym_arg_names = [n for n in arg_names
                               if n not in self._input_names]
        self._sym_aux_names = list(outputs.list_auxiliary_states())
        shapes = {n.name: n.attrs.get("__shape__")
                  for n in outputs._topo_nodes() if n.is_variable}
        self._sym_params: Dict[str, Parameter] = {}
        for n in self._sym_arg_names + self._sym_aux_names:
            p = Parameter(n, grad_req="null" if n in self._sym_aux_names
                          else "write", shape=shapes.get(n))
            self._place(n, p)
            self._sym_params[n] = p

    def _place(self, name: str, p: Parameter) -> None:
        """Bind ``p`` at the dotted path ``name`` (children made on the
        way), so the structural name of the parameter is its graph name."""
        mod = self
        *path, leaf = name.split(".")
        for part in path:
            child = mod._modules.get(part)
            if child is None:
                child = _Scope(prefix="")
                mod.add_module(part, child)
            mod = child
        mod._bind_param(leaf, p)

    @staticmethod
    def imports(symbol_file: str, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``export()`` files (reference
        ``SymbolBlock.imports``); the parameters load onto ``ctx``
        (default ``gpu(0)``)."""
        from .. import symbol as sym_mod

        symbol = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(symbol, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            block.load_parameters(param_file, ctx=ctx)
        return block

    def _call(self, *args, **kwargs):
        if any(not p._known() for p in self._sym_params.values()):
            self._fill_shapes(*[_unwrap(a) for a in args])
        return super()._call(*args, **kwargs)

    def _fill_shapes(self, *args) -> None:
        known = {n: tuple(a.shape) for n, a in zip(self._input_names, args)}
        arg_shapes, _, aux_shapes = \
            self._sym_outputs.infer_shape_partial(**known)
        names = self._sym_outputs.list_arguments() + \
            self._sym_outputs.list_auxiliary_states()
        for n, s in zip(names, list(arg_shapes) + list(aux_shapes)):
            p = self._sym_params.get(n)
            if p is not None and not p._known() and s is not None:
                p._finish_deferred_init(tuple(s))
        for mod in self.modules():
            if isinstance(mod, Block):
                mod._shapes_pending = False

    def forward(self, *args):
        from ..executor import _interpret

        if len(args) != len(self._input_names):
            raise ValueError(
                f"SymbolBlock expects {len(self._input_names)} inputs "
                f"{self._input_names}, got {len(args)}")
        feeds = dict(zip(self._input_names, args))
        for n in self._sym_arg_names:
            feeds[n] = self._sym_params[n]._var
        aux = {n: self._sym_params[n]._var for n in self._sym_aux_names}
        training = autograd.is_training()
        outs, new_aux = _interpret(self._sym_outputs, feeds, aux, training)
        if training:
            with torch.no_grad():
                for n in self._sym_aux_names:
                    if new_aux[n] is not aux[n]:
                        aux[n].copy_(new_aux[n])
        return outs[0] if len(outs) == 1 else tuple(outs)


class _Scope(Block):
    """A node of a SymbolBlock's parameter paths (no forward)."""
