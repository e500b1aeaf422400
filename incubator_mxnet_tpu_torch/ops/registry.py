"""Operator registry.

Counterpart of the JAX package's ``ops/registry.py`` (the reference's nnvm
op registry, ``NNVM_REGISTER_OP``). An op is a function over torch
tensors. Torch infers shapes and types and differentiates every op, so the
registry's jobs are the name -> op lookup that generates the ``mx.nd.*``
surface, per-op metadata (docs, whether the op is differentiable, whether
it draws random numbers) and ``list_ops``. An op with ``needs_rng`` takes
a keyword ``rng``: the ``torch.Generator`` it draws from, whose device is
the device it draws on (``ndarray.invoke`` passes the operands' device's,
or the context's).

Graph recording (reference ``ndarray.GraphRecorder``): while a
:class:`GraphRecorder` is active (``HybridBlock.export`` runs one forward
under one), each call of a registered op records one entry: the op's
name, its attributes (the arguments that are not tensors, by parameter
name), its input tensors and its output tensors. The port's layers call
the op functions on tensors directly, so the record is taken here, where
every such call passes, and not only in ``ndarray.invoke``. A registered
op called inside another one's recorded call is part of that op and is
not recorded again. With no recorder active an op call costs one check.

AMP (``amp.init``): the cast policy sits here too, for the same reason:
while one is set, the outermost call of a registered op casts its
floating tensor arguments by the op's name (:func:`amp_call`); a
registered op that another calls inside its own body runs as called, as
the JAX package's ``invoke`` applies its policy once per op. The casts
are tensor ops that autograd records, so gradients come back in each
argument's own type. With no policy set an op call costs one more check.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable[..., Any]          # (*tensors, **kwargs) -> tensor | tuple
    differentiable: bool = True
    needs_rng: bool = False          # fn takes rng=<torch.Generator>
    aliases: tuple = ()
    doc: str = ""


_OPS: Dict[str, OpDef] = {}


class GraphRecorder:
    """The registered-op calls of one forward, in order: ``entries`` of
    ``(name, attrs, inputs, outputs)``; an entry named ``"__alias__"``
    says its output tensor holds the value of its input tensor (an
    NDArray's own copy of an op's result)."""

    def __init__(self):
        self.entries: List[tuple] = []
        self.depth = 0             # > 0 inside a recorded call

    def alias(self, src, dst) -> None:
        if src is not dst:
            self.entries.append(("__alias__", {}, [src], [dst]))


#: the active recorders (innermost last); empty outside an export
_recorders: List[GraphRecorder] = []

#: the AMP cast policy (``amp.AmpPolicy``: ``apply(name, fn, args,
#: kwargs) -> (args, kwargs)``), or None (``amp.init``/``amp.deinit``)
_amp_policy = None
#: per thread: 1 inside the outermost op call under a policy
_amp_state = threading.local()


def _is_tensor(x) -> bool:
    import torch

    return isinstance(x, torch.Tensor)


def _split_args(fn, args, kwargs):
    """(input tensors, attributes by parameter name, names of the
    optional parameters that got a tensor) of one call of ``fn``."""
    sig = _signature(fn)
    try:
        bound = sig.bind(*args, **kwargs)
    except (TypeError, AttributeError):   # a builtin has no signature
        return ([a for a in args if _is_tensor(a)],
                {k: v for k, v in kwargs.items() if not _is_tensor(v)}, [])
    inputs, attrs, optional = [], {}, []
    for pname, val in bound.arguments.items():
        kind = sig.parameters[pname].kind
        if kind is inspect.Parameter.VAR_POSITIONAL:
            inputs.extend(v for v in val if _is_tensor(v))
        elif kind is inspect.Parameter.VAR_KEYWORD:
            attrs.update(val)
        elif _is_tensor(val):
            inputs.append(val)
            if sig.parameters[pname].default is not inspect.Parameter.empty:
                optional.append(pname)
        elif isinstance(val, (list, tuple)) and val and \
                all(_is_tensor(v) for v in val):
            inputs.extend(val)
        else:
            attrs[pname] = val
    return inputs, attrs, optional


@functools.lru_cache(maxsize=None)
def _signature(fn):
    try:
        return inspect.signature(fn)
    except ValueError:
        return None


def record_call(name: str, fn: Callable, args, kwargs, inputs=None,
                attrs=None):
    """Call ``fn(*args, **kwargs)`` and record it as op ``name`` in the
    innermost recorder (once: the calls it makes are not recorded).
    ``inputs``/``attrs`` default to the tensors and the other arguments
    of the call."""
    rec = _recorders[-1]
    if rec.depth:
        return fn(*args, **kwargs)
    rec.depth += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        rec.depth -= 1
    optional = []
    if inputs is None:
        inputs, found, optional = _split_args(fn, args, kwargs)
        attrs = found if attrs is None else attrs
    attrs = dict(attrs or {})
    if optional:
        attrs["__tensor_params__"] = tuple(optional)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    rec.entries.append((name, attrs, list(inputs), outs))
    return out


def alias(src, dst) -> None:
    """Tell the active recorder that tensor ``dst`` holds ``src``'s
    value (an op result made contiguous or copied for its NDArray)."""
    if _recorders and src is not dst:
        _recorders[-1].alias(src, dst)


def recorded(name: str) -> Callable:
    """Record the calls of a function that is not a registered op as op
    ``name`` (the reference's ``invoke(fn, name=...)``): an export of a
    forward that calls it raises, as the reference's does."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _recorders:
                return record_call(name, fn, args, kwargs)
            return fn(*args, **kwargs)

        return call

    return deco


def _call(name: str, fn: Callable, args, kwargs):
    if _recorders:
        return record_call(name, fn, args, kwargs)
    return fn(*args, **kwargs)


def amp_call(name: str, fn: Callable, args, kwargs, record: bool = True):
    """Call op ``name`` under the AMP policy: the outermost call casts its
    arguments (``_amp_policy.apply``) and runs with the policy held off
    for the ops it calls; a nested call runs as called. ``record``: record
    it as a registered op is recorded (``_call``)."""
    run = _call if record else (lambda _n, f, a, k: f(*a, **k))
    policy = _amp_policy
    if policy is None or getattr(_amp_state, "depth", 0):
        return run(name, fn, args, kwargs)
    args, kwargs = policy.apply(name, fn, args, kwargs)
    _amp_state.depth = 1
    try:
        return run(name, fn, args, kwargs)
    finally:
        _amp_state.depth = 0


def register(name: str, *, differentiable: bool = True,
             needs_rng: bool = False, aliases: tuple = ()) -> Callable:
    """Register a function over torch tensors as a framework op. The
    name is bound to the op's function, which records its calls while a
    :class:`GraphRecorder` is active and applies the AMP policy while one
    is set."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if _amp_policy is not None:
                return amp_call(name, fn, args, kwargs)
            if _recorders:
                return record_call(name, fn, args, kwargs)
            return fn(*args, **kwargs)

        op._mx_op = name
        opdef = OpDef(name=name, fn=op, differentiable=differentiable,
                      needs_rng=needs_rng, aliases=aliases,
                      doc=fn.__doc__ or "")
        _OPS[name] = opdef
        for a in aliases:
            _OPS[a] = opdef
        return op

    return deco


def get(name: str) -> Optional[OpDef]:
    return _OPS.get(name)


def list_ops():
    """All registered canonical op names."""
    return sorted({od.name for od in _OPS.values()})
