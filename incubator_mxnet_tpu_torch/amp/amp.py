"""AMP core: the cast policy, its switches and dynamic loss scaling.

Counterpart of the JAX package's ``amp/amp.py`` (reference
``python/mxnet/amp/amp.py``): ``init()`` sets a mixed-precision cast
policy over the ops, ``init_trainer`` and ``scale_loss`` add dynamic loss
scaling with an update skipped on overflow, ``convert_model`` casts a
model for low-precision inference. The default target type is bfloat16
(float16 is supported: ``init("float16")``).

Where the policy applies: the JAX package consults it in ``invoke``, by
op name, inside the differentiated function. The port's layers call the
registered ops on tensors, so it applies where every such call passes:
the wrapper that ``ops.registry.register`` builds (by the op's canonical
name, once per outermost call) and ``ndarray.invoke`` for the NDArray
methods' unregistered functions (``"add"``, ``"multiply"``, ...). The
casts are ``Tensor.to`` calls that autograd records, so a gradient comes
back in its parameter's type. The op lists are the reference's
(``lists.py``), not ``torch.autocast``'s, which knows none of these names.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Optional

import torch

from ..base import resolve_dtype
from ..ops import registry as _registry
from . import lists
from .loss_scaler import LossScaler

__all__ = ["AmpPolicy", "convert_model", "deinit", "init", "init_trainer",
           "scale_loss", "unscale"]


def _floats(args, kwargs):
    """The floating tensors among the arguments (one list deep)."""
    out = []
    for a in list(args) + list(kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                out.append(t)
    return out


def _cast(a, dtype):
    """``a`` with its floating tensors (one list deep) cast to ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if a.is_floating_point() else a
    if isinstance(a, (list, tuple)) and any(
            isinstance(t, torch.Tensor) for t in a):
        return type(a)(_cast(t, dtype) for t in a)
    return a


class AmpPolicy:
    """The three op classes of the reference and its conditional fp32
    ops: ``apply(name, fn, args, kwargs)`` gives the arguments of a call
    of op ``name`` (function ``fn``) as the policy casts them."""

    def __init__(self, target_dtype="bfloat16", target_dtype_ops=None,
                 fp32_ops=None, widest_ops=None, conditional_fp32_ops=None):
        self.target_dtype = resolve_dtype(target_dtype)
        self.target_ops = set(target_dtype_ops
                              if target_dtype_ops is not None
                              else lists.TARGET_DTYPE_OPS)
        self.fp32_ops = set(fp32_ops if fp32_ops is not None
                            else lists.FP32_OPS)
        self.widest_ops = set(widest_ops if widest_ops is not None
                              else lists.WIDEST_TYPE_CASTS)
        # reference format: [(op_name, param_name, [values])]: the op runs
        # fp32 only when the named attribute takes one of the values
        self.conditional_fp32 = {}
        for op_name, param_name, values in (
                conditional_fp32_ops if conditional_fp32_ops is not None
                else lists.CONDITIONAL_FP32_OPS):
            self.conditional_fp32.setdefault(op_name, []).append(
                (param_name, {str(v) for v in values}))

    @staticmethod
    def _attr(fn, args, kwargs, param):
        """The value the call gives parameter ``param`` (by keyword, or
        by position through ``fn``'s signature), or None."""
        if param in kwargs:
            return kwargs[param]
        sig = _registry._signature(fn)
        if sig is None:
            return None
        try:
            return sig.bind_partial(*args, **kwargs).arguments.get(param)
        except TypeError:
            return None

    def dtype_of(self, name, fn, args, kwargs) -> Optional[torch.dtype]:
        """The type the call's floating tensors take, or None (as they
        are)."""
        if name in self.target_ops:
            return self.target_dtype
        if name in self.fp32_ops:
            return torch.float32
        for param, values in self.conditional_fp32.get(name, ()):
            if str(self._attr(fn, args, kwargs, param)) in values:
                return torch.float32
        if name in self.widest_ops:
            kinds = {t.dtype for t in _floats(args, kwargs)}
            if len(kinds) > 1:
                return functools.reduce(torch.promote_types, kinds)
        return None

    def apply(self, name, fn, args, kwargs):
        dtype = self.dtype_of(name, fn, args, kwargs)
        if dtype is None:
            return args, kwargs
        return (tuple(_cast(a, dtype) for a in args),
                {k: _cast(v, dtype) for k, v in kwargs.items()})


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None, layout_optimization=False):
    """Enable AMP globally (reference ``amp.init``); returns the policy."""
    policy = AmpPolicy(target_dtype, target_precision_ops, fp32_ops,
                       conditional_fp32_ops=conditional_fp32_ops)
    _registry._amp_policy = policy
    return policy


def deinit():
    """Turn the policy off."""
    _registry._amp_policy = None


def convert_model(net, target_dtype="bfloat16"):
    """Cast a model for low-precision inference (reference
    ``amp.convert_model``). BatchNorm keeps its statistics in fp32 for a
    16-bit input (``ops.nn.batch_norm``)."""
    net.cast(target_dtype)
    return net


def _consume(trainer) -> None:
    """Mark every gradient as used by a step, so that the next step's
    stale-gradient check passes once a backward writes them again."""
    for p in trainer._params:
        g = p.grad
        if g is not None:
            g._mx_consumed_version = g._version


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a ``gluon.Trainer`` (reference
    ``amp.init_trainer``): its step then checks the gradients for an
    overflow, skips the update on one and adapts the scale. Returns the
    scaler."""
    scaler = LossScaler()
    trainer._amp_loss_scaler = scaler
    orig_update = trainer._update

    def _amp_update(ignore_stale_grad=False):
        overflow = scaler.has_overflow(trainer._params)
        scaler.update_scale(overflow)
        if overflow:
            _consume(trainer)
            return
        orig_update(ignore_stale_grad)

    trainer._update = _amp_update
    return scaler


@contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as l: autograd.backward(l)``:
    the loss times the current scale; the trainer divides the gradients
    back through its ``rescale_grad``."""
    scaler: Optional[LossScaler] = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    trainer._scale = 1.0 / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [_scaled(l, scaler.loss_scale) for l in loss]
    else:
        yield _scaled(loss, scaler.loss_scale)


def _scaled(loss, scale):
    """``loss * scale`` on autograd's graph (inside ``record()`` or after
    it, as the reference allows), an NDArray for an NDArray."""
    from ..ndarray import NDArray

    data = loss._data if isinstance(loss, NDArray) else loss
    with torch.enable_grad():
        out = data * scale
    return NDArray(out) if isinstance(loss, NDArray) else out


@torch.no_grad()
def unscale(trainer):
    """Divide the gradients by the loss scale now (to clip them before
    ``step``); the step then rescales by the batch size alone."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad is not None:
            p.grad.mul_(inv)
    trainer._scale = 1.0
