"""Block: the port's base layer.

Counterpart of the JAX package's ``gluon/block.py`` on ``torch.nn.Module``.
Parameter names are the module attribute paths (``layer0.attn.qkv.weight``),
which equal the JAX package's structural names, so weights carry across by
name.

Parameters are declared on the ``meta`` device (shape only, no memory) and
materialize on a real device in :meth:`Block.initialize` or when weights are
loaded, the way MXNet defers initialization. Whether a layer trains
(dropout on) follows ``autograd.is_training()``, as in MXNet, not torch's
per-module ``training`` flag.

A block called on NDArrays returns NDArrays, as the JAX package's blocks
do, and records for autograd only under ``autograd.record()``; called on
tensors it returns tensors.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from .. import autograd
from .. import initializer as _init
from ..device import Context, resolve
from ..ndarray.ndarray import NDArray


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return dt


class Block(torch.nn.Module):
    """``torch.nn.Module`` with MXNet's initialize/collect_params surface."""

    def __init__(self):
        super().__init__()
        self.training = False

    def _declare(self, name: str, shape, grad_req: str = "write",
                 init=None) -> None:
        """Declare a float32 parameter ``name`` of ``shape`` (uninitialized,
        on the meta device). ``grad_req="null"`` declares state that no
        gradient reaches (BatchNorm running statistics): the parameter has
        ``requires_grad=False``, as a JAX ``params.get(...,
        grad_req="null")``, and trainers leave it out of their updates.
        ``init`` (an initializer or its name) is the parameter's own, which
        :meth:`initialize` prefers to its global one, as
        ``params.get(..., init=...)`` in the JAX package."""
        if grad_req not in ("write", "null"):
            raise ValueError(f"grad_req {grad_req!r}: 'write' or 'null'")
        p = torch.nn.Parameter(
            torch.empty(tuple(int(s) for s in shape), device="meta"),
            requires_grad=grad_req == "write")
        if grad_req == "null":
            p.grad_req = "null"
        if init is not None:
            p.init = init
        self.register_parameter(name, p)

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray) for a in args):
            return super().__call__(*args, **kwargs)
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        with torch.set_grad_enabled(autograd.is_recording()):
            out = super().__call__(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(NDArray(o.contiguous()) for o in out)
        return NDArray(out.contiguous())

    def collect_params(self) -> "OrderedDict[str, torch.nn.Parameter]":
        """Parameters by structural name."""
        return OrderedDict(self.named_parameters())

    def set_param(self, name: str, value: torch.Tensor) -> None:
        """Replace parameter ``name`` (dotted path) by ``value``, keeping
        its attributes."""
        owner, _, leaf = name.rpartition(".")
        mod = self.get_submodule(owner) if owner else self
        old = mod._parameters[leaf]
        new = torch.nn.Parameter(value, requires_grad=old.requires_grad)
        new.__dict__.update(old.__dict__)    # grad_req, lr_mult, wd_mult
        mod._parameters[leaf] = new

    def initialize(self, init=None, ctx: Optional[Context] = None):
        """Draw every parameter on ``ctx`` (default ``gpu(0)``) with its
        own initializer (``_declare``'s ``init``) if it has one, else with
        ``init`` (an initializer or its name; None is ``"uniform"``,
        ``Uniform(0.07)``, as in MXNet); returns ``self``."""
        dev = resolve(ctx)
        default = _init.create(init)
        for name, p in list(self.named_parameters()):
            own = getattr(p, "init", None)
            initer = default if own is None else _init.create(own)
            arr = initer(name, p.shape)
            self.set_param(name, torch.from_numpy(arr).to(dev))
        return self

    def cast(self, dtype) -> "Block":
        """Cast every parameter to ``dtype`` (a torch dtype or its name,
        e.g. ``"bfloat16"``) in place, keeping each parameter object, so a
        Trainer made before the cast trains the cast weights (as the JAX
        package's ``Parameter.cast`` does); returns ``self``."""
        dt = _dtype(dtype)
        for p in self.parameters():
            p.data = p.data.to(dt)
            p.grad = None
        return self

    @property
    def device(self) -> torch.device:
        """Device of the parameters (``meta`` before initialization)."""
        return next(self.parameters()).device
