"""Block: the port's base layer.

Counterpart of the JAX package's ``gluon/block.py`` on ``torch.nn.Module``.
Parameter names are the module attribute paths (``layer0.attn.qkv.weight``),
which equal the JAX package's structural names, so weights carry across by
name.

Parameters are declared on the ``meta`` device (shape only, no memory) and
materialize on a real device in :meth:`Block.initialize` or when weights are
loaded, the way MXNet defers initialization. A dimension declared 0 (a
``Dense`` without ``in_units``, a conv without ``in_channels``) is unknown
until the block's first forward: ``initialize`` then records the
initializer and places a parameter with no elements on the device, and the
first call runs the block's :meth:`Block.infer_shape` on its input and
draws the parameter in place (the same ``Parameter`` object, so a trainer
made before that trains it), as the JAX package's ``Parameter``
(``gluon/parameter.py:93``). Whether a layer trains
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


class DeferredInitializationError(RuntimeError):
    """A parameter's shape or value is not known yet (reference
    ``gluon.parameter.DeferredInitializationError``)."""


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
        # a parameter of this block waits for its shape (a dim declared 0)
        self._shapes_pending = False

    def _declare(self, name: str, shape, grad_req: str = "write",
                 init=None, dtype="float32") -> None:
        """Declare a parameter ``name`` of ``shape`` and ``dtype``
        (uninitialized, on the meta device). A dim of 0 is unknown until
        the first forward (:meth:`infer_shape`). ``grad_req="null"``
        declares state that no gradient reaches (BatchNorm running
        statistics): the parameter has ``requires_grad=False``, as a JAX
        ``params.get(..., grad_req="null")``, and trainers leave it out of
        their updates. ``init`` (an initializer or its name) is the
        parameter's own, which :meth:`initialize` prefers to its global
        one, as ``params.get(..., init=...)`` in the JAX package."""
        if grad_req not in ("write", "null"):
            raise ValueError(f"grad_req {grad_req!r}: 'write' or 'null'")
        shape = tuple(int(s) for s in shape)
        p = torch.nn.Parameter(
            torch.empty(shape, device="meta", dtype=_dtype(dtype)),
            requires_grad=grad_req == "write")
        if grad_req == "null":
            p.grad_req = "null"
        if init is not None:
            p.init = init
        self.register_parameter(name, p)
        if 0 in shape:
            self._shapes_pending = True

    def infer_shape(self, *args) -> dict:
        """The full shapes of this block's parameters declared with a dim
        of 0, from the inputs of its first forward: ``{name: shape}``.
        Layers with such parameters override it."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer its parameter shapes; "
            "pass in_units/in_channels")

    def _finish_deferred(self, *args) -> None:
        """Before the first forward: fill the unknown dims from the input
        and draw those parameters with the initializer ``initialize``
        recorded, in place."""
        pending = [n for n, p in self._parameters.items()
                   if p is not None and 0 in p.shape]
        for n in pending:
            if getattr(self._parameters[n], "_mx_init", None) is None:
                raise DeferredInitializationError(
                    f"parameter {n} of {type(self).__name__} was not "
                    "initialized; call .initialize() before the first "
                    "forward")
        if pending:
            shapes = self.infer_shape(*args)
            for n in pending:
                p = self._parameters[n]
                arr = p._mx_init(n, shapes[n])
                p.data = torch.from_numpy(arr).to(device=p.device,
                                                  dtype=p.dtype)
                del p._mx_init
        self._shapes_pending = False

    def __call__(self, *args, **kwargs):
        on_nd = any(isinstance(a, NDArray) for a in args)
        if on_nd:
            args = [a._data if isinstance(a, NDArray) else a for a in args]
        if self._shapes_pending:
            self._finish_deferred(*args)
        if not on_nd:
            return super().__call__(*args, **kwargs)
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
        new.__dict__.pop("_mx_init", None)   # a value, no deferred draw
        mod._parameters[leaf] = new

    def initialize(self, init=None, ctx: Optional[Context] = None):
        """Draw every parameter on ``ctx`` (default ``gpu(0)``) in its
        dtype with its own initializer (``_declare``'s ``init``) if it has
        one, else with ``init`` (an initializer or its name; None is
        ``"uniform"``, ``Uniform(0.07)``, as in MXNet); returns ``self``.
        A parameter whose shape waits for the first forward gets no
        elements on ``ctx`` now and is drawn by that forward (values drawn
        in fp32, then cast, as the reference)."""
        dev = resolve(ctx)
        default = _init.create(init)
        for name, p in list(self.named_parameters()):
            own = getattr(p, "init", None)
            initer = default if own is None else _init.create(own)
            if 0 in p.shape:
                self.set_param(name, torch.empty(p.shape, device=dev,
                                                 dtype=p.dtype))
                self.get_parameter(name)._mx_init = initer
                continue
            arr = initer(name, p.shape)
            self.set_param(name, torch.from_numpy(arr).to(device=dev,
                                                          dtype=p.dtype))
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
                raise ValueError(f"parameter {name}: declared shape "
                                 f"{tuple(p.shape)} does not match saved "
                                 f"shape {tuple(v.shape)}")
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

    @property
    def device(self) -> torch.device:
        """Device of the parameters (``meta`` before initialization)."""
        return next(self.parameters()).device
