"""Gluon Parameter, Constant and ParameterDict.

Counterpart of the JAX package's ``gluon/parameter.py`` (reference
``python/mxnet/gluon/parameter.py``). A :class:`Parameter` is a named
handle on one ``torch.nn.Parameter``: the tensor a module slot holds
(``Block._parameters[leaf]``), which is what the layers compute with and
what torch's autograd fills. The handle owns that tensor and knows every
slot that holds it (a parameter shared through ``params=`` sits in the
slots of both blocks), so a replacement (``initialize`` on a new device,
a deferred shape filled in, ``Block.set_param``) reaches every holder.

Attributes that the trainers and the step engines read off the tensor
(``grad_req``, ``lr_mult``, ``wd_mult``, ``init``) live on it, so the
handle and the tensor agree whatever path reads them. ``grad()`` returns
the tensor's ``.grad`` as an NDArray (a row-sparse one for the coalesced
sparse COO gradient of ``Embedding(sparse_grad=True)``), and ``zero_grad``
writes zeros, as MXNet does, rather than dropping the gradient as torch's
``set_to_none`` would.

A dimension of 0 (or a shape of None) is unknown until the first forward,
as in the reference: ``initialize`` then places a tensor with no elements
on the device and records the initializer, and the block's first call
draws it in place (``Block._finish_deferred``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import List, Optional

import numpy as np
import torch

from .. import initializer as _init
from ..device import resolve
from ..ndarray.ndarray import NDArray

__all__ = ["Constant", "DeferredInitializationError", "Parameter",
           "ParameterDict"]


class DeferredInitializationError(RuntimeError):
    """A parameter's shape or value is not known yet (reference
    ``gluon.parameter.DeferredInitializationError``)."""


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return dt


class Parameter:
    """A named parameter (reference ``gluon.Parameter``)."""

    def __init__(self, name: str = "param", grad_req: str = "write",
                 shape=None, dtype="float32", init=None,
                 allow_deferred_init: bool = True,
                 differentiable: bool = True, lr_mult: float = 1.0,
                 wd_mult: float = 1.0, stype: str = "default",
                 grad_stype: str = "default"):
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"grad_req {grad_req!r}: 'write', 'add' or "
                             "'null'")
        if stype not in ("default", "row_sparse", "csr"):
            raise ValueError(f"invalid stype {stype!r}")
        if grad_stype not in ("default", "row_sparse"):
            raise ValueError(f"invalid grad_stype {grad_stype!r}")
        self.name = name
        self.allow_deferred_init = allow_deferred_init
        self._stype = stype
        self._grad_stype = grad_stype
        self._owners: list = []          # (module, leaf) slots holding it
        self._shape = None if shape is None else tuple(int(s) for s in shape)
        req = grad_req if differentiable else "null"
        self._var = torch.nn.Parameter(
            torch.empty(self._placeholder(), device="meta",
                        dtype=_dtype(dtype)), requires_grad=req != "null")
        self._var.grad_req = req
        self._var.lr_mult = lr_mult
        self._var.wd_mult = wd_mult
        self._var.init = init

    @classmethod
    def _adopt(cls, name: str, var: torch.nn.Parameter) -> "Parameter":
        """A handle on a tensor a module registered directly."""
        p = cls.__new__(cls)
        p.name = name
        p.allow_deferred_init = True
        p._stype = p._grad_stype = "default"
        p._owners = []
        p._shape = tuple(var.shape)
        p._var = var
        if not hasattr(var, "grad_req"):
            var.grad_req = "write" if var.requires_grad else "null"
        return p

    def _placeholder(self):
        if self._shape is None:
            return (0,)
        return self._shape

    # -- the tensor -----------------------------------------------------------
    def _set_var(self, new: torch.nn.Parameter) -> None:
        """Put ``new`` in place of the tensor, in every slot holding it,
        with the old one's attributes."""
        new.__dict__.update(self._var.__dict__)  # grad_req, lr_mult, ...
        new.__dict__.pop("_mx_init", None)      # a value: no deferred draw
        new.__dict__.pop("_mx_name", None)
        self._var = new
        for mod, leaf in self._owners:
            mod._parameters[leaf] = new

    def _bind(self, module, leaf: str) -> None:
        if (module, leaf) not in [(m, lf) for m, lf in self._owners]:
            self._owners.append((module, leaf))

    def _known(self) -> bool:
        return self._var.device.type != "meta" and 0 not in self._var.shape

    # -- attributes -----------------------------------------------------------
    @property
    def shape(self):
        if self._known() or self._shape is None:
            return tuple(self._var.shape) if self._known() else None
        return self._shape

    @shape.setter
    def shape(self, new):
        new = tuple(int(s) for s in new)
        if self._known():
            if new != tuple(self._var.shape):
                raise ValueError(f"parameter {self.name}: cannot change the "
                                 f"shape {tuple(self._var.shape)} to {new}")
            return
        old = self._shape
        if old is not None and len(old) == len(new):
            new = tuple(n if o in (0, None) or o < 0 else o
                        for o, n in zip(old, new))
        self._shape = new

    @property
    def dtype(self):
        return self._var.dtype

    @property
    def grad_req(self) -> str:
        return self._var.grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req {req!r}: 'write', 'add' or 'null'")
        self._var.grad_req = req
        self._var.requires_grad_(req != "null")
        if req == "null":
            self._var.grad = None

    @property
    def grad_stype(self) -> str:
        return self._grad_stype

    def _tensor_attr(name):      # noqa: N805  (a property factory)
        def get(self):
            return getattr(self._var, name, None)

        def put(self, value):
            setattr(self._var, name, value)

        return property(get, put)

    lr_mult = _tensor_attr("lr_mult")
    wd_mult = _tensor_attr("wd_mult")
    init = _tensor_attr("init")
    del _tensor_attr

    # -- initialization -------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False, _name: Optional[str] = None):
        """Draw the value on ``ctx`` (default ``gpu(0)``) with ``init``,
        else the parameter's own initializer, else ``default_init`` (None:
        ``Uniform(0.07)``). Drawn once: a second call does nothing unless
        ``force_reinit``. With the shape unknown, the draw waits for the
        first forward (the tensor placed on ``ctx`` has no elements)."""
        if self._known() and not force_reinit:
            return
        dev = resolve(ctx)
        initer = _init.create(init if init is not None else
                              self.init if self.init is not None else
                              default_init)
        shape = self.shape
        name = _name or self.name
        if shape is None or 0 in shape:
            if not self.allow_deferred_init:
                raise ValueError(f"parameter {self.name} has unknown shape "
                                 f"{shape} and deferred init is disallowed")
            self._set_var(torch.nn.Parameter(
                torch.empty(self._placeholder(), device=dev,
                            dtype=self.dtype),
                requires_grad=self._var.requires_grad))
            self._var._mx_init = initer
            self._var._mx_name = name
            return
        arr = initer(name, shape)
        self._set_var(torch.nn.Parameter(
            torch.from_numpy(arr).to(device=dev, dtype=self.dtype),
            requires_grad=self._var.requires_grad))

    def _finish_deferred_init(self, shape=None) -> None:
        """Draw a parameter whose shape waited for the first forward, in
        place (the same tensor object, so a trainer made before keeps
        it)."""
        if shape is not None:
            self.shape = shape
        initer = getattr(self._var, "_mx_init", None)
        if initer is None:
            raise DeferredInitializationError(
                f"parameter {self.name} was not initialized; call "
                ".initialize() before the first forward")
        shape = self.shape
        if shape is None or 0 in shape:
            raise DeferredInitializationError(
                f"parameter {self.name}: shape {shape} is still unknown")
        arr = initer(self._var._mx_name, shape)
        self._var.data = torch.from_numpy(arr).to(device=self._var.device,
                                                  dtype=self.dtype)
        del self._var._mx_init, self._var._mx_name

    # -- access ---------------------------------------------------------------
    def _check(self) -> torch.nn.Parameter:
        v = self._var
        if v.device.type == "meta":
            raise RuntimeError(f"parameter {self.name} not initialized; "
                               "call .initialize()")
        if 0 in v.shape:
            raise DeferredInitializationError(
                f"parameter {self.name} waits for its shape: deferred "
                "init completes in the first forward")
        return v

    def data(self, ctx=None) -> NDArray:
        """The value, as an NDArray over the parameter's own tensor."""
        return NDArray(self._check())

    def list_data(self) -> List[NDArray]:
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient (zeros before the first backward), as an NDArray
        over ``.grad``; a row-sparse gradient as a ``RowSparseNDArray``."""
        v = self._check()
        if self.grad_req == "null":
            raise RuntimeError(f"parameter {self.name} has no gradient "
                               "(grad_req='null')")
        if v.grad is None:
            v.grad = torch.zeros_like(v)
        if v.grad.is_sparse:
            from ..ndarray.sparse import RowSparseNDArray

            return RowSparseNDArray.from_torch(v.grad.coalesce())
        return NDArray(v.grad)

    def list_grad(self) -> list:
        return [self.grad()]

    def list_ctx(self) -> list:
        from ..ndarray.ndarray import _context_of

        v = self._var
        return [] if v.device.type == "meta" else [_context_of(v)]

    def zero_grad(self) -> None:
        """Zeros into the gradient (an empty row set for a row-sparse
        one)."""
        v = self._var
        if v.device.type == "meta" or self.grad_req == "null":
            return
        if v.grad is not None and v.grad.is_sparse:
            v.grad = torch.sparse_coo_tensor(
                torch.zeros((1, 0), dtype=torch.int64, device=v.device),
                torch.zeros((0,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=v.device), tuple(v.shape)).coalesce()
        elif v.grad is not None:
            v.grad.zero_()
        else:
            v.grad = torch.zeros_like(v)

    def set_data(self, data) -> None:
        """Copy ``data`` into the parameter (its own tensor, in place once
        drawn; the first value of one not drawn yet)."""
        src = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(np.array(data) if not isinstance(
                data, torch.Tensor) else data)
        src = src.detach()
        shape = self.shape
        if shape is not None and 0 not in shape \
                and tuple(src.shape) != tuple(shape):
            raise ValueError(f"cannot set data of parameter {self.name}: "
                             f"expected shape {shape}, got "
                             f"{tuple(src.shape)}")
        v = self._var
        if v.device.type == "meta":
            self._set_var(torch.nn.Parameter(
                src.to(dtype=v.dtype).clone(), requires_grad=v.requires_grad))
            return
        if 0 in v.shape:
            v.data = src.to(device=v.device, dtype=v.dtype).clone()
            v.__dict__.pop("_mx_init", None)
            v.__dict__.pop("_mx_name", None)
            return
        with torch.no_grad():
            v.copy_(src)

    def cast(self, dtype) -> None:
        """Cast in place (the same tensor object); the gradient goes."""
        v = self._var
        v.data = v.data.to(_dtype(dtype))
        v.grad = None

    def reset_ctx(self, ctx) -> None:
        """Move to ``ctx`` in place (the same tensor object)."""
        v = self._var
        if v.device.type == "meta":
            return
        v.data = v.data.to(resolve(ctx))
        if v.grad is not None:
            v.grad = v.grad.to(v.device)

    def var(self):
        """The symbol variable of this parameter (reference
        ``Parameter.var``)."""
        from ..symbol import var

        return var(self.name, shape=self.shape,
                   dtype=str(self.dtype).replace("torch.", ""))

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={str(self.dtype).replace('torch.', '')})")


class Constant(Parameter):
    """A parameter that holds a fixed value and takes no gradient
    (reference ``gluon.Constant``)."""

    def __init__(self, name, value):
        value = value._data if isinstance(value, NDArray) else \
            torch.as_tensor(np.array(value) if not isinstance(
                value, torch.Tensor) else value)
        super().__init__(name=name, grad_req="null",
                         shape=tuple(value.shape), dtype=value.dtype,
                         differentiable=False)
        self._value = value.detach().clone()
        self.init = "zeros"

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False, _name=None):
        if self._known() and not force_reinit:
            return
        self._set_var(torch.nn.Parameter(
            self._value.to(resolve(ctx)), requires_grad=False))


class ParameterDict(Mapping):
    """Ordered name -> :class:`Parameter` mapping with MXNet's sharing
    (reference ``gluon.ParameterDict``). ``get(name)`` declares
    ``prefix + name``, or returns the one declared, here or in the dict
    this one shares."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self.prefix = prefix
        self._params: "dict[str, Parameter]" = {}
        self._shared = shared

    def get(self, name: str, **kwargs) -> Parameter:
        full = self.prefix + name
        if full in self._params:
            p = self._params[full]
        elif self._shared is not None and full in self._shared._params:
            p = self._params[full] = self._shared._params[full]
        else:
            p = self._params[full] = Parameter(name=full, **kwargs)
            return p
        shape = kwargs.get("shape")
        if shape is not None:
            p.shape = shape      # fills unknown dims; a clash raises
        return p

    def update(self, other: "ParameterDict") -> None:
        self._params.update(other._params)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit: bool = False) -> None:
        for p in self._params.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for p in self._params.values():
            p.zero_grad()

    def setattr(self, name: str, value) -> None:
        """Set attribute ``name`` of every parameter (``grad_req``,
        ``lr_mult``, ...)."""
        for p in self._params.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx) -> None:
        for p in self._params.values():
            p.reset_ctx(ctx)

    def save(self, fname: str, strip_prefix: str = "") -> None:
        """``mx.nd.save`` of every drawn parameter under its name, less
        ``strip_prefix`` where it starts with it."""
        from ..ndarray import ndarray as _nd

        arg = {}
        for name, p in self._params.items():
            if not p._known():
                continue
            key = name[len(strip_prefix):] if strip_prefix and \
                name.startswith(strip_prefix) else name
            arg[key] = NDArray(p._var.detach())
        _nd.save(fname, arg)

    def load(self, fname: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = "") -> None:
        """Load a :meth:`save` file, each name with ``restore_prefix``
        put in front. A parameter not drawn yet is placed on ``ctx``
        (default ``gpu(0)``)."""
        from ..device import cpu
        from ..ndarray import ndarray as _nd

        loaded = {restore_prefix + k: v for k, v in
                  _nd.load(fname, ctx=cpu()).items()}
        for name, p in self._params.items():
            if name in loaded:
                v = loaded[name]._data
                if p._var.device.type == "meta":
                    p._set_var(torch.nn.Parameter(
                        v.to(device=resolve(ctx), dtype=p.dtype),
                        requires_grad=p._var.requires_grad))
                else:
                    p.set_data(v.to(p._var.device))
            elif not allow_missing:
                raise KeyError(f"parameter {name} missing from {fname}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise KeyError(f"file {fname} has extra parameters "
                               f"{sorted(extra)[:8]}")

    # -- mapping --------------------------------------------------------------
    def __getitem__(self, name: str) -> Parameter:
        return self._params[name]

    def __iter__(self):
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)

    def __contains__(self, name) -> bool:
        return name in self._params

    def __repr__(self):
        lines = [f"ParameterDict (prefix={self.prefix!r})"]
        lines += [f"  {p!r}" for p in self._params.values()]
        return "\n".join(lines)
