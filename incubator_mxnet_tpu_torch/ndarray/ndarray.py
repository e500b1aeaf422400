"""NDArray: the imperative array handle of ``mx.nd``.

Counterpart of the JAX package's ``ndarray/ndarray.py`` (reference
``include/mxnet/ndarray.h`` + ``python/mxnet/ndarray/ndarray.py``): an
eagerly dispatched array with in-place mutation, device placement,
``wait_to_read``/``asnumpy`` sync points, autograd attachment
(``attach_grad``) and ``save``/``load``.

An ``NDArray`` holds one contiguous torch tensor; its context is the
tensor's device (``gpu(i)`` for ``cuda:i``). Work queues on the card's
stream, so ``wait_to_read``, ``asnumpy`` and ``waitall`` are the sync
points where a device fault surfaces, as at the reference engine's
rethrow. Semantics kept from the JAX package:

* **x32**: float64 becomes float32, int64 int32 and complex128
  complex64, at creation and on every op's result.
* **Views are values**: a ``reshape``, slice or transpose result is a copy.
  Torch's views alias their base, so :func:`invoke` copies any result that
  shares storage with an input: writing through the result never changes
  the base. ``__setitem__`` writes a fresh tensor and rebinds the handle.
* **Scalar ops keep the array's dtype** (``bf16 * 2.0`` stays bf16),
  through the ``_*_scalar`` op family.

Autograd: ``attach_grad`` turns the handle's tensor into a torch leaf that
requires grad; ``autograd.backward`` writes its gradient into the
handle's ``grad`` array with MXNet's ``write``/``add`` semantics. Ops
record only under ``autograd.record()`` (torch's grad mode follows
MXNet's recording flag inside :func:`invoke`).

Sparse storage (``tostype``, ``attach_grad(stype="row_sparse")``) is in
``ndarray/sparse.py``. Graph recording for ``HybridBlock.export`` is the
registry's (``ops.registry.GraphRecorder``): a registered op records its
own call, :func:`invoke` records the ops it names that the registry does
not. Control flow (``contrib``) differentiates through torch's autograd
and needs no capture scope. Not ported: the AMP hook.
"""

from __future__ import annotations

import io
import weakref
from typing import Optional, Sequence, Tuple

import numpy as _np
import torch

from .. import autograd
from ..base import numpy_dtype, resolve_dtype
from ..config import is_naive_engine
from ..device import Context, resolve
from ..ops import registry as _registry
from ..ops.registry import get as get_op
from ..ops.tensor import _index_along, cast, int_division

__all__ = ["NDArray", "arange", "array", "as_nd", "empty", "eye", "full",
           "invoke", "invoke_op", "load", "ones", "ones_like", "save",
           "waitall", "zeros", "zeros_like"]


#: the dtype of a new array when none is given (reference: float32)
DEFAULT_DTYPE = torch.float32


def _narrow_x32(dt: torch.dtype) -> torch.dtype:
    """The JAX package runs x32: 64-bit requests narrow."""
    if dt == torch.float64:
        return DEFAULT_DTYPE
    if dt == torch.int64:
        return torch.int32
    if dt == torch.uint64:
        return torch.uint32
    if dt == torch.complex128:
        return torch.complex64
    return dt


def _context_of(t: torch.Tensor) -> Context:
    if t.device.type == "cuda":
        return Context("gpu", t.device.index or 0)
    return Context("cpu", 0)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device == b.device and a.numel() > 0 and b.numel() > 0
            and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


def _own(out: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """An op's result as an NDArray's tensor: x32-narrowed, contiguous and
    sharing no storage with an input."""
    dt = _narrow_x32(out.dtype)
    if dt != out.dtype:
        out = out.to(dt)
    if any(_shares_storage(out, t) for t in inputs):
        return out.clone(memory_format=torch.contiguous_format)
    return out.contiguous()


def _sync(tensors) -> None:
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Imperative dispatch (the Imperative::Invoke analog)
# ---------------------------------------------------------------------------
def invoke(fn, inputs: Sequence, kwargs: Optional[dict] = None,
           name: str = "", differentiable: bool = True,
           needs_rng: bool = False, ctx: Optional[Context] = None):
    """Run ``fn`` (a function over torch tensors) on NDArray operands and
    wrap its result(s). Torch records the op iff ``autograd.record()`` is
    on and the op is differentiable. An NDArray among ``kwargs`` passes
    its tensor. ``needs_rng`` passes ``rng=``: the package's generator of
    the first operand's device, or of ``ctx`` (the default context if
    None) where there is no operand, so an op with no operand draws on
    that device (reference ``invoke(..., needs_rng=True)``). Inside a CUDA
    graph capture it is the generator the graph registered, so each
    replay draws afresh. Under ``MXTPU_ENGINE_TYPE=naive`` the stream
    synchronizes after the op."""
    in_nd = _operands(inputs, ctx)
    in_data = [x._data for x in in_nd]
    kw = {k: (v._data if isinstance(v, NDArray) else v)
          for k, v in (kwargs or {}).items()}
    if needs_rng and kw.get("rng") is None:
        from .. import random as _random

        kw["rng"] = _random.generator(
            _context_of(in_data[0]) if in_data else ctx)
    recording = autograd.is_recording() and differentiable
    if _registry._amp_policy is not None and name \
            and not hasattr(fn, "_mx_op"):
        # an op that is not registered (the NDArray methods' lambdas:
        # "add", "multiply", ...) takes the AMP policy by its name here;
        # a registered op applies it itself
        fn = _amp_wrapped(name, fn)
    with torch.set_grad_enabled(recording):
        if _registry._recorders and name and not hasattr(fn, "_mx_op"):
            # an op the registry does not record itself (NDArray methods
            # over a lambda: "add", "getitem", ...), as the reference's
            # invoke records it
            out = _registry.record_call(
                name, fn, in_data, kw, inputs=in_data,
                attrs={k: v for k, v in kw.items() if k != "rng"})
        else:
            out = fn(*in_data, **kw)
        single = not isinstance(out, (tuple, list))
        raw = [out] if single else list(out)
        outs = [_own(o, in_data) for o in raw]
    if _registry._recorders:
        for r, o in zip(raw, outs):
            _registry.alias(r, o)
    if recording:
        autograd.mark_recorded(outs)
    if is_naive_engine():
        _sync(outs)
    nds = [NDArray(o) for o in outs]
    return nds[0] if single else tuple(nds)


def _amp_wrapped(name: str, fn):
    """``fn`` under the AMP policy as op ``name`` (not recorded: ``invoke``
    records it)."""
    def call(*args, **kwargs):
        return _registry.amp_call(name, fn, args, kwargs, record=False)

    return call


def _operands(inputs, ctx: Optional[Context] = None) -> list:
    """NDArrays of ``inputs``; anything else goes onto the first
    NDArray's device (``ctx``, or the default context, if there is
    none)."""
    ctx = next((x.ctx for x in inputs if isinstance(x, NDArray)), ctx)
    return [as_nd(x, ctx=ctx) for x in inputs]


def invoke_op(name: str, *inputs, **kwargs):
    """Invoke a registered op by name (the C-API string dispatch analog)."""
    opdef = get_op(name)
    if opdef is None:
        raise ValueError(f"unknown op {name!r}")
    return invoke(opdef.fn, inputs, kwargs, name=opdef.name,
                  differentiable=opdef.differentiable,
                  needs_rng=opdef.needs_rng)


def as_nd(x, ctx: Optional[Context] = None, dtype=None) -> "NDArray":
    if isinstance(x, NDArray):
        return x
    return array(x, ctx=ctx, dtype=dtype)


# ---------------------------------------------------------------------------
# NDArray
# ---------------------------------------------------------------------------
# (method name, reversed) -> registered scalar op (reference _plus_scalar
# family): the scalar is an attribute, so the array keeps its dtype
_SCALAR_OPS = {
    ("add", False): "_plus_scalar", ("add", True): "_plus_scalar",
    ("sub", False): "_minus_scalar", ("rsub", True): "_rminus_scalar",
    ("mul", False): "_mul_scalar", ("mul", True): "_mul_scalar",
    ("div", False): "_div_scalar", ("rdiv", True): "_rdiv_scalar",
    ("mod", False): "_mod_scalar", ("rmod", True): "_rmod_scalar",
    ("pow", False): "_power_scalar", ("rpow", True): "_rpower_scalar",
    ("eq", False): "_equal_scalar", ("ne", False): "_not_equal_scalar",
    ("gt", False): "_greater_scalar", ("ge", False): "_greater_equal_scalar",
    ("lt", False): "_lesser_scalar", ("le", False): "_lesser_equal_scalar",
}


def _remainder(a, b):
    return int_division(torch.remainder, a, b)


class NDArray:
    """An array on one device. ``NDArray(tensor)`` wraps the tensor
    without a copy; use :func:`array` to make one from other data."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray wraps a torch tensor, got "
                            f"{type(data).__name__}; use mx.nd.array")
        self._data = data
        self._grad = None
        self._grad_req = "null"

    # -- basic properties --------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype where numpy has one, else the torch dtype (bf16)."""
        return numpy_dtype(self._data.dtype) or self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ctx(self) -> Context:
        return _context_of(self._data)

    context = ctx
    device = ctx

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def as_torch(self) -> torch.Tensor:
        """The tensor this handle holds (shared, not copied)."""
        return self._data

    # -- sync points -------------------------------------------------------
    def wait_to_read(self) -> None:
        """Block until the work producing this array is done (reference
        ``NDArray::WaitToRead``); a device fault raises here."""
        _sync([self._data])

    wait_to_write = wait_to_read

    def asnumpy(self) -> _np.ndarray:
        """A numpy copy (bf16 comes back as float32: numpy has no bf16)."""
        t = self._data.detach().resolve_conj().resolve_neg()
        if numpy_dtype(t.dtype) is None:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar-sized")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("truth value of multi-element NDArray is "
                             "ambiguous")
        return bool(self.asscalar())

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __repr__(self) -> str:
        return (f"\n{self.asnumpy()}\n<NDArray {self.shape} @{self.ctx} "
                f"{self._data.dtype}>")

    # -- mutation (handle rebinding) ---------------------------------------
    def _rebind(self, other: "NDArray") -> "NDArray":
        """Adopt another NDArray's value (and its place on the tape)."""
        self._data = other._data
        return self

    def _set_data(self, data) -> None:
        """Replace the value by ``data`` in this array's dtype and device,
        off the tape; an attached variable stays a variable."""
        src = data._data if isinstance(data, NDArray) else torch.as_tensor(
            data)
        t = src.detach().to(device=self._data.device, dtype=self._data.dtype)
        if isinstance(data, NDArray) and _shares_storage(t, src):
            t = t.clone()
        self._data = t
        if self._grad is not None:
            self._make_variable()

    def _write(self, data: "NDArray") -> None:
        """Write ``data`` into this array's own tensor, off the tape (the
        reference's ops that mutate their inputs): whatever else holds
        the tensor, a gluon parameter or a CUDA graph's buffer, sees the
        new value."""
        if tuple(data.shape) != self.shape:
            raise ValueError(f"cannot write {data.shape} into {self.shape}")
        with torch.no_grad():
            self._data.copy_(data._data)

    def _make_variable(self) -> None:
        """Make the tensor a leaf that requires grad and knows its handle
        (cuts any producer edge, as the JAX package's ``attach_grad``)."""
        leaf = self._data.detach().requires_grad_(self._grad_req != "null")
        leaf._mx_owner = weakref.ref(self)
        self._data = leaf

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Allocate a zero gradient buffer and make this array a variable
        (reference ``NDArray.attach_grad``); ``grad_req`` is ``"write"``,
        ``"add"`` or ``"null"``. ``stype="row_sparse"`` makes the buffer an
        empty ``RowSparseNDArray``: ``backward`` stores a row-sparse
        gradient there."""
        if stype not in (None, "default", "row_sparse"):
            raise ValueError(f"grad stype {stype!r}: 'default' or "
                             "'row_sparse'")
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"grad_req {grad_req!r}")
        if stype == "row_sparse":
            from . import sparse

            self._grad = sparse.zeros("row_sparse", self.shape, ctx=self.ctx,
                                      dtype=self._data.dtype)
        else:
            self._grad = NDArray(torch.zeros_like(self._data.detach()))
        self._grad_req = grad_req
        self._make_variable()

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self) -> "NDArray":
        """The same values off the tape (sharing memory, as MXNet's
        ``detach``)."""
        return NDArray(self._data.detach())

    # -- conversion / placement -------------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        """This array in ``dtype``, by ``cast``'s rule: a float into an
        integer type saturates (NaN to 0), as the JAX package's."""
        dt = _narrow_x32(resolve_dtype(dtype))
        if not copy and self._data.dtype == dt:
            return self
        return invoke(lambda x: cast(x, dt), [self], name="astype")

    def copyto(self, other) -> "NDArray":
        """Copy into another NDArray (in place) or onto a Context."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(resolve(other), copy=True))
        if isinstance(other, NDArray):
            other._set_data(self)
            return other
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def to_device(self, ctx):
        return self.as_in_context(ctx)

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    # -- shape ops (copies: views are values) ------------------------------
    def reshape(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        # MXNet magic value 0: copy the input's extent (-1 infers)
        shape = tuple(self.shape[i] if s == 0 else s
                      for i, s in enumerate(shape))
        return invoke_op("reshape", self, shape=shape)

    def reshape_like(self, other: "NDArray") -> "NDArray":
        return self.reshape(other.shape)

    def transpose(self, axes=None) -> "NDArray":
        kw = {} if axes is None else {"axes": tuple(axes)}
        return invoke_op("transpose", self, **kw)

    def swapaxes(self, a: int, b: int) -> "NDArray":
        return invoke_op("swapaxes_op", self, dim1=a, dim2=b)

    def expand_dims(self, axis: int) -> "NDArray":
        return invoke_op("expand_dims", self, axis=axis)

    def squeeze(self, axis=None) -> "NDArray":
        kw = {} if axis is None else {"axis": axis}
        return invoke_op("squeeze", self, **kw)

    def flatten(self) -> "NDArray":
        n = self.shape[0] if self.ndim > 0 else 1
        return self.reshape(n, -1)

    def broadcast_to(self, shape) -> "NDArray":
        return invoke_op("broadcast_to", self, shape=tuple(shape))

    def broadcast_like(self, other: "NDArray") -> "NDArray":
        return self.broadcast_to(other.shape)

    def slice(self, begin, end, step=None) -> "NDArray":
        kw = {"begin": tuple(begin), "end": tuple(end)}
        if step is not None:
            kw["step"] = tuple(step)
        return invoke_op("slice", self, **kw)

    def slice_axis(self, axis: int, begin: int,
                   end: Optional[int]) -> "NDArray":
        return invoke_op("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return invoke_op("take", self, as_nd(indices, ctx=self.ctx), axis=axis,
                   mode=mode)

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key) -> "NDArray":
        key = _convert_index(key)
        return invoke(lambda x: _getitem(x, key), [self], name="getitem")

    def __setitem__(self, key, value) -> None:
        """Write ``value`` at ``key`` into a fresh copy and rebind to it
        (off the tape, as the JAX package's ``.at[].set``)."""
        key = _convert_index(key)
        new = self._data.detach().clone()
        if isinstance(value, NDArray):
            value = value._data.detach()
        value = torch.as_tensor(value, dtype=new.dtype, device=new.device)
        if _negative_steps(key, new.dim()) is None:
            new[key] = value
        else:
            # the flat positions the key selects, in the key's order
            flat = torch.arange(new.numel(), device=new.device)
            at = _getitem(flat.view(new.shape), key)
            new.view(-1)[at.reshape(-1)] = \
                value.broadcast_to(at.shape).reshape(-1)
        self._data = new
        if self._grad is not None:
            self._make_variable()

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, fn, name, reverse=False):
        if isinstance(other, (int, float, bool)):
            scalar_op = _SCALAR_OPS.get((name, bool(reverse)))
            if scalar_op is not None:
                return invoke_op(scalar_op, self, scalar=other)
        o = as_nd(other, ctx=self.ctx)
        a, b = (o, self) if reverse else (self, o)
        return invoke(fn, [a, b], name=name)

    def __add__(self, other):
        return self._binop(other, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, torch.sub, "sub")

    def __rsub__(self, other):
        return self._binop(other, torch.sub, "rsub", reverse=True)

    def __mul__(self, other):
        return self._binop(other, torch.mul, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, torch.true_divide, "div")

    def __rtruediv__(self, other):
        return self._binop(other, torch.true_divide, "rdiv", reverse=True)

    def __mod__(self, other):
        return self._binop(other, _remainder, "mod")

    def __rmod__(self, other):
        return self._binop(other, _remainder, "rmod", reverse=True)

    def __pow__(self, other):
        return self._binop(other, torch.pow, "pow")

    def __rpow__(self, other):
        return self._binop(other, torch.pow, "rpow", reverse=True)

    def __neg__(self):
        return invoke_op("negative", self)

    def __abs__(self):
        return invoke_op("abs", self)

    def __matmul__(self, other):
        return self._binop(other, torch.matmul, "matmul")

    def __iadd__(self, other):
        return self._rebind(self.__add__(other))

    def __isub__(self, other):
        return self._rebind(self.__sub__(other))

    def __imul__(self, other):
        return self._rebind(self.__mul__(other))

    def __itruediv__(self, other):
        return self._rebind(self.__truediv__(other))

    # comparisons (not differentiable): 1 or 0 in the array's dtype
    def _cmp(self, other, name):
        if isinstance(other, (int, float, bool)):
            return invoke_op(_SCALAR_OPS[(name, False)], self, scalar=other)
        return invoke_op({"eq": "equal", "ne": "not_equal", "gt": "greater",
                    "ge": "greater_equal", "lt": "lesser",
                    "le": "lesser_equal"}[name], self,
                   as_nd(other, ctx=self.ctx))

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp(other, "eq")

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp(other, "ne")

    def __gt__(self, other):
        return self._cmp(other, "gt")

    def __ge__(self, other):
        return self._cmp(other, "ge")

    def __lt__(self, other):
        return self._cmp(other, "lt")

    def __le__(self, other):
        return self._cmp(other, "le")

    __hash__ = object.__hash__

    # -- reductions and elementwise methods --------------------------------
    def _reduce(self, name, axis, keepdims, **extra):
        if axis is not None:
            extra["axis"] = axis
        return invoke_op(name, self, keepdims=keepdims, **extra)

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def argmax(self, axis=None):
        return self._reduce("argmax", axis, False)

    def argmin(self, axis=None):
        return self._reduce("argmin", axis, False)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._reduce("norm", axis, keepdims, ord=ord)

    def abs(self):
        return invoke_op("abs", self)

    def clip(self, a_min, a_max):
        return invoke_op("clip", self, a_min=a_min, a_max=a_max)

    def sqrt(self):
        return invoke_op("sqrt", self)

    def square(self):
        return invoke_op("square", self)

    def exp(self):
        return invoke_op("exp", self)

    def log(self):
        return invoke_op("log", self)

    def sigmoid(self):
        return invoke_op("sigmoid", self)

    def tanh(self):
        return invoke_op("tanh", self)

    def relu(self):
        return invoke_op("relu", self)

    def softmax(self, axis=-1):
        return invoke_op("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return invoke_op("log_softmax", self, axis=axis)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return invoke_op("one_hot", self, depth=depth, on_value=on_value,
                   off_value=off_value)

    def tostype(self, stype: str):
        """This array in storage ``stype`` (``sparse.cast_storage``)."""
        from . import sparse

        return sparse.cast_storage(self, stype)

    # numpy-protocol interop
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


def _key_width(part) -> int:
    """The input dims one part of an index key consumes."""
    if part is None:
        return 0
    if isinstance(part, torch.Tensor) and part.dtype == torch.bool:
        return part.dim()
    if isinstance(part, _np.ndarray) and part.dtype == bool:
        return part.ndim
    return 1


def _negative_steps(key, ndim):
    """None if no slice of ``key`` has a negative step; else ``({input
    dim: slice}, key)`` with those slices taken out of the key (each
    replaced by a full slice, which moves no dim)."""
    parts = list(key) if isinstance(key, tuple) else [key]
    if not any(isinstance(p, slice) and p.step is not None and p.step < 0
               for p in parts):
        return None
    ell = [i for i, p in enumerate(parts) if p is Ellipsis]
    if ell:
        fill = ndim - sum(_key_width(p) for p in parts if p is not Ellipsis)
        parts[ell[0]:ell[0] + 1] = [slice(None)] * fill
    steps, rest, dim = {}, [], 0
    for p in parts:
        if isinstance(p, slice) and p.step is not None and p.step < 0:
            steps[dim] = p
            p = slice(None)
        rest.append(p)
        dim += _key_width(p)
    return steps, tuple(rest)


def _getitem(x: torch.Tensor, key) -> torch.Tensor:
    """``x[key]`` with numpy's meaning, negative slice steps included:
    torch refuses those, so each is taken first along its own dim
    (``ops.tensor``'s ``slice`` does the same), the rest of the key
    after."""
    split = _negative_steps(key, x.dim())
    if split is not None:
        steps, key = split
        for dim, s in steps.items():
            x = _index_along(x, dim, s.start, s.stop, s.step)
    return x[key]


def _convert_index(key):
    """NDArray indices inside a key become integer tensors."""
    if isinstance(key, NDArray):
        t = key._data.detach()
        return t.long() if t.is_floating_point() else t
    if isinstance(key, tuple):
        return tuple(_convert_index(k) for k in key)
    return key


# ---------------------------------------------------------------------------
# Creation functions (reference ndarray creation API). ``ctx`` None is the
# default context: gpu(0) unless a ``with mx.cpu():`` block says otherwise.
# ---------------------------------------------------------------------------
def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """A new array holding a copy of ``source`` (an NDArray, tensor,
    numpy array or nested list) on ``ctx``. Without ``dtype`` the source's
    dtype is kept, x32-narrowed (a Python float list is float32, an int
    list int32)."""
    dev = resolve(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        t = torch.from_numpy(_np.array(source))
    dt = _narrow_x32(resolve_dtype(dtype) if dtype is not None else t.dtype)
    return NDArray(t.to(device=dev, dtype=dt, copy=True).contiguous())


def _filled(fill, shape, ctx, dtype) -> NDArray:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dt = _narrow_x32(resolve_dtype(dtype) or DEFAULT_DTYPE)
    return NDArray(torch.full(shape, fill, dtype=dt, device=resolve(ctx)))


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    return _filled(0, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return _filled(1, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return _filled(val, shape, ctx, dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros_like(other: NDArray) -> NDArray:
    return NDArray(torch.zeros_like(other._data.detach()))


def ones_like(other: NDArray) -> NDArray:
    return NDArray(torch.ones_like(other._data.detach()))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    dt = _narrow_x32(resolve_dtype(dtype) or DEFAULT_DTYPE)
    if stop is None:
        start, stop = 0, start
    data = torch.arange(start, stop, step, dtype=dt, device=resolve(ctx))
    if repeat != 1:
        data = torch.repeat_interleave(data, repeat)
    return NDArray(data)


def eye(N, M=None, k=0, ctx=None, dtype=None) -> NDArray:
    dt = _narrow_x32(resolve_dtype(dtype) or DEFAULT_DTYPE)
    dev = resolve(ctx)
    rows = torch.arange(N, device=dev).view(-1, 1)
    cols = torch.arange(N if M is None else M, device=dev).view(1, -1)
    return NDArray((cols - rows == k).to(dt))


def waitall() -> None:
    """Block until all queued work is done (reference ``mx.nd.waitall``):
    a device fault of an earlier op raises here."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# Serialization: the JAX package's container, the ``MXTPU001`` magic and an
# npz body, so a file saved by either package loads in the other.
# ---------------------------------------------------------------------------
_PARAMS_MAGIC = b"MXTPU001"


def save(fname: str, data) -> None:
    """Save an NDArray, list or dict of NDArrays (reference
    ``mx.nd.save``). bf16 arrays are stored as float32."""
    if isinstance(data, NDArray):
        payload = {"__single__": data}
    elif isinstance(data, (list, tuple)):
        payload = {f"__list__{i}": v for i, v in enumerate(data)}
    elif isinstance(data, dict):
        payload = dict(data)
    else:
        raise TypeError("save expects NDArray, list, or dict")
    buf = io.BytesIO()
    _np.savez(buf, **{k: v.asnumpy() if isinstance(v, NDArray)
                      else _np.asarray(v) for k, v in payload.items()})
    with open(fname, "wb") as f:
        f.write(_PARAMS_MAGIC)
        f.write(buf.getvalue())


def load(fname: str, ctx=None):
    """Load ``mx.nd.save`` output (reference ``mx.nd.load``) onto ``ctx``
    (default context: gpu(0)). A raw ``.npz`` file loads too."""
    with open(fname, "rb") as f:
        head = f.read(len(_PARAMS_MAGIC))
        body = f.read()
    if head != _PARAMS_MAGIC:
        body = head + body
    with _np.load(io.BytesIO(body)) as z:
        items = {k: z[k] for k in z.files}
    if set(items) == {"__single__"}:
        return array(items["__single__"], ctx=ctx)
    if items and all(k.startswith("__list__") for k in items):
        return [array(items[f"__list__{i}"], ctx=ctx)
                for i in range(len(items))]
    return {k: array(v, ctx=ctx) for k, v in items.items()}
