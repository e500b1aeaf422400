"""``mx.np``: the numpy-compatible front (the reference's
``python/mxnet/numpy/``).

Counterpart of the JAX package's ``numpy/__init__.py``: a naming front
over the same registry and :func:`~..ndarray.invoke` path as ``mx.nd``
(autograd recording included), with numpy's call signatures where they
take other positional arguments than arrays. Functions return
:class:`~..ndarray.NDArray`. The creators take ``ctx=`` as ``mx.nd.array``
does (the default context, the card, when None); the ``*_like`` creators
take the operand's device. ``promote_types``, ``result_type``,
``can_cast`` and ``issubdtype`` also take the torch dtype that
``NDArray.dtype`` gives for bfloat16, which numpy has none of.

This package is named ``numpy``; it imports the real numpy absolutely.
"""

from __future__ import annotations

import functools as _functools
import math as _math
import sys as _sys

import numpy as _onp
import torch as _torch

from .. import ndarray as _nd
from ..base import numpy_dtype as _numpy_dtype
from ..base import resolve_dtype as _resolve_dtype
from ..device import resolve as _resolve
from ..ndarray import NDArray as ndarray  # numpy-style class alias
from ..ndarray import (array, arange, empty, eye, full, ones, ones_like,
                       zeros, zeros_like)
from ..ndarray.ndarray import _narrow_x32
from ..ops.numpy_ops import spaced as _spaced

_this = _sys.modules[__name__]

# numpy name -> registry/nd name (identity unless stated)
_ALIASES = {
    "add": "elemwise_add", "subtract": "elemwise_sub",
    "multiply": "elemwise_mul", "divide": "elemwise_div",
    "true_divide": "elemwise_div", "power": "broadcast_power",
    "remainder": "broadcast_mod", "mod": "broadcast_mod",
    "absolute": "abs", "concatenate": "concat",
    "amax": "max", "amin": "min", "round": "round",
    "trace": "trace_op", "resize": "resize_op",
    "partition": "partition_op", "swapaxes": "swapaxes",
    "greater": "broadcast_greater", "greater_equal":
        "broadcast_greater_equal", "less": "broadcast_lesser",
    "less_equal": "broadcast_lesser_equal", "equal": "broadcast_equal",
    "not_equal": "broadcast_not_equal",
    "maximum": "broadcast_maximum", "minimum": "broadcast_minimum",
    "hypot": "broadcast_hypot",
    "logical_and": "broadcast_logical_and",
    "logical_or": "broadcast_logical_or",
    "logical_xor": "broadcast_logical_xor",
    "deg2rad": "radians", "rad2deg": "degrees",
}

_PASSTHROUGH = [
    # elementwise
    "abs", "sign", "rint", "ceil", "floor", "trunc", "fix", "square",
    "sqrt", "cbrt", "exp", "exp2", "expm1", "log", "log10", "log2",
    "log1p", "reciprocal", "negative", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
    "arctanh", "degrees", "radians", "clip", "isnan", "isinf", "isfinite",
    "nan_to_num", "sinc", "i0", "fabs", "signbit", "copysign", "heaviside",
    "ldexp", "float_power", "fmod", "nextafter", "logaddexp", "logaddexp2",
    "floor_divide", "invert", "bitwise_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "left_shift", "right_shift", "logical_not",
    # reductions
    "sum", "mean", "prod", "max", "min", "argmax", "argmin", "std", "var",
    "average", "median", "quantile", "percentile", "ptp", "cumsum",
    "cumprod", "nansum", "nanprod", "nanmax", "nanmin", "nanmean",
    "nanstd", "nanvar", "nanargmax", "nanargmin", "nancumsum",
    "nancumprod", "count_nonzero", "allclose", "isclose", "array_equal",
    "logsumexp",
    # shape
    "reshape", "transpose", "expand_dims", "squeeze", "flip", "flipud",
    "fliplr", "roll", "rot90", "tril", "triu", "tile", "repeat", "pad",
    "split", "stack", "moveaxis", "rollaxis", "diff", "ediff1d",
    "broadcast_to", "atleast_2d", "atleast_3d", "diag",
    # joining
    "hstack", "vstack", "dstack", "column_stack", "meshgrid",
    "broadcast_arrays",
    # linalg/products
    "dot", "matmul", "kron", "outer", "inner", "vdot", "tensordot",
    "cross", "vander", "polyval", "trapz", "convolve", "correlate",
    # sorting/searching
    "sort", "argsort", "searchsorted", "digitize", "lexsort",
    "argpartition", "where", "take", "one_hot",
    # dynamic-shape (computed on the operand's device)
    "unique", "nonzero", "flatnonzero", "argwhere", "bincount",
    "histogram", "setdiff1d", "intersect1d", "union1d", "isin", "interp",
    "take_along_axis", "cov", "corrcoef", "nanmedian", "nanquantile",
    "nanpercentile", "unwrap", "fmax", "fmin", "extract",
    # misc
    "gather_nd", "real", "imag", "conj", "angle",
]

for _np_name in _PASSTHROUGH:
    _fn = getattr(_nd, _ALIASES.get(_np_name, _np_name), None)
    if _fn is not None:
        setattr(_this, _np_name, _fn)

for _np_name, _target in _ALIASES.items():
    _fn = getattr(_nd, _target, None)
    if _fn is not None and not hasattr(_this, _np_name):
        setattr(_this, _np_name, _fn)


# numpy's call signatures take non-array positionals where the mx.nd
# wrappers take keywords: these shims translate
def reshape(a, newshape, order="C"):
    if order != "C":
        raise NotImplementedError("only order='C' reshape is supported")
    return a.reshape(newshape)


def transpose(a, axes=None):
    return _nd.transpose(a, axes=axes) if axes is not None else \
        _nd.transpose(a)


def expand_dims(a, axis):
    return _nd.expand_dims(a, axis=axis)


def squeeze(a, axis=None):
    return _nd.squeeze(a, axis=axis) if axis is not None else _nd.squeeze(a)


def clip(a, a_min, a_max):
    return _nd.clip(a, a_min=a_min, a_max=a_max)


def roll(a, shift, axis=None):
    return _nd.roll(a, shift=shift, axis=axis)


def rot90(a, k=1, axes=(0, 1)):
    return _nd.rot90(a, k=k, axes=axes)


def moveaxis(a, source, destination):
    return _nd.moveaxis(a, source=source, destination=destination)


def rollaxis(a, axis, start=0):
    return _nd.rollaxis(a, axis=axis, start=start)


def repeat(a, repeats, axis=None):
    return _nd.repeat(a, repeats=repeats, axis=axis)


def tile(a, reps):
    return _nd.tile(a, reps=reps)


def flip(a, axis=None):
    return _nd.flip(a, axis=axis)


def split(a, indices_or_sections, axis=0):
    """A section count or the split points, as ``np.split``."""
    return _nd.split(a, num_outputs=indices_or_sections, axis=axis)


def take(a, indices, axis=None):
    if axis is None:
        return _nd.take(a.reshape(-1), indices, axis=0)
    return _nd.take(a, indices, axis=axis)


def quantile(a, q, axis=None, keepdims=False):
    return _nd.quantile(a, q=q, axis=axis, keepdims=keepdims)


def percentile(a, q, axis=None, keepdims=False):
    return _nd.percentile(a, q=q, axis=axis, keepdims=keepdims)


def tensordot(a, b, axes=2):
    return _nd.tensordot(a, b, axes=axes)


def partition(a, kth, axis=-1):
    return _nd.partition_op(a, kth=kth, axis=axis)


def argpartition(a, kth, axis=-1):
    return _nd.argpartition(a, kth=kth, axis=axis)


def resize(a, new_shape):
    return _nd.resize_op(a, new_shape=new_shape)


def cumsum(a, axis=None):
    return _nd.cumsum(a, axis=axis)


def cumprod(a, axis=None):
    return _nd.cumprod(a, axis=axis)


def diff(a, n=1, axis=-1):
    return _nd.diff(a, n=n, axis=axis)


def tril(m, k=0):
    return _nd.tril(m, k=k)


def triu(m, k=0):
    return _nd.triu(m, k=k)


def trace(a, offset=0, axis1=0, axis2=1):
    return _nd.trace_op(a, offset=offset, axis1=axis1, axis2=axis2)


def searchsorted(a, v, side="left"):
    return _nd.searchsorted(a, v, side=side)


def take_along_axis(a, indices, axis=-1):
    return _nd.take_along_axis(a, indices, axis=axis)


def put_along_axis(a, indices, values, axis=-1):
    return _nd.put_along_axis(a, indices, values, axis=axis)


def einsum(subscripts, *operands):
    """numpy's einsum: the subscripts first."""
    return _nd.invoke_op("einsum", *operands, subscripts=subscripts)


def concatenate(seq, axis=0):
    return _nd.concat(*seq, dim=axis)


def append(arr, values, axis=None):
    if axis is None:
        return _nd.concat(arr.reshape(-1), values.reshape(-1), dim=0)
    return _nd.concat(arr, values, dim=axis)


# --- creators: computed on ``ctx`` (the default context when None) ----------
def _created(y, dtype):
    """``y`` (float64) as an NDArray of ``dtype`` (float32 when None); an
    integer dtype takes the floor, as numpy's ``linspace``."""
    dt = _narrow_x32(_resolve_dtype(dtype) or _torch.float32)
    if not (dt.is_floating_point or dt.is_complex):
        y = _torch.floor(y)
    return ndarray(y.to(dt))


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None):
    return _created(_spaced(start, stop, num, endpoint,
                            device=_resolve(ctx)), dtype)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None):
    return _created(_torch.pow(base, _spaced(
        start, stop, num, endpoint, device=_resolve(ctx))), dtype)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None):
    """numpy's ``geomspace`` for endpoints of one sign: powers of ten
    spaced evenly, the endpoints exact."""
    # this module's ``abs``, ``max``, ``min`` and ``round`` are mx.np's
    sign = -1.0 if start < 0 and stop < 0 else 1.0
    lo, hi = _math.fabs(start), _math.fabs(stop)
    y = _torch.pow(10.0, _spaced(_math.log10(lo), _math.log10(hi), num,
                                 endpoint, device=_resolve(ctx)))
    if num > 0:
        y[0] = lo
        if endpoint and num > 1:
            y[-1] = hi
    return _created(y * sign, dtype)


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype or "float32", ctx=ctx)


def full_like(a, fill_value, dtype=None):
    return full(a.shape, fill_value, dtype=dtype or a.dtype, ctx=a.ctx)


def empty_like(a, dtype=None):
    return zeros(a.shape, dtype=dtype or a.dtype, ctx=a.ctx)


def asarray(a, dtype=None, ctx=None):
    if isinstance(a, ndarray):
        return a.astype(dtype) if dtype is not None else a
    return array(a, dtype=dtype, ctx=ctx)


newaxis = None
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan

float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int32 = _onp.int32
int64 = _onp.int64
int8 = _onp.int8
uint8 = _onp.uint8
bool_ = _onp.bool_


from . import fft, linalg, random  # noqa: E402,F401


def _dtype_of(a):
    return a.dtype if isinstance(a, ndarray) else a


def _is_torch_only(dt):
    return isinstance(dt, _torch.dtype) and _numpy_dtype(dt) is None


def _as_torch(dt):
    return dt if isinstance(dt, _torch.dtype) else _resolve_dtype(dt)


def promote_types(t1, t2):
    if _is_torch_only(t1) or _is_torch_only(t2):
        t = _torch.promote_types(_as_torch(t1), _as_torch(t2))
        return _numpy_dtype(t) or t
    return _onp.promote_types(t1, t2)


def result_type(*args):
    """numpy's ``result_type``; with bfloat16 among the arrays, torch's
    promotion of the arrays' types (a Python scalar is weak: it takes the
    arrays' type)."""
    dts = [_dtype_of(a) for a in args]
    if any(_is_torch_only(d) for d in dts):
        typed = [d for d in dts if not isinstance(d, (bool, int, float,
                                                      complex))]
        return _functools.reduce(promote_types, typed)
    return _onp.result_type(*dts)


def can_cast(from_, to, casting="safe"):
    """numpy's ``can_cast``; with bfloat16 on either side, ``safe`` asks
    that the promotion of both is ``to``, ``same_kind`` torch's own rule."""
    from_ = _dtype_of(from_)
    if _is_torch_only(from_) or _is_torch_only(to):
        f, t = _as_torch(from_), _as_torch(to)
        if casting in ("no", "equiv"):
            return f == t
        if casting == "safe":
            return _torch.promote_types(f, t) == t
        if casting == "same_kind":
            return _torch.can_cast(f, t)
        return True
    return _onp.can_cast(from_, to, casting=casting)


def issubdtype(arg1, arg2):
    """numpy's ``issubdtype``; bfloat16 is a float type of its own."""
    if _is_torch_only(arg1) or _is_torch_only(arg2):
        if arg1 == arg2:
            return True
        return _is_torch_only(arg1) and arg2 in (
            _onp.floating, _onp.inexact, _onp.number, _onp.generic)
    return _onp.issubdtype(arg1, arg2)


def shape(a):
    return a.shape


def ndim(a):
    return a.ndim


def size(a, axis=None):
    return a.shape[axis] if axis is not None else a.size
