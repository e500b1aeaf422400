"""Tensor ops: arithmetic, broadcast, reductions, shape and index ops.

Counterpart of the subset of the JAX package's ``ops/tensor.py`` that
``NDArray``'s methods and the imperative path call, with the same names,
aliases and results (the reference's ``src/operator/tensor/``). Each op is
a function over torch tensors. Where torch's answer differs from jnp's in
type (integer sums, arg-reductions, comparisons), the op casts to jnp's.
bf16/fp16 sums, means and products accumulate in fp32, as the JAX
package's do under its default ``MXTPU_SAFE_ACCUMULATION``.
"""

from __future__ import annotations

import torch

from ..base import resolve_dtype
from .registry import register

_LOW_PRECISION = (torch.bfloat16, torch.float16)


# -- elementwise binary (broadcasting) ---------------------------------------
@register("elemwise_add", aliases=("broadcast_add", "add"))
def add(a, b):
    return a + b


@register("elemwise_sub", aliases=("broadcast_sub", "subtract"))
def sub(a, b):
    return a - b


@register("elemwise_mul", aliases=("broadcast_mul", "multiply"))
def mul(a, b):
    return a * b


@register("elemwise_div", aliases=("broadcast_div", "divide"))
def div(a, b):
    return a / b


@register("broadcast_power", aliases=("power",))
def power(a, b):
    return a ** b


@register("broadcast_maximum", aliases=("maximum",))
def maximum(a, b):
    return torch.maximum(a, b)


@register("broadcast_minimum", aliases=("minimum",))
def minimum(a, b):
    return torch.minimum(a, b)


@register("broadcast_mod", aliases=("mod",))
def mod(a, b):
    # Python/numpy semantics: the result takes the divisor's sign
    return torch.remainder(a, b)


@register("broadcast_hypot")
def hypot(a, b):
    return torch.hypot(a, b)


def _compare(fn):
    """A comparison cast to the first operand's type (1 or 0)."""
    return lambda a, b: fn(a, b).to(a.dtype)


for _name, _fn in [
    ("equal", torch.eq), ("not_equal", torch.ne), ("greater", torch.gt),
    ("greater_equal", torch.ge), ("lesser", torch.lt),
    ("lesser_equal", torch.le),
    ("logical_and", lambda a, b: torch.logical_and(a != 0, b != 0)),
    ("logical_or", lambda a, b: torch.logical_or(a != 0, b != 0)),
    ("logical_xor", lambda a, b: torch.logical_xor(a != 0, b != 0)),
]:
    register("broadcast_" + _name, differentiable=False,
             aliases=(_name,))(_compare(_fn))


# -- elementwise unary -------------------------------------------------------
_UNARY = {
    "abs": torch.abs, "negative": torch.neg, "sign": torch.sign,
    "square": torch.square, "sqrt": torch.sqrt, "exp": torch.exp,
    "log": torch.log, "tanh": torch.tanh,
}
for _name, _fn in _UNARY.items():
    register(_name)(_fn)


@register("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


# -- reductions --------------------------------------------------------------
def _axes(x, axis, exclude=False):
    """``axis`` (None, int or tuple) as a tuple of non-negative dims; an
    empty tuple or list reduces nothing (jnp's meaning; MXNet's own
    ``axis=()`` reduced every axis)."""
    if axis is None:
        return tuple(range(x.dim()))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.dim() for a in axes)
    if exclude:
        axes = tuple(i for i in range(x.dim()) if i not in axes)
    return axes


def _acc_dtype(x):
    return torch.float32 if x.dtype in _LOW_PRECISION else None


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _int_acc_dtype(x):
    """The type jnp sums and multiplies an integer or bool array in: a
    narrow signed integer or bool widens to int32, a narrow unsigned one
    to uint32; int32 stays (and int64, which only a caller outside
    ``NDArray`` passes)."""
    if x.dtype in _UNSIGNED:
        return torch.uint32
    return torch.int64 if x.dtype == torch.int64 else torch.int32


def _sum(x, axes, keepdims):
    if not axes:
        return x if x.is_floating_point() else x.to(_int_acc_dtype(x))
    acc = _acc_dtype(x)
    if acc is not None:
        return torch.sum(x, dim=axes, keepdim=keepdims, dtype=acc).to(x.dtype)
    if not x.is_floating_point():
        return torch.sum(x, dim=axes, keepdim=keepdims).to(_int_acc_dtype(x))
    return torch.sum(x, dim=axes, keepdim=keepdims)


def _mean(x, axes, keepdims):
    if not x.is_floating_point():
        x = x.float()                    # jnp.mean of ints is float32
    if not axes:
        return x
    acc = _acc_dtype(x)
    if acc is not None:
        return torch.mean(x.to(acc), dim=axes, keepdim=keepdims).to(x.dtype)
    return torch.mean(x, dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    acc = _acc_dtype(x)
    if acc is None and not x.is_floating_point():
        # torch multiplies integers in int64; the product wraps in the
        # 32-bit type as jnp's does
        out = x.to(torch.int64)
        for a in sorted(axes, reverse=True):
            out = torch.prod(out, dim=a, keepdim=keepdims)
        return out.to(_int_acc_dtype(x))
    out = x if acc is None else x.to(acc)
    for a in sorted(axes, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims)
    return out.to(x.dtype)


def _nan_to(x, value):
    return torch.where(torch.isnan(x), torch.full_like(x, value), x) \
        if x.is_floating_point() else x


def _amax(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims) if axes else x


def _amin(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims) if axes else x


def _reduce(fn):
    def f(x, axis=None, keepdims=False, exclude=False):
        return fn(x, _axes(x, axis, exclude), keepdims)
    return f


register("sum", aliases=("sum_axis",))(_reduce(_sum))
register("mean")(_reduce(_mean))
register("prod")(_reduce(_prod))
register("nansum")(_reduce(lambda x, a, k: _sum(_nan_to(x, 0), a, k)))
register("nanprod")(_reduce(lambda x, a, k: _prod(_nan_to(x, 1), a, k)))
register("max", aliases=("max_axis",))(_reduce(_amax))
register("min", aliases=("min_axis",))(_reduce(_amin))


def _arg(fn, x, axis, keepdims):
    if axis is None:
        r = fn(x.reshape(-1))
    else:
        r = fn(x, dim=axis, keepdim=keepdims)
    return r.float()                     # the reference returns float32


@register("argmax", differentiable=False)
def argmax(x, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin", differentiable=False)
def argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    """Vector norm over ``axis`` (an int), or of the flattened array: with
    ``keepdims`` that one is shape (1,), as the reference keeps the
    flattened axis."""
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1), ord, dim=0,
                                        keepdim=keepdims)
    if not isinstance(axis, int):
        raise NotImplementedError("norm over several axes (a matrix norm) "
                                  "is not ported")
    return torch.linalg.vector_norm(x, ord, dim=axis, keepdim=keepdims)


@register("cumsum")
def cumsum(x, axis=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, axis)


@register("logsumexp")
def logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(x, dim=_axes(x, axis), keepdim=keepdims)


# -- linear algebra ----------------------------------------------------------
@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False):
    """Reference ``mx.nd.dot``: the last axis of a with the first of b."""
    if transpose_a and a.dim() >= 2:
        a = a.transpose(-1, -2)
    if transpose_b and b.dim() >= 2:
        b = b.transpose(-1, -2)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


# -- shape manipulation ------------------------------------------------------
@register("reshape")
def reshape(x, shape=None):
    return torch.reshape(x, tuple(shape))


def _index_along(x, axis, start, stop, step):
    """x[..., start:stop:step, ...] on ``axis`` with Python slice rules,
    negative steps included (torch's basic slicing refuses those)."""
    idx = torch.arange(*slice(start, stop, step).indices(x.shape[axis]),
                       device=x.device)
    return torch.index_select(x, axis, idx)


@register("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    """Reference SliceAxis."""
    return _index_along(x, axis % x.dim(), begin, end, None)


@register("slice", aliases=("crop",))
def slice_op(x, begin=None, end=None, step=None):
    """Reference Slice: multi-axis begin/end/step (None = full extent)."""
    begin, end, step = begin or (), end or (), step or ()
    for i in range(x.dim()):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) else None
        if (b, e, s) != (None, None, None):
            x = _index_along(x, i, b, e, s)
    return x


@register("transpose")
def transpose(x, axes=None):
    axes = tuple(reversed(range(x.dim()))) if axes is None else tuple(axes)
    return x.permute(axes)


@register("swapaxes_op", aliases=("SwapAxis",))
def swapaxes_op(x, dim1=0, dim2=0):
    return torch.transpose(x, dim1, dim2)


@register("expand_dims")
def expand_dims(x, axis=0):
    return torch.unsqueeze(x, axis)


@register("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size "
                             f"{x.shape[a]}")
    return torch.squeeze(x, axes)


@register("broadcast_to")
def broadcast_to(x, shape=None):
    shape = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return x.expand(shape)


# -- indexing ----------------------------------------------------------------
@register("take")
def take(x, indices, axis=0, mode="clip"):
    """Rows of ``x`` along ``axis`` at ``indices`` (any shape); ``mode``
    ``"clip"`` clamps out-of-range indices, ``"wrap"`` wraps them."""
    n = x.shape[axis]
    idx = indices.long()
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise ValueError(f"take mode {mode!r}: 'clip' or 'wrap'")
    out = torch.index_select(x, axis, idx.reshape(-1))
    axis %= x.dim()
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@register("pick")
def pick(x, index, axis=-1, keepdims=False):
    """``x``'s element at ``index`` along ``axis`` (reference ``pick``).
    An index in ``[-n, n)`` counts from the end where negative; one outside
    reads the fill of ``jnp.take_along_axis``: NaN for floats, the least
    value of a signed integer type, the largest of an unsigned one. The
    gather reads a clamped index, so no read leaves the array."""
    axis %= x.dim()
    idx, out_of_range = wrap_index(torch.unsqueeze(index, axis),
                                   x.shape[axis])
    out = torch.take_along_dim(x, idx, dim=axis)
    out = out.masked_fill(out_of_range, gather_fill(x.dtype))
    return out if keepdims else torch.squeeze(out, axis)


def wrap_index(index, n):
    """``(idx, outside)`` for a gather over an axis of ``n``: ``index``
    truncated to integers, an index in ``[-n, -1]`` counted from the end,
    and clamped into ``[0, n)`` (no read leaves the array; on the card an
    out-of-range gather is a device-side assert that ends the CUDA
    context), and where it lay outside ``[-n, n)``: the positions whose
    result takes :func:`gather_fill`, as ``jnp.take`` and
    ``jnp.take_along_axis`` read them."""
    idx = index.long()
    outside = (idx < -n) | (idx >= n)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1), outside


def gather_fill(dtype):
    """What ``jnp.take_along_axis`` reads outside the array."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("one_hot", differentiable=False)
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype=torch.float32):
    """``on_value`` at each index, ``off_value`` elsewhere; an index
    outside ``[0, depth)`` gives a row of ``off_value`` (as
    ``jax.nn.one_hot``)."""
    cols = torch.arange(depth, device=indices.device)
    hot = (indices.long().unsqueeze(-1) == cols).to(dtype)
    return hot * (on_value - off_value) + off_value


# -- casting -----------------------------------------------------------------
@register("cast", aliases=("Cast",))
def cast(x, dtype=torch.float32):
    """``x`` in ``dtype``. Floats into an integer type saturate, as the
    reference's ``jnp.asarray`` does: truncated toward zero, clamped to the
    type's range (+-inf to its ends), NaN to 0."""
    dtype = resolve_dtype(dtype)
    if not x.is_floating_point() or dtype.is_floating_point \
            or dtype.is_complex or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    # fp64 holds every 32-bit integer; the ends of int64 (2**63 - 1 rounds
    # up to 2**63) are written after the cast
    y = torch.nan_to_num(x.double(), nan=0.0)
    high, low = y >= float(info.max), y <= float(info.min)
    out = torch.where(high | low, torch.zeros_like(y), y).to(dtype)
    return out.masked_fill(high, info.max).masked_fill(low, info.min)


# -- scalar arithmetic (reference _plus_scalar/_mul_scalar/... family). The
#    scalar is an attribute, not an array, so the array keeps its type
#    (bf16 * 2.0 stays bf16), as jnp's weak types do.
@register("_plus_scalar", aliases=("plus_scalar",))
def _plus_scalar(x, scalar=0.0):
    return x + scalar


@register("_minus_scalar", aliases=("minus_scalar",))
def _minus_scalar(x, scalar=0.0):
    return x - scalar


@register("_rminus_scalar", aliases=("rminus_scalar",))
def _rminus_scalar(x, scalar=0.0):
    return scalar - x


@register("_mul_scalar", aliases=("mul_scalar",))
def _mul_scalar(x, scalar=1.0):
    return x * scalar


@register("_div_scalar", aliases=("div_scalar",))
def _div_scalar(x, scalar=1.0):
    return x / scalar


@register("_rdiv_scalar", aliases=("rdiv_scalar",))
def _rdiv_scalar(x, scalar=1.0):
    return scalar / x


@register("_power_scalar", aliases=("power_scalar",))
def _power_scalar(x, scalar=1.0):
    return x ** scalar


@register("_rpower_scalar", aliases=("rpower_scalar",))
def _rpower_scalar(x, scalar=1.0):
    return scalar ** x


@register("_mod_scalar", aliases=("mod_scalar",))
def _mod_scalar(x, scalar=1.0):
    return torch.remainder(x, scalar)


@register("_rmod_scalar", aliases=("rmod_scalar",))
def _rmod_scalar(x, scalar=1.0):
    return torch.remainder(scalar, x)


@register("_maximum_scalar", aliases=("maximum_scalar",))
def _maximum_scalar(x, scalar=0.0):
    return torch.clamp(x, min=scalar)


@register("_minimum_scalar", aliases=("minimum_scalar",))
def _minimum_scalar(x, scalar=0.0):
    return torch.clamp(x, max=scalar)


for _name, _fn in [
    ("_equal_scalar", torch.eq), ("_not_equal_scalar", torch.ne),
    ("_greater_scalar", torch.gt), ("_greater_equal_scalar", torch.ge),
    ("_lesser_scalar", torch.lt), ("_lesser_equal_scalar", torch.le),
]:
    register(_name, differentiable=False)(
        (lambda f: lambda x, scalar=0.0: f(x, scalar).to(x.dtype))(_fn))
