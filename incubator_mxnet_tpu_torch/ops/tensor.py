"""Tensor ops: arithmetic, broadcast, reductions, shape, index, sequence
and ordering ops.

Counterpart of the JAX package's ``ops/tensor.py``, with the same names,
aliases and results (the reference's ``src/operator/tensor/``). Each op is
a function over torch tensors. Where torch's answer differs from jnp's in
type (integer sums, arg-reductions, comparisons) or value (``digamma(0)``,
gathers out of range, the order of ties), the op gives jnp's.
bf16/fp16 sums, means and products accumulate in fp32, as the JAX
package's do under its default ``MXTPU_SAFE_ACCUMULATION``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def int_division(fn, a, b, at_zero=None):
    """``fn(a, b)`` (``torch.remainder``, ``torch.fmod`` or
    ``torch.floor_divide``; either operand may be a Python number) with
    the JAX package's answer where an integer divisor is 0: ``at_zero(a)``,
    or 0. Torch raises there on the CPU and the card's integer division
    gives undefined bits, so the division never sees a zero: it runs on a
    divisor made safe, and a select writes the answer at the zeros."""
    kind = torch.result_type(a, b)
    if kind.is_floating_point or kind.is_complex or kind == torch.bool:
        return fn(a, b)
    dev = next(t.device for t in (a, b) if isinstance(t, torch.Tensor))
    a, b = (torch.as_tensor(t, device=dev) for t in (a, b))
    zero = b == 0
    out = fn(a, torch.where(zero, torch.ones_like(b), b))
    fill = torch.zeros_like(out) if at_zero is None else at_zero(a).to(
        out.dtype)
    return torch.where(zero, fill, out)


def floor_divide_at_zero(a):
    """jnp's ``floor_divide(a, 0)`` for integers: XLA's quotient, all ones
    (-1), less one where ``a`` is nonzero (its remainder ``a`` is nonzero
    and its sign differs from 0's)."""
    return torch.zeros_like(a).bitwise_not() - (a != 0).to(a.dtype)


@register("broadcast_mod", aliases=("mod",))
def mod(a, b):
    # Python/numpy semantics: the result takes the divisor's sign
    return int_division(torch.remainder, a, b)


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
def _cbrt(x):
    # torch has no cbrt; the real cube root keeps the sign, as jnp.cbrt
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _digamma(x):
    # jax.scipy's digamma is NaN at 0, where torch's is -inf
    return torch.where(x == 0, torch.full_like(x, float("nan")),
                       torch.digamma(x))


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "square": torch.square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "reciprocal": lambda x: 1.0 / x, "negative": torch.neg,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "erf": torch.erf, "erfinv": torch.erfinv,
    # exp(gammaln): the reference's gamma loses the sign of Γ(x) for x < 0
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma, "digamma": _digamma,
}
for _name, _fn in _UNARY.items():
    register(_name)(_fn)


@register("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


def _as_float32(fn):
    return lambda x: fn(x).float()


for _name, _fn in [("isnan", torch.isnan), ("isinf", torch.isinf),
                   ("isfinite", torch.isfinite)]:
    register(_name, differentiable=False)(_as_float32(_fn))


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
    """Vector norm over ``axis`` (an int or a 1-tuple), or of the flattened
    array: with ``keepdims`` that one is shape (1,), as the reference keeps
    the flattened axis. Over two axes, ``jnp.linalg.norm``'s matrix norm:
    ``ord=2`` is the largest singular value (MXNet's own ``norm`` gives
    the Frobenius norm there), ``ord=None`` the Frobenius norm."""
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1), ord, dim=0,
                                        keepdim=keepdims)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if len(axes) == 1:
        return torch.linalg.vector_norm(x, 2 if ord is None else ord,
                                        dim=axes[0], keepdim=keepdims)
    if len(axes) != 2:
        raise ValueError(f"norm over {len(axes)} axes: one or two")
    return torch.linalg.matrix_norm(x, "fro" if ord is None else ord,
                                    dim=axes, keepdim=keepdims)


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


@register("matmul")
def matmul(a, b):
    return torch.matmul(a, b)


@register("linalg_gemm2")
def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    return alpha * batch_dot(a, b, transpose_a, transpose_b)


@register("khatri_rao")
def khatri_rao(*mats):
    """Column-wise Kronecker product: rows multiply, columns pair up."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out


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


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return x.expand(shape)


@register("flip", aliases=("reverse",))
def flip(x, axis=0):
    """``x`` reversed along ``axis`` (an int, a tuple, or None: every
    axis)."""
    if axis is None:
        return torch.flip(x, tuple(range(x.dim())))
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


@register("tile")
def tile(x, reps=(1,)):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register("repeat")
def repeat(x, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (None: of the
    flattened array)."""
    if not isinstance(repeats, int):
        repeats = torch.as_tensor(repeats, device=x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_widths(pad_width, ndim):
    """``jnp.pad``'s ``pad_width`` as one (before, after) pair an axis: an
    int, a pair, a 1-tuple, or one pair an axis (MXNet's flat tuple of
    ``2 * ndim`` ints is refused, as the reference refuses it)."""
    if isinstance(pad_width, int):
        return [(pad_width, pad_width)] * ndim
    pw = [tuple(p) if isinstance(p, (tuple, list)) else (p,)
          for p in pad_width]
    if all(len(p) == 1 for p in pw) and len(pw) <= 2:
        # (n,) or (before, after), the same for every axis
        pair = (pw[0][0], pw[-1][0])
        return [pair] * ndim
    if len(pw) == 1 and len(pw[0]) == 2:
        return [pw[0]] * ndim
    if len(pw) == ndim and all(len(p) == 2 for p in pw):
        return pw
    raise ValueError(f"pad: pad_width {pad_width!r} for {ndim} axes: an int, "
                     "a (before, after) pair or one pair an axis")


def _pad_index(n, before, after, mode, device):
    """The source position of each output position of one padded axis:
    ``"edge"`` repeats the end element, ``"reflect"`` mirrors about it
    without repeating it (numpy's modes)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("pad")
def pad(x, pad_width=None, mode="constant", constant_value=0.0):
    """``jnp.pad`` in mode ``"constant"`` (``constant_value``), ``"edge"``
    or ``"reflect"``."""
    widths = _pad_widths(pad_width, x.dim())
    if mode == "constant":
        flat = [w for pair in reversed(widths) for w in pair]
        return F.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(f"pad mode {mode!r}: constant, edge or reflect")
    for axis, (before, after) in enumerate(widths):
        if before or after:
            x = torch.index_select(x, axis, _pad_index(
                x.shape[axis], before, after, mode, x.device))
    return x


@register("depth_to_space")
def depth_to_space(x, block_size=2):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(x, block_size=2):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 5, 3, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register("concat", aliases=("concatenate",))
def concat(*arrays, dim=1, axis=None):
    """MXNet 1.x spells the axis ``dim``, the numpy API ``axis``."""
    return torch.cat(arrays, dim=dim if axis is None else axis)


@register("stack")
def stack(*arrays, axis=0):
    return torch.stack(arrays, dim=axis)


@register("split", aliases=("split_v2",))
def split(x, num_outputs=None, axis=1, squeeze_axis=False):
    """A tuple of ``num_outputs`` equal parts along ``axis`` (a list:
    ``np.split``'s split points); ``squeeze_axis`` drops the axis."""
    if isinstance(num_outputs, int):
        if x.shape[axis] % num_outputs:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                             f"into {num_outputs} equal parts")
        parts = torch.split(x, x.shape[axis] // num_outputs, dim=axis)
    else:
        parts = torch.tensor_split(x, list(num_outputs), dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register("shape_array", differentiable=False)
def shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register("diag")
def diag(x, k=0):
    """``jnp.diag`` (a vector's matrix, a matrix's ``k``-th diagonal), or
    the diagonals of the last two axes."""
    return torch.diag(x, k) if x.dim() <= 2 else torch.diagonal(x, k, -2, -1)


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
    out = take_along(x, torch.unsqueeze(index, axis), axis)
    return out if keepdims else torch.squeeze(out, axis)


def take_along(x, index, axis):
    """``jnp.take_along_axis(x, index, axis)``: an index in ``[-n, n)``
    counts from the end where negative, one outside reads
    :func:`gather_fill` (through a clamped index)."""
    idx, out_of_range = wrap_index(index, x.shape[axis])
    out = torch.take_along_dim(x, idx, dim=axis)
    return out.masked_fill(out_of_range, gather_fill(x.dtype))


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


def _nd_index(indices, shape):
    """``indices`` (M, ...) as integer indices of the first M axes of
    ``shape``, a negative one counted from the end; and those axes' sizes,
    shaped to broadcast against it."""
    idx = indices.long()
    n = torch.tensor(shape[:idx.shape[0]], device=idx.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return torch.where(idx < 0, idx + n, idx), n


@register("gather_nd")
def gather_nd(x, indices):
    """``x[tuple(indices)]``: ``indices`` (M, ...) index the first M axes;
    an index out of range reads the clamped one, as jnp's gather, and
    passes no gradient back, as jnp's scatter of the gradient drops it."""
    idx, n = _nd_index(indices, x.shape)
    out = x[tuple(torch.minimum(idx.clamp(min=0), n - 1))]
    inside = ((idx >= 0) & (idx < n)).all(0)
    inside = inside.reshape(inside.shape + (1,) * (out.dim() - inside.dim()))
    return torch.where(inside, out, out.detach())


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (M, N...):
    where an index repeats, the last write wins, and an index out of range
    writes nothing (jnp's ``.at[].set``). Writes that a later one
    overwrites are dropped before the write, so it is the same on the card
    (where a write of repeated indices lands in no set order) and its
    gradient reaches the last write only, as jnp's."""
    shape = tuple(shape)
    m = indices.shape[0]
    idx, n = _nd_index(indices, shape)
    valid = ((idx >= 0) & (idx < n)).all(0)
    strides = torch.tensor(
        [math.prod(shape[i + 1:m]) for i in range(m)], device=idx.device)
    flat = (idx.reshape(m, -1) * strides[:, None]).sum(0)
    valid = valid.reshape(-1)
    order = torch.arange(flat.numel(), device=flat.device)
    cells = math.prod(shape[:m])
    last = torch.full((cells,), -1, dtype=torch.long, device=flat.device)
    last = last.scatter_reduce(0, flat[valid], order[valid], "amax")
    keep = valid & (last[flat.clamp(0, cells - 1)] == order)
    rows = data.reshape((-1,) + shape[m:])
    out = torch.zeros((cells,) + shape[m:], dtype=data.dtype,
                      device=data.device)
    return out.index_put((flat[keep],), rows[keep]).reshape(shape)


@register("where")
def where(cond, a, b):
    """``a`` where ``cond`` is nonzero, else ``b``."""
    return torch.where(cond != 0, a, b)


@register("boolean_mask", differentiable=False)
def boolean_mask(x, mask):
    """The rows of ``x`` where ``mask`` is nonzero: a shape known only
    from the data (the card's count is read back to the host)."""
    return x[mask != 0]


@register("slice_like")
def slice_like(x, shape_like, axes=()):
    """``x`` cut to ``shape_like``'s size along ``axes`` (none: every
    axis)."""
    for ax in axes or range(x.dim()):
        x = torch.narrow(x, ax, 0, min(x.shape[ax], shape_like.shape[ax]))
    return x


# -- sequence ops (reference src/operator/sequence_*): the sequence axis is
#    ``axis``, the batch axis 1 when ``axis`` is 0, else 0
def _lengths_along(data, sequence_length, axis):
    shape = [1] * data.dim()
    batch_axis = 1 if axis == 0 else 0
    shape[batch_axis] = data.shape[batch_axis]
    return sequence_length.reshape(shape)


def positions_along(x, axis):
    """0, 1, ... along ``axis`` of ``x``, shaped to broadcast against it."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return torch.arange(x.shape[axis], device=x.device).reshape(shape)


@register("sequence_mask")
def sequence_mask(data, sequence_length=None, use_sequence_length=True,
                  value=0.0, axis=0):
    """``value`` at positions at or past each sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    keep = positions_along(data, axis) < _lengths_along(data, sequence_length,
                                                   axis)
    return torch.where(keep, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("sequence_last")
def sequence_last(data, sequence_length=None, use_sequence_length=True,
                  axis=0):
    """Each sequence's element at its length - 1 (without lengths, the
    last position)."""
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, data.shape[axis] - 1)
    moved = torch.movedim(data, axis, 0)          # (seq, batch, ...)
    idx = (sequence_length - 1).to(torch.int32).reshape(
        (1, -1) + (1,) * (moved.dim() - 2))
    return take_along(moved, idx, 0)[0]


@register("sequence_reverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=True,
                     axis=0):
    """Each sequence's first length positions reversed; positions at or
    past its length stay where they are."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    moved = torch.movedim(data, axis, 0)
    pos = torch.arange(moved.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int32)[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    out = take_along(moved, src.reshape(src.shape + (1,) * (moved.dim() - 2)),
                     0)
    return torch.movedim(out, 0, axis)


# -- ordering (jnp's tie rules: a stable ascending sort; the descending
#    order is its flip, so ties come out latest index first, where top_k
#    takes the lowest index first)
@register("sort")
def sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype=torch.float32):
    out = torch.sort(x, dim=axis, stable=True).indices
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(resolve_dtype(dtype))


@register("topk", differentiable=False)
def topk(x, k=1, axis=-1, ret_typ="indices", is_ascend=False,
         dtype=torch.float32):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties to
    the lower index (``lax.top_k``); ``ret_typ`` "indices", "value" or
    "both" (values, indices)."""
    order = torch.sort(x, dim=axis, descending=not is_ascend, stable=True)
    vals = torch.narrow(order.values, axis, 0, k)
    idx = torch.narrow(order.indices, axis, 0, k).to(resolve_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    if ret_typ != "indices":
        raise ValueError(f"topk ret_typ {ret_typ!r}: indices, value or both")
    return idx


# -- casting -----------------------------------------------------------------
#: the JAX package runs x32: a 64-bit integer type is its 32-bit type
_X32_INTS = {torch.int64: torch.int32, torch.uint64: torch.uint32}


@register("cast", aliases=("Cast",))
def cast(x, dtype=torch.float32):
    """``x`` in ``dtype``. Floats into an integer type saturate, as the
    reference's ``jnp.asarray`` does: truncated toward zero, clamped to the
    type's range (+-inf to its ends), NaN to 0. A 64-bit integer type
    narrows first (x32), so a float saturates at the 32-bit type's ends."""
    dtype = _X32_INTS.get(resolve_dtype(dtype), resolve_dtype(dtype))
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
    return int_division(torch.remainder, x, scalar)


@register("_rmod_scalar", aliases=("rmod_scalar",))
def _rmod_scalar(x, scalar=1.0):
    return int_division(torch.remainder, scalar, x)


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
