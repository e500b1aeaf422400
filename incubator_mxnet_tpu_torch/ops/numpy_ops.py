"""The numpy-parity ops: the registry backing of the ``mx.np`` front.

Counterpart of the JAX package's ``ops/numpy_ops.py`` (the reference's
``src/operator/numpy/``). Each op is a function over torch tensors that
gives jnp's answer under x32 where PyTorch's default differs:

* ``median``/``nanmedian`` average the two middle values of an even count
  (jnp's ``midpoint``), where ``torch.median`` takes the lower one; every
  quantile sorts and interpolates as jnp does (``torch.quantile`` refuses
  inputs above 2**24 elements), and a NaN in a slice makes it NaN.
* ``partition_op`` gives jnp's fixed order: the ``kth + 1`` smallest
  ascending, then the rest descending; ``argpartition`` the indices of the
  ``kth + 1`` smallest (ties by position), then the others in ascending
  position.
* ``nanargmax``/``nanargmin`` of an all-NaN slice give -1.
* ``float_power`` computes in float32, as x32 does (``torch.float_power``
  computes in float64).
* The bitwise ops and shifts cast a float operand to int32 first;
  ``heaviside`` promotes its operands to one float type.
* Index and count results are int32.

The dynamic-shape ops (``unique``, ``nonzero``, ``flatnonzero``,
``argwhere``, ``bincount``, ``histogram``, ``setdiff1d``, ``intersect1d``,
``union1d``, ``compress_op``, ``extract``) compute on the operand's own
device, and their results stay there; the reference copies them to the
host. Their output shape depends on the data, so they wait for the device,
and inside a CUDA graph capture they raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXTPUError
from .registry import register
from .tensor import (_axes, _int_acc_dtype, floor_divide_at_zero,
                     int_division, take_along, wrap_index)


def _promote(*ts):
    """The operands in their common type (jnp's promotion of arrays)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _inexact(*ts):
    """The operands in their common type, integers and bools as float32."""
    ts = _promote(*ts)
    if ts[0].is_floating_point() or ts[0].is_complex():
        return ts
    return [t.float() for t in ts]


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _dynamic(name, *ts):
    """Refuse a dynamic-shape op inside a CUDA graph capture: its output
    shape needs the device's answer, which a capture cannot wait for."""
    if any(t.is_cuda for t in ts) and torch.cuda.is_current_stream_capturing():
        raise MXTPUError(f"{name}: the output shape depends on the data, so "
                         "it cannot run inside a CUDA graph capture")


# --- elementwise / math ------------------------------------------------------
@register("exp2")
def exp2(x):
    return torch.exp2(_float(x))


@register("logaddexp")
def logaddexp(a, b):
    return torch.logaddexp(*_inexact(a, b))


@register("logaddexp2")
def logaddexp2(a, b):
    return torch.logaddexp2(*_inexact(a, b))


@register("copysign")
def copysign(a, b):
    return torch.copysign(*_inexact(a, b))


@register("heaviside")
def heaviside(a, b):
    a, b = _inexact(a, b)
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a), b))


@register("ldexp")
def ldexp(a, b):
    return torch.ldexp(_float(a), b.to(torch.int32))


@register("float_power")
def float_power(a, b):
    return torch.pow(*_inexact(a, b))


@register("fmod")
def fmod(a, b):
    return int_division(torch.fmod, *_promote(a, b))


@register("nextafter")
def nextafter(a, b):
    return torch.nextafter(*_inexact(a, b))


@register("signbit", differentiable=False)
def signbit(x):
    return torch.signbit(x)


@register("sinc")
def sinc(x):
    return torch.sinc(_float(x))


@register("i0")
def i0(x):
    return torch.special.i0(_float(x))


class _FloorDivide(torch.autograd.Function):
    """numpy's divmod rule (torch's, as jnp's), whose derivative is zero
    almost everywhere, as jnp differentiates it; torch has none."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.shapes = (a.shape, b.shape)
        return torch.floor_divide(a, b)

    @staticmethod
    def backward(ctx, g):
        return tuple(g.new_zeros(s) for s in ctx.shapes)


@register("floor_divide", aliases=("broadcast_floor_divide",))
def floor_divide(a, b):
    a, b = _promote(a, b)
    if not a.is_floating_point():
        return int_division(torch.floor_divide, a, b, floor_divide_at_zero)
    return _FloorDivide.apply(a, b)


@register("fabs")
def fabs(x):
    return torch.abs(x)


def _as_bitwise(x):
    """bool and integer dtypes pass through; a float casts to int32."""
    if x.dtype == torch.bool or not (x.is_floating_point() or x.is_complex()):
        return x
    return x.to(torch.int32)


@register("invert", aliases=("bitwise_not",), differentiable=False)
def invert(x):
    return torch.bitwise_not(_as_bitwise(x))


@register("bitwise_and", differentiable=False)
def bitwise_and(a, b):
    return torch.bitwise_and(_as_bitwise(a), _as_bitwise(b))


@register("bitwise_or", differentiable=False)
def bitwise_or(a, b):
    return torch.bitwise_or(_as_bitwise(a), _as_bitwise(b))


@register("bitwise_xor", differentiable=False)
def bitwise_xor(a, b):
    return torch.bitwise_xor(_as_bitwise(a), _as_bitwise(b))


@register("left_shift", differentiable=False)
def left_shift(a, b):
    return torch.bitwise_left_shift(*_promote(_as_bitwise(a),
                                              _as_bitwise(b)))


@register("right_shift", differentiable=False)
def right_shift(a, b):
    return torch.bitwise_right_shift(*_promote(_as_bitwise(a),
                                               _as_bitwise(b)))


# --- reductions / statistics -------------------------------------------------
def _var(x, axis, ddof, keepdims):
    x = _float(x)
    return torch.var(x, dim=_axes(x, axis), correction=ddof,
                     keepdim=keepdims)


@register("std")
def std(x, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(_var(x, axis, ddof, keepdims))


@register("var")
def var(x, axis=None, ddof=0, keepdims=False):
    return _var(x, axis, ddof, keepdims)


@register("average")
def average(x, weights=None, axis=None):
    x = _float(x)
    if weights is None:
        return torch.mean(x, dim=_axes(x, axis))
    x, w = _inexact(x, weights)
    if w.shape != x.shape:
        # a 1-D weight along ``axis``
        shape = [1] * x.dim()
        shape[axis] = -1
        w = w.reshape(shape)
    axes = _axes(x, axis)
    return torch.sum(x * w, dim=axes) / torch.sum(w.expand_as(x), dim=axes)


def _quantile(x, q, axis, keepdims, method, squash_nans):
    """jnp's ``_quantile``: sort, then take or interpolate the two
    neighbours of ``q * (count - 1)`` (``count`` the non-NaN values where
    ``squash_nans``, and a NaN anywhere makes the slice NaN where not)."""
    x = _float(x)
    keep_shape = None
    if axis is None:
        if keepdims:
            keep_shape = [1] * x.dim()
        x, axis = x.reshape(-1), 0
    elif not isinstance(axis, int):
        axes = _axes(x, axis)
        keep_shape = [1 if i in axes else s for i, s in enumerate(x.shape)]
        rest = [i for i in range(x.dim()) if i not in axes]
        x = x.permute(rest + list(axes)).reshape(
            [x.shape[i] for i in rest] + [-1])
        axis = x.dim() - 1
    else:
        axis %= x.dim()
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if q.dim() > 1:
        raise ValueError("q must be a scalar or a vector")
    if not squash_nans:
        x = torch.where(torch.isnan(x).any(axis, keepdim=True),
                        torch.full_like(x, math.nan), x)
    x = torch.sort(x, dim=axis).values            # NaN last
    x = torch.movedim(x, axis, -1)
    if squash_nans:
        counts = (~torch.isnan(x)).sum(-1).to(x.dtype)
    else:
        counts = torch.full(x.shape[:-1], x.shape[-1], dtype=x.dtype,
                            device=x.device)
    qv = q.reshape(q.shape + (1,) * counts.dim())
    pos = qv * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top)).long()
    high = torch.maximum(torch.zeros_like(high),
                         torch.minimum(high, top)).long()
    xs = x.expand(q.shape + x.shape)
    low_v = torch.gather(xs, -1, low.unsqueeze(-1)).squeeze(-1)
    high_v = torch.gather(xs, -1, high.unsqueeze(-1)).squeeze(-1)
    if method == "linear":
        out = low_v * low_w + high_v * high_w
    else:                                          # midpoint
        out = (low_v + high_v) * 0.5
    if keepdims:
        if keep_shape is None:
            out = out.unsqueeze(q.dim() + axis)
        else:
            out = out.reshape(tuple(q.shape) + tuple(keep_shape))
    return out


@register("median")
def median(x, axis=None, keepdims=False):
    return _quantile(x, 0.5, axis, keepdims, "midpoint", False)


@register("quantile")
def quantile(x, q=0.5, axis=None, keepdims=False):
    return _quantile(x, q, axis, keepdims, "linear", False)


def _percent(q, x):
    q = torch.as_tensor(q, dtype=_float(x).dtype, device=x.device)
    return q / 100.0


@register("percentile")
def percentile(x, q=50.0, axis=None, keepdims=False):
    return _quantile(x, _percent(q, x), axis, keepdims, "linear", False)


@register("ptp")
def ptp(x, axis=None, keepdims=False):
    axes = _axes(x, axis)
    return torch.amax(x, dim=axes, keepdim=keepdims) \
        - torch.amin(x, dim=axes, keepdim=keepdims)


def _nan_extreme(x, axis, keepdims, fill, fn):
    if not x.is_floating_point():
        return fn(x, dim=_axes(x, axis), keepdim=keepdims)
    axes = _axes(x, axis)
    nan = torch.isnan(x)
    out = fn(torch.where(nan, torch.full_like(x, fill), x), dim=axes,
             keepdim=keepdims)
    return torch.where(nan.all(dim=axes, keepdim=keepdims),
                       torch.full_like(out, math.nan), out)


@register("nanmax")
def nanmax(x, axis=None, keepdims=False):
    return _nan_extreme(x, axis, keepdims, -math.inf, torch.amax)


@register("nanmin")
def nanmin(x, axis=None, keepdims=False):
    return _nan_extreme(x, axis, keepdims, math.inf, torch.amin)


def _not_nan(x):
    return ~torch.isnan(x) if x.is_floating_point() else \
        torch.ones_like(x, dtype=torch.bool)


@register("nanmean")
def nanmean(x, axis=None, keepdims=False):
    x = _float(x)
    axes = _axes(x, axis)
    total = torch.sum(torch.where(torch.isnan(x), torch.zeros_like(x), x),
                      dim=axes, keepdim=keepdims)
    return total / torch.sum(_not_nan(x), dim=axes,
                             keepdim=keepdims).to(x.dtype)


def _nanvar(x, axis, ddof, keepdims):
    """jnp's ``nanvar``: the squares of the non-NaN deviations over their
    count less ``ddof``; NaN where that is not positive."""
    x = _float(x)
    axes = _axes(x, axis)
    nan = torch.isnan(x)
    mean = nanmean(x, axis=axes, keepdims=True)
    centered = torch.where(nan, torch.zeros_like(x), x - mean)
    centered = centered * centered.conj()
    if centered.is_complex():
        centered = centered.real
    total = torch.sum(centered, dim=axes, keepdim=keepdims)
    norm = torch.sum(~nan, dim=axes, keepdim=keepdims) - ddof
    bad = norm <= 0
    total = torch.where(bad, torch.full_like(total, math.nan), total)
    return total / torch.where(bad, torch.ones_like(norm),
                               norm).to(total.dtype)


@register("nanstd")
def nanstd(x, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(_nanvar(x, axis, ddof, keepdims))


@register("nanvar")
def nanvar(x, axis=None, ddof=0, keepdims=False):
    return _nanvar(x, axis, ddof, keepdims)


def _nanarg(x, axis, fill, fn):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if not x.is_floating_point():
        return fn(x, dim=axis).to(torch.int32)
    nan = torch.isnan(x)
    i = fn(torch.where(nan, torch.full_like(x, fill), x), dim=axis)
    return torch.where(nan.all(dim=axis), torch.full_like(i, -1),
                       i).to(torch.int32)


@register("nanargmax", differentiable=False)
def nanargmax(x, axis=None):
    return _nanarg(x, axis, -math.inf, torch.argmax)


@register("nanargmin", differentiable=False)
def nanargmin(x, axis=None):
    return _nanarg(x, axis, math.inf, torch.argmin)


def _cum(fn, x, axis):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if x.is_floating_point() or x.is_complex():
        return fn(x, axis)
    return fn(x, axis).to(_int_acc_dtype(x))


@register("nancumsum")
def nancumsum(x, axis=None):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return _cum(torch.cumsum, x, axis)


@register("nancumprod")
def nancumprod(x, axis=None):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _cum(torch.cumprod, x, axis)


@register("cumprod")
def cumprod(x, axis=None):
    return _cum(torch.cumprod, x, axis)


@register("count_nonzero", differentiable=False)
def count_nonzero(x, axis=None, keepdims=False):
    return torch.sum(x != 0, dim=_axes(x, axis),
                     keepdim=keepdims).to(torch.int32)


@register("allclose", differentiable=False)
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return isclose(a, b, rtol, atol, equal_nan).all()


@register("isclose", differentiable=False)
def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    a, b = _promote(a, b)
    if not (a.is_floating_point() or a.is_complex()):
        return a == b
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register("array_equal", differentiable=False)
def array_equal(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (a == b).all()


# --- shape / rearrangement ---------------------------------------------------
@register("roll")
def roll(x, shift=1, axis=None):
    if axis is None:
        return torch.roll(x.reshape(-1), shift).reshape(x.shape)
    return torch.roll(x, shift, dims=axis)


@register("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, dims=list(axes))


@register("tril")
def tril(x, k=0):
    return torch.tril(x, k)


@register("triu")
def triu(x, k=0):
    return torch.triu(x, k)


@register("trace_op", aliases=("trace",))
def trace_op(x, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)
    out = torch.sum(d, dim=-1)
    return out if x.is_floating_point() or x.is_complex() else \
        out.to(_int_acc_dtype(x))


@register("flipud")
def flipud(x):
    return torch.flipud(x)


@register("fliplr")
def fliplr(x):
    return torch.fliplr(x)


@register("moveaxis")
def moveaxis(x, source=0, destination=0):
    return torch.movedim(x, source, destination)


@register("rollaxis")
def rollaxis(x, axis=0, start=0):
    """numpy's rule: ``axis`` moves to stand before ``start``."""
    n = x.dim()
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    return torch.movedim(x, axis, start) if axis != start else x


@register("diff")
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@register("ediff1d")
def ediff1d(x):
    return torch.diff(x.reshape(-1))


@register("hstack")
def hstack(*arrays):
    return torch.hstack(_promote(*arrays))


@register("vstack")
def vstack(*arrays):
    return torch.vstack(_promote(*arrays))


@register("dstack")
def dstack(*arrays):
    return torch.dstack(_promote(*arrays))


@register("column_stack")
def column_stack(*arrays):
    return torch.column_stack(_promote(*arrays))


@register("meshgrid")
def meshgrid(*arrays, indexing="xy"):
    return tuple(torch.meshgrid(*arrays, indexing=indexing))


@register("broadcast_arrays")
def broadcast_arrays(*arrays):
    return tuple(torch.broadcast_tensors(*arrays))


@register("atleast_2d")
def atleast_2d(x):
    return torch.atleast_2d(x)


@register("atleast_3d")
def atleast_3d(x):
    return torch.atleast_3d(x)


@register("resize_op", aliases=("np_resize",))
def resize_op(x, new_shape=()):
    """numpy's ``resize``: the flattened array tiled, cut to the size of
    ``new_shape``."""
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = math.prod(shape)
    flat = x.reshape(-1)
    reps = -(-n // max(flat.shape[0], 1))
    return flat.repeat(reps)[:n].reshape(shape)


# --- linear algebra / products ----------------------------------------------
@register("kron")
def kron(a, b):
    return torch.kron(*_promote(a, b))


@register("outer")
def outer(a, b):
    return torch.outer(*_promote(a.reshape(-1), b.reshape(-1)))


@register("inner")
def inner(a, b):
    return torch.inner(*_promote(a, b))


@register("vdot")
def vdot(a, b):
    a, b = _promote(a.reshape(-1), b.reshape(-1))
    return torch.dot(a.conj_physical() if a.is_complex() else a, b)


@register("tensordot")
def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(ax) if isinstance(ax, (list, tuple)) else [ax]
                for ax in axes]
    return torch.tensordot(*_promote(a, b), dims=axes)


@register("einsum")
def einsum(*arrays, subscripts=""):
    return torch.einsum(subscripts, *_promote(*arrays))


@register("cross")
def cross(a, b, axis=-1):
    """numpy's cross of 2- or 3-vectors along ``axis`` (a 2-vector has a
    zero third component; two 2-vectors give the scalar z)."""
    a, b = _promote(torch.movedim(a, axis, -1), torch.movedim(b, axis, -1))
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    a2 = a[..., 2] if a.shape[-1] == 3 else torch.zeros_like(a0)
    b2 = b[..., 2] if b.shape[-1] == 3 else torch.zeros_like(b0)
    out = torch.stack(torch.broadcast_tensors(
        a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), -1)
    return torch.movedim(out, -1, axis)


@register("vander")
def vander(x, n=None, increasing=False):
    n = x.shape[0] if n is None else n
    powers = torch.arange(n, device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return torch.pow(x.unsqueeze(-1), powers)


@register("polyval")
def polyval(p, x):
    p, x = _promote(p, x)
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@register("trapz")
def trapz(y, x=None, dx=1.0, axis=-1):
    y = _float(y)
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    y, x = _promote(y, x)
    return torch.trapezoid(y, x, dim=axis)


def _xcorr(x, y):
    """Cross-correlation of the 1-D ``x`` (padded already) with ``y``:
    ``out[i] = sum_k x[i + k] y[k]``; complex as four real ones."""
    if x.is_complex():
        xr, xi, yr, yi = x.real, x.imag, y.real, y.imag
        return torch.complex(_xcorr(xr, yr) - _xcorr(xi, yi),
                             _xcorr(xr, yi) + _xcorr(xi, yr))
    return F.conv1d(x[None, None], y[None, None])[0, 0]


def _conv(a, v, mode, op):
    """jnp's ``_conv``: the longer operand slides, ``correlate``
    conjugates ``v`` (and reverses its output when it swaps them),
    ``convolve`` flips the shorter one."""
    x, y = _inexact(a, v)
    if x.dim() != 1 or y.dim() != 1:
        raise ValueError(f"{op} takes 1-D arrays")
    reverse = False
    if op == "correlate":
        if y.is_complex():
            y = y.conj_physical()
        if x.shape[0] < y.shape[0]:
            x, y, reverse = y, x, True
    else:
        if x.shape[0] < y.shape[0]:
            x, y = y, x
        y = y.flip(0)
    m = y.shape[0]
    pads = {"valid": (0, 0), "same": (m // 2, m - m // 2 - 1),
            "full": (m - 1, m - 1)}[mode]
    out = _xcorr(F.pad(x, pads), y)
    return out.flip(0) if reverse else out


@register("convolve")
def convolve(a, v, mode="full"):
    return _conv(a, v, mode, "convolve")


@register("correlate")
def correlate(a, v, mode="valid"):
    return _conv(a, v, mode, "correlate")


# --- searching / sorting -----------------------------------------------------
@register("searchsorted", differentiable=False)
def searchsorted(a, v, side="left"):
    a, v = _promote(a, v)
    return torch.searchsorted(a, v.contiguous(),
                              side=side).to(torch.int32)


@register("digitize", differentiable=False)
def digitize(x, bins, right=False):
    """jnp's rule: ``searchsorted`` on rising bins, counted from the end
    on falling ones."""
    if bins.shape[0] == 0:
        return torch.zeros_like(x, dtype=torch.int32)
    side = "left" if right else "right"
    rising = searchsorted(bins, x, side)
    falling = bins.shape[0] - searchsorted(bins.flip(0), x, side)
    return torch.where(bins[-1] >= bins[0], rising, falling).to(torch.int32)


@register("lexsort", differentiable=False)
def lexsort(keys, axis=-1):
    """Indices sorting by the last key, ties by the key before it, and so
    on, then by position: stable sorts from the first key to the last."""
    idx = None
    for i in range(keys.shape[0]):
        key = keys[i] if idx is None else torch.take_along_dim(keys[i], idx,
                                                               dim=axis)
        order = torch.sort(key, dim=axis, stable=True).indices
        idx = order if idx is None else torch.take_along_dim(idx, order,
                                                             dim=axis)
    return idx.to(torch.int32)


def _bottom(x, kth):
    """Positions of the ``kth + 1`` smallest along the last axis, ascending,
    ties by position (jnp's ``top_k`` of the negated array)."""
    return torch.sort(x, dim=-1, stable=True).indices[..., :kth + 1]


@register("partition_op", aliases=("np_partition",), differentiable=False)
def partition_op(x, kth=0, axis=-1):
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    bottom = torch.take_along_dim(x, _bottom(x, kth), dim=-1)
    top = torch.sort(x, dim=-1, descending=True,
                     stable=True).values[..., :n - kth - 1]
    return torch.movedim(torch.cat([bottom, top], -1), -1, axis)


@register("argpartition", differentiable=False)
def argpartition(x, kth=0, axis=-1):
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    bottom = _bottom(x, kth)
    rest = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    rest.scatter_(-1, bottom, 0)
    top = torch.sort(rest, dim=-1, descending=True,
                     stable=True).indices[..., :n - kth - 1]
    out = torch.cat([bottom, top], -1).to(torch.int32)
    return torch.movedim(out, -1, axis)


# --- dynamic-shape ops (computed on the operand's device) --------------------
@register("unique", differentiable=False)
def unique(x, return_index=False, return_inverse=False,
           return_counts=False):
    """numpy's ``unique`` of the flattened array; ``return_index`` the
    first position of each value (a scatter of the smallest position over
    the inverse), ``return_inverse`` in the input's shape."""
    _dynamic("unique", x)
    flat = x.reshape(-1)
    uniq, inverse, counts = torch.unique(flat, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    out = [uniq]
    if return_index:
        pos = torch.arange(flat.shape[0], device=x.device)
        first = torch.full((uniq.shape[0],), flat.shape[0], dtype=pos.dtype,
                           device=x.device)
        out.append(first.scatter_reduce(0, inverse, pos, "amin"))
    if return_inverse:
        out.append(inverse.reshape(x.shape))
    if return_counts:
        out.append(counts)
    out = [out[0]] + [t.to(torch.int32) for t in out[1:]]
    return tuple(out) if len(out) > 1 else out[0]


@register("nonzero", differentiable=False)
def nonzero(x):
    """numpy's tuple of index arrays, one a dimension."""
    _dynamic("nonzero", x)
    return tuple(t.to(torch.int32) for t in torch.nonzero(x, as_tuple=True))


@register("flatnonzero", differentiable=False)
def flatnonzero(x):
    _dynamic("flatnonzero", x)
    return torch.nonzero(x.reshape(-1)).reshape(-1).to(torch.int32)


@register("argwhere", differentiable=False)
def argwhere(x):
    _dynamic("argwhere", x)
    return torch.argwhere(x).to(torch.int32)


@register("bincount", differentiable=False)
def bincount(x, weights=None, minlength=0):
    _dynamic("bincount", x)
    if weights is not None and not weights.is_floating_point():
        weights = weights.double()
    return torch.bincount(x.reshape(-1).long(), weights=weights,
                          minlength=minlength)


def spaced(start, stop, num, endpoint=True, dtype=torch.float64,
           device=None):
    """numpy's ``linspace`` in ``dtype`` on ``device``: ``i * step +
    start``, the last value ``stop`` where ``endpoint`` (``histogram``'s
    edges and ``mx.np``'s creators)."""
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    y = torch.arange(num, dtype=dtype, device=device)
    if num > 0:
        div = (num - 1) if endpoint else num
        y = y * ((stop - start) / max(div, 1)) + start
        if endpoint and num > 1:
            y[-1] = stop
    return y


@register("histogram", differentiable=False)
def histogram(x, bins=10, range=None):  # noqa: A002 (numpy's name)
    """numpy's ``histogram``: ``(counts, bin_edges)``. The last bin is
    closed; with a bin count, each value's bin is estimated from the
    scale, then corrected against the edges, as numpy does; values outside
    ``range`` are dropped."""
    _dynamic("histogram", x)
    a = x.reshape(-1)
    dt = a.dtype if a.is_floating_point() else torch.float64
    if isinstance(bins, torch.Tensor):
        edges = bins
        sa = torch.sort(a.to(torch.promote_types(a.dtype, edges.dtype))
                        ).values
        e = edges.to(sa.dtype)
        cum = torch.cat([torch.searchsorted(sa, e[:-1], side="left"),
                         torch.searchsorted(sa, e[-1:], side="right")])
        return torch.diff(cum).to(torch.int32), edges
    if range is None:
        first, last = a.min().to(dt), a.max().to(dt)
        if bool(first == last):
            first, last = first - 0.5, last + 0.5
        edges = spaced(first, last, bins + 1, dtype=dt, device=a.device)
    else:
        first, last = (float(v) for v in range)
        if first == last:
            first, last = first - 0.5, last + 0.5
        # python floats: numpy spaces them in float64, then casts
        edges = spaced(first, last, bins + 1, device=a.device).to(dt)
    v = a.to(dt)
    first_t, last_t = edges[0], edges[-1]
    if range is not None:
        v = v[(v >= float(range[0])) & (v <= float(range[1]))]
    idx = ((v - first_t) / (last_t - first_t) * bins).long()
    idx = torch.where(idx == bins, idx - 1, idx).clamp(0, bins - 1)
    idx = torch.where(v < edges[idx], idx - 1, idx)
    idx = torch.where((v >= edges[(idx + 1).clamp(max=bins)])
                      & (idx != bins - 1), idx + 1, idx)
    counts = torch.bincount(idx.clamp(0, bins - 1), minlength=bins)
    return counts.to(torch.int32), edges


@register("setdiff1d", differentiable=False)
def setdiff1d(a, b):
    _dynamic("setdiff1d", a, b)
    a, b = _promote(a, b)
    ua = torch.unique(a.reshape(-1), sorted=True)
    return ua[~torch.isin(ua, b.reshape(-1))]


@register("intersect1d", differentiable=False)
def intersect1d(a, b):
    _dynamic("intersect1d", a, b)
    a, b = _promote(a, b)
    ua = torch.unique(a.reshape(-1), sorted=True)
    return ua[torch.isin(ua, b.reshape(-1))]


@register("union1d", differentiable=False)
def union1d(a, b):
    _dynamic("union1d", a, b)
    a, b = _promote(a, b)
    return torch.unique(torch.cat([a.reshape(-1), b.reshape(-1)]),
                        sorted=True)


@register("isin", differentiable=False)
def isin(x, test_elements):
    x, t = _promote(x, test_elements)
    return torch.isin(x, t)


@register("interp")
def interp(x, xp, fp):
    """jnp's ``interp``: the segment right of ``x`` by ``searchsorted``,
    ``fp[0]``/``fp[-1]`` outside ``xp``."""
    x, xp, fp = _inexact(x, xp, fp)
    i = torch.searchsorted(xp, x.contiguous(), side="right").clamp(
        1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # numpy's spacing(eps): eps is a power of two, 2**-m, so its spacing
    # is 2**-2m
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@register("clip_by_global_norm")
def clip_by_global_norm(*arrays, max_norm=1.0):
    """Every array scaled by ``min(1, max_norm / global_norm)`` (gluon's
    ``clip_global_norm`` as an op); one output an input."""
    total = torch.sqrt(sum(torch.sum(torch.square(a.float()))
                           for a in arrays))
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    out = tuple(a * scale.to(a.dtype) for a in arrays)
    return out if len(out) > 1 else out[0]


# --- legacy-spelling activation completions ---------------------------------
@register("relu6")
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@register("hard_swish", aliases=("hardswish",))
def hard_swish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


# --- second numpy completion wave -------------------------------------------
@register("take_along_axis")
def take_along_axis(a, indices, axis=-1):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return take_along(a, indices.to(torch.int32), axis)


@register("put_along_axis", differentiable=False)
def put_along_axis(a, indices, values, axis=-1):
    """A copy of ``a`` with ``values`` written at ``indices`` along
    ``axis`` (an index in ``[-n, -1]`` counts from the end; one outside
    ``[-n, n)`` writes nothing, as jnp's ``.at[].set``)."""
    n = a.shape[axis]
    idx, outside = wrap_index(indices, n)
    values = values.to(a.dtype).expand(idx.shape)
    out = a.clone()
    cur = torch.take_along_dim(out, idx, dim=axis)
    return out.scatter(axis, idx, torch.where(outside, cur, values))


@register("select")
def select(condlist, choicelist, default=0.0):
    """The first choice whose condition holds (conditions and choices
    stacked on a leading axis), else ``default``."""
    if isinstance(default, float) and not (choicelist.is_floating_point()
                                           or choicelist.is_complex()):
        choicelist = choicelist.float()
    out = torch.full_like(choicelist[0], default)
    for i in reversed(range(condlist.shape[0])):
        out = torch.where(condlist[i].to(torch.bool), choicelist[i], out)
    return out


@register("compress_op", aliases=("np_compress",), differentiable=False)
def compress_op(condition, a, axis=None):
    _dynamic("compress", condition, a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    keep = torch.nonzero(condition.reshape(-1).to(torch.bool)).reshape(-1)
    return torch.index_select(a, axis, keep)


@register("extract", differentiable=False)
def extract(condition, a):
    _dynamic("extract", condition, a)
    return a.reshape(-1)[condition.reshape(-1).to(torch.bool)]


def _cov(x, rowvar=True, ddof=None):
    """jnp's ``cov`` without weights."""
    x = _float(torch.atleast_2d(x))
    if not rowvar and x.shape[0] != 1:
        x = x.T
    ddof = 1 if ddof is None else ddof
    f = x.shape[1] - ddof
    x = x - torch.mean(x, dim=1, keepdim=True)
    return (torch.matmul(x, x.T.conj()) / f).squeeze()


@register("cov")
def cov(x, rowvar=True, ddof=None):
    return _cov(x, rowvar, ddof)


@register("corrcoef")
def corrcoef(x, rowvar=True):
    c = _cov(x, rowvar)
    if c.dim() == 0:
        return c / c
    sd = torch.sqrt(torch.diagonal(c).real).to(c.dtype)
    c = c / sd[:, None] / sd[None, :]
    return torch.clamp(c, -1.0, 1.0)


@register("nanmedian")
def nanmedian(x, axis=None, keepdims=False):
    return _quantile(x, 0.5, axis, keepdims, "midpoint", True)


@register("nanquantile")
def nanquantile(x, q=0.5, axis=None, keepdims=False):
    return _quantile(x, q, axis, keepdims, "linear", True)


@register("nanpercentile")
def nanpercentile(x, q=50.0, axis=None, keepdims=False):
    return _quantile(x, _percent(q, x), axis, keepdims, "linear", True)


@register("unwrap")
def unwrap(x, axis=-1):
    """jnp's ``unwrap`` with period 2 pi: each jump of more than pi
    corrected by a multiple of 2 pi."""
    p = _float(x)
    interval, period = math.pi, 2 * math.pi
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    correct = torch.where(torch.abs(dd) < interval, torch.zeros_like(dd),
                          ddmod - dd)
    n = p.shape[axis]
    return torch.cat([p.narrow(axis, 0, 1),
                      p.narrow(axis, 1, n - 1)
                      + torch.cumsum(correct, dim=axis)], dim=axis)


def _gradient_along(a, axis):
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1),
                      (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2))
                      * 0.5,
                      a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)],
                     dim=axis)


@register("gradient_op", aliases=("np_gradient",))
def gradient_op(x, axis=None):
    """jnp's ``gradient`` at unit spacing: one-sided at the ends, central
    inside; a tuple over several axes."""
    x = _float(x)
    axes = _axes(x, axis)
    out = tuple(_gradient_along(x, a) for a in axes)
    return out[0] if len(out) == 1 else out


@register("fmax")
def fmax(a, b):
    a, b = _promote(a, b)
    if not a.is_floating_point():
        return torch.maximum(a, b)
    return torch.where((a > b) | torch.isnan(b), a, b)


@register("fmin")
def fmin(a, b):
    a, b = _promote(a, b)
    if not a.is_floating_point():
        return torch.minimum(a, b)
    return torch.where((a < b) | torch.isnan(b), a, b)


_BITS_BIG = (7, 6, 5, 4, 3, 2, 1, 0)


@register("packbits", differentiable=False)
def packbits(x, axis=None):
    """Big-endian bits of ``x > 0`` (after a uint8 cast) packed 8 to a
    byte along ``axis`` (the flattened array if None), zero-padded."""
    bits = (x.to(torch.uint8) > 0).to(torch.uint8)
    if axis is None:
        bits, axis = bits.reshape(-1), 0
    bits = torch.movedim(bits, axis, -1)
    rem = bits.shape[-1] % 8
    if rem:
        bits = F.pad(bits, (0, 8 - rem))
    bits = bits.reshape(bits.shape[:-1] + (-1, 8))
    shifts = torch.tensor(_BITS_BIG, dtype=torch.uint8, device=x.device)
    packed = torch.bitwise_left_shift(bits, shifts).sum(-1).to(torch.uint8)
    return torch.movedim(packed, -1, axis)


@register("unpackbits", differentiable=False)
def unpackbits(x, axis=None, count=None):
    x = x.to(torch.uint8)
    if axis is None:
        x, axis = x.reshape(-1), 0
    x = torch.movedim(x, axis, -1)
    masks = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.uint8, device=x.device),
        torch.tensor(_BITS_BIG, dtype=torch.uint8, device=x.device))
    bits = (torch.bitwise_and(x.unsqueeze(-1), masks) > 0).to(torch.uint8)
    bits = bits.reshape(bits.shape[:-2] + (-1,))
    if count is not None:
        if count > bits.shape[-1]:
            bits = F.pad(bits, (0, count - bits.shape[-1]))
        else:
            bits = bits[..., :count]
    return torch.movedim(bits, -1, axis)
