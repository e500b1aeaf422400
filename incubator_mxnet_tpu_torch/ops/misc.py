"""Misc ops: unary stragglers, index helpers, the loss outputs, resizing,
the spatial transformer family and the ROI ops.

Counterpart of the JAX package's ``ops/misc.py`` (the reference's
``indexing_op.cc`` batch_take and ravel ops, ``regression_output.cc``,
``make_loss.cc``, ``upsampling.cc``, ``bilinear_resize.cc``,
``grid_generator.cc``, ``bilinear_sampler.cc``, ``spatial_transformer.cc``,
``roi_pooling.cc`` and ``roi_align.cc``), and the legacy names of its
``ops/more.py`` alias block. None is a TPU kernel there (XLA compiles
them), so each is plain PyTorch here, written as the reference computes it:
the samplers are its gathers and weights (no ``F.grid_sample``), the ROI
ops its masks and samples (no torchvision).

The loss outputs (``LinearRegressionOutput``, ``MAERegressionOutput``,
``LogisticRegressionOutput``, ``MakeLoss``) are loss ops: their backward is
the loss's gradient, whatever the head gradient, and the label gets none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nn as _nn  # noqa: F401  (registers the alias block's targets)
from .registry import get, register
from .tensor import take_along


# -- unary stragglers --------------------------------------------------------
register("degrees")(torch.rad2deg)
register("radians")(torch.deg2rad)
# half to even, as jnp.round (MXNet's own round goes half away from zero)
register("round")(torch.round)
register("erfc")(torch.erfc)
register("log_sigmoid")(F.logsigmoid)


@register("logical_not")
def logical_not(x):
    """1 where ``x`` is 0, in ``x``'s type for a float, else float32."""
    return (x == 0).to(x.dtype if x.is_floating_point() else torch.float32)


@register("moments")
def moments(x, axes=None, keepdims=False):
    """``(mean, var)`` over ``axes`` (None: every axis), population
    variance."""
    dims = tuple(range(x.dim())) if axes is None else tuple(axes)
    return (x.mean(dim=dims, keepdim=keepdims),
            x.var(dim=dims, unbiased=False, keepdim=keepdims))


# -- indexing ----------------------------------------------------------------
@register("batch_take")
def batch_take(x, indices):
    """``out[i] = x[i, indices[i]]``."""
    return take_along(x, indices.reshape(-1, 1), 1)[:, 0]


def _strides(shape):
    out, s = [], 1
    for d in reversed(shape):
        out.append(s)
        s *= d
    return out[::-1]


@register("ravel_multi_index", differentiable=False)
def ravel_multi_index(data, shape=None):
    """Coordinates ``data`` (ndim, N) -> flat indices (N,), in ``data``'s
    type."""
    strides = torch.tensor(_strides(shape), dtype=data.dtype,
                           device=data.device)
    return (data * strides[:, None]).sum(0)


@register("unravel_index", differentiable=False)
def unravel_index(data, shape=None):
    """Flat indices (N,) -> coordinates (ndim, N), in ``data``'s type."""
    rem = data.to(torch.int32)
    return torch.stack([torch.remainder(torch.div(rem, st,
                                                  rounding_mode="floor"), d)
                        for st, d in zip(_strides(shape), shape)]
                       ).to(data.dtype)


@register("index_array", differentiable=False)
def index_array(data, axes=None):
    """Each element's coordinates along ``axes`` (None: every axis), on a
    last axis, int32."""
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in data.shape], indexing="ij")
    axes = range(data.dim()) if axes is None else axes
    return torch.stack([grids[a] for a in axes], dim=-1).to(torch.int32)


# -- loss outputs ------------------------------------------------------------
class _RegressionOutput(torch.autograd.Function):
    """Forward ``data`` (``sigmoid(data)`` for the logistic one); backward
    ``(out - label) * grad_scale`` (``sign(out - label)`` for MAE)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.opts = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.opts
        diff = out - label.reshape(out.shape).to(out.dtype)
        grad = torch.sign(diff) if kind == "mae" else diff
        return grad * grad_scale, None, None, None


def _regression_output(kind):
    def op(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, float(grad_scale), kind)
    return op


for _name, _alias, _kind in [
        ("LinearRegressionOutput", "linear_regression_output", "linear"),
        ("MAERegressionOutput", "mae_regression_output", "mae"),
        ("LogisticRegressionOutput", "logistic_regression_output",
         "logistic")]:
    register(_name, aliases=(_alias,))(_regression_output(_kind))


class _MakeLoss(torch.autograd.Function):
    """Forward ``data``; backward ``grad_scale`` everywhere, divided by the
    batch (``"batch"``) or by the count of elements above ``valid_thresh``
    (``"valid"``)."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(data)
        ctx.opts = (grad_scale, normalization, valid_thresh)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.opts
        scale = torch.tensor(grad_scale, dtype=torch.float32,
                             device=data.device)
        if normalization == "batch":
            scale = scale / data.shape[0]
        elif normalization == "valid":
            scale = scale / (data > valid_thresh).sum().clamp(min=1)
        return torch.ones_like(g) * scale.to(g.dtype), None, None, None


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, normalization="null", valid_thresh=0.0):
    """The head of a custom loss (reference ``MakeLoss``): forward the
    identity; backward ``grad_scale`` with ``normalization`` "null",
    "batch" or "valid" (``valid_thresh``), as the JAX package's
    ``ops/misc.py`` (its ``mx.nd.MakeLoss`` resolves to ``ops/more.py``'s
    ``make_loss``, which reads ``grad_scale`` alone)."""
    return _MakeLoss.apply(data, float(grad_scale), str(normalization),
                           float(valid_thresh))


# -- resize / upsampling (NCHW) ----------------------------------------------
@register("UpSampling", aliases=("upsampling",))
def upsampling(x, scale=2, sample_type="nearest", num_filter=0):
    """Nearest: each pixel repeated ``scale`` times on both axes; else the
    bilinear resize to ``scale`` times the size."""
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                  dim=3)
    return bilinear_resize2d(x, height=x.shape[2] * scale,
                             width=x.shape[3] * scale)


@register("BilinearResize2D", aliases=("bilinear_resize_2d",))
def bilinear_resize2d(x, height=None, width=None, scale_height=None,
                      scale_width=None, align_corners=True):
    """Bilinear resize to ``height`` x ``width`` (or the scaled size);
    ``align_corners`` maps the corner pixels onto each other, else pixel
    centres onto pixel centres."""
    h, w = x.shape[2], x.shape[3]
    oh = height if height is not None else int(h * scale_height)
    ow = width if width is not None else int(w * scale_width)
    opts = dict(dtype=torch.float32, device=x.device)
    if align_corners and oh > 1 and ow > 1:
        ys = torch.linspace(0.0, h - 1.0, oh, **opts)
        xs = torch.linspace(0.0, w - 1.0, ow, **opts)
    else:
        ys = _exact_div((torch.arange(oh, **opts) + 0.5) * h, oh) - 0.5
        xs = _exact_div((torch.arange(ow, **opts) + 0.5) * w, ow) - 0.5
    y0, y1, wy = _corners(ys, h, x.dtype)
    x0, x1, wx = _corners(xs, w, x.dtype)
    top = x[:, :, y0, :] * (1 - wy)[:, None] + x[:, :, y1, :] * wy[:, None]
    return top[:, :, :, x0] * (1 - wx) + top[:, :, :, x1] * wx


def _exact_div(a, n):
    """``a / n`` correctly rounded on every device: on the card PyTorch
    multiplies by the reciprocal of a Python number, which can move a
    sample position across the integer that ``floor`` reads."""
    return a / torch.full_like(a, n)


def _corners(pos, n, dtype):
    """The two neighbours of each sample position on an axis of ``n``
    (clamped into it) and the far one's weight."""
    lo = pos.floor().clamp(0, n - 1).long()
    return lo, (lo + 1).clamp(max=n - 1), (pos - lo).clamp(0.0, 1.0).to(dtype)


# -- spatial transformer family ----------------------------------------------
def _base_grid(h, w, device):
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """Sampling grids (N, 2, H, W) of (x, y) in [-1, 1]: ``"affine"`` maps
    the identity grid of ``target_shape`` by ``data`` (N, 6); ``"warp"``
    adds the flow ``data`` (N, 2, H, W), in pixels, to the identity
    grid."""
    if transform_type == "affine":
        th, tw = target_shape
        gy, gx = _base_grid(th, tw, data.device)
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones(th * tw, device=data.device)])
        theta = data.reshape(data.shape[0], 2, 3)
        return torch.matmul(theta, base.to(data.dtype)).reshape(
            data.shape[0], 2, th, tw)
    h, w = data.shape[2], data.shape[3]
    gy, gx = _base_grid(h, w, data.device)
    fx = data[:, 0] * 2.0 / max(w - 1, 1)
    fy = data[:, 1] * 2.0 / max(h - 1, 1)
    return torch.stack([gx + fx, gy + fy], dim=1)


@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, cudnn_off=None):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, OH, OW) of (x, y)
    in [-1, 1], the corners at the corner pixels; a neighbour outside the
    image reads 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = gx.floor().long(), gy.floor().long()
    wx, wy = (gx - x0).to(data.dtype), (gy - y0).to(data.dtype)
    flat = data.reshape(n, c, h * w)

    def at(yi, xi):
        inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                  & (yi <= h - 1)).to(data.dtype)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        return vals.reshape(n, c, *xi.shape[1:]) * inside[:, None]

    wx, wy = wx[:, None], wy[:, None]
    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x0 + 1) * wx * (1 - wy)
            + at(y0 + 1, x0) * (1 - wx) * wy + at(y0 + 1, x0 + 1) * wx * wy)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):
    """``GridGenerator`` (affine, by ``loc``) then ``BilinearSampler``."""
    return bilinear_sampler(data, grid_generator(
        loc, transform_type="affine", target_shape=target_shape))


# -- ROI ops: rois (R, 5) rows [batch index, x1, y1, x2, y2] -----------------
def _roi_images(data, rois):
    """Each ROI's image (R, C, H, W); the batch index clamped into range,
    as jnp's gather."""
    return data[rois[:, 0].long().clamp(0, data.shape[0] - 1)]


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """The max of each of ``pooled_size`` cells of each ROI (its corners
    scaled and rounded half to even, as ``jnp.round``); an empty cell
    gives 0. Each cell's max is the max over its rows of the max over its
    columns."""
    ph, pw = pooled_size
    h, w = data.shape[2], data.shape[3]
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      for i in range(1, 5))

    def cells(lo, hi, n, parts):
        """(R, parts, n): which positions each cell of an axis covers."""
        size = _exact_div(torch.clamp(hi - lo + 1.0, min=1.0), parts)
        k = torch.arange(parts, device=data.device, dtype=lo.dtype)
        start = torch.floor(lo[:, None] + k * size[:, None])
        end = torch.ceil(lo[:, None] + (k + 1) * size[:, None])
        pos = torch.arange(n, device=data.device, dtype=lo.dtype)
        return (pos >= start[..., None]) & (
            pos < torch.maximum(end, start + 1)[..., None])

    my, mx = cells(y1, y2, h, ph), cells(x1, x2, w, pw)
    img = _roi_images(data, rois)[:, :, :, None, :]       # (R, C, H, 1, W)
    cols = img.masked_fill(~mx[:, None, None], float("-inf")).amax(-1)
    rows = cols[:, :, None].masked_fill(                  # (R, C, ph, H, pw)
        ~my[:, None, :, :, None], float("-inf")).amax(3)
    some = my.any(-1)[:, :, None] & mx.any(-1)[:, None, :]
    return rows.masked_fill(~some[:, None], 0.0)


@register("ROIAlign", aliases=("roi_align",))
def roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """The mean of ``sample_ratio`` x ``sample_ratio`` bilinear samples in
    each of ``pooled_size`` cells of each ROI (no rounding; ``aligned``
    shifts by half a pixel)."""
    ph, pw = pooled_size
    sr = max(1, int(sample_ratio))
    c, h, w = data.shape[1:]
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - offset
                      for i in range(1, 5))
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)

    def samples(lo, extent, parts):
        steps = _exact_div(torch.arange(parts * sr, device=data.device,
                                        dtype=lo.dtype) + 0.5, sr)
        return lo[:, None] + steps * _exact_div(extent, parts)[:, None]

    y0, y1i, wy = _corners(samples(y1, rh, ph), h, data.dtype)
    x0, x1i, wx = _corners(samples(x1, rw, pw), w, data.dtype)
    img = _roi_images(data, rois)                          # (R, C, H, W)
    r, sy, sx = rois.shape[0], y0.shape[1], x0.shape[1]

    def rows_at(iy):
        return torch.gather(img, 2, iy[:, None, :, None].expand(r, c, sy, w))

    top = rows_at(y0) * (1 - wy)[:, None, :, None] \
        + rows_at(y1i) * wy[:, None, :, None]              # (R, C, sy, W)

    def cols_at(ix):
        return torch.gather(top, 3, ix[:, None, None, :].expand(r, c, sy,
                                                                sx))

    samp = cols_at(x0) * (1 - wx)[:, None, None, :] \
        + cols_at(x1i) * wx[:, None, None, :]
    return samp.reshape(r, c, ph, sr, pw, sr).mean(dim=(3, 5))


# -- the legacy names of the reference's ops/more.py alias block, each its
#    own registered op (ElementWiseSum -> add_n waits for ops/more.py)
for _alias, _target in [("BatchNorm_v1", "BatchNorm"),
                        ("Convolution_v1", "Convolution"),
                        ("Pooling_v1", "Pooling"),
                        ("Softmax", "SoftmaxOutput"),
                        ("broadcast_minus", "broadcast_sub"),
                        ("broadcast_plus", "broadcast_add"),
                        ("SparseEmbedding", "Embedding"),
                        ("contrib_SparseEmbedding", "Embedding")]:
    register(_alias, differentiable=get(_target).differentiable)(
        get(_target).fn)
