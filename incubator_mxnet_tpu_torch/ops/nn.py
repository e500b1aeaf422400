"""Neural-network ops.

Counterparts of the JAX package's ``ops/nn.py``: the dense and conv ops
(``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``adaptive_avg_pool2d``), the norms (``BatchNorm``, ``LayerNorm``,
``InstanceNorm``, ``GroupNorm``, ``RMSNorm``, ``L2Normalization``), the
activations (``Activation`` and each one by name, ``LeakyReLU``), the
softmax family and its losses (``softmax`` with ``length``,
``log_softmax``, ``softmax_cross_entropy``, ``SoftmaxOutput``),
``Dropout``, ``Embedding`` and ``scaled_dot_product_attention``. None of
them is a TPU kernel there (XLA compiles them), so here they are
PyTorch's own (cuDNN and cuBLAS on the card). Layouts as the reference's:
NC + 1-3 spatial axes, conv weights (O, I/groups, *k), transposed-conv
weights (I, O/groups, *k).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .registry import register
from .tensor import gather_fill, positions_along, take_along, wrap_index

__all__ = ["activation", "adaptive_avg_pool2d", "batch_norm", "convolution",
           "deconvolution", "dropout", "embedding", "fully_connected",
           "gelu", "group_norm", "hard_sigmoid", "instance_norm",
           "l2_normalization", "layer_norm", "leaky_relu", "log_softmax",
           "mish", "pooling", "relu", "rms_norm",
           "scaled_dot_product_attention", "sigmoid", "silu", "softmax",
           "softmax_cross_entropy", "softmax_output", "softrelu",
           "softsign"]


def _ntuple(v, n):
    """``v`` as an ``n``-tuple of ints (a scalar repeated)."""
    if isinstance(v, (tuple, list)):
        t = tuple(int(x) for x in v)
        if len(t) != n:
            raise ValueError(
                f"expected a scalar or length-{n} tuple, got {v!r}")
        return t
    return (int(v),) * n


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x·Wᵀ + b with weight (units, in_units), as the reference's
    FullyConnected; ``flatten`` folds every axis after the first into
    the input features. ``num_hidden`` is the reference's attribute (the
    weight gives the width); ``no_bias`` drops ``bias``."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, None if no_bias else bias)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("softmax")
def softmax(x, axis=-1, temperature=None, length=None):
    """Softmax along ``axis``; ``length`` (one per row of axis 0) gives
    the positions at or past a row's length probability 0."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        keep = positions_along(x, axis) < length.reshape(
            [x.shape[0]] + [1] * (x.dim() - 1))
        x = x.masked_fill(~keep, float("-inf"))
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(logits, label):
    """The summed cross entropy of integer ``label`` (a label out of range
    reads NaN, as ``jnp.take_along_axis``)."""
    lp = torch.log_softmax(logits, dim=-1)
    return -take_along(lp, label.long().unsqueeze(-1), -1).sum()


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward the cross entropy's gradient ``(p -
    onehot(label)) * grad_scale`` with the head gradient taken as ones (the
    reference's loss op), ``ignore_label`` rows zeroed when ``use_ignore``,
    divided by the batch (``"batch"``) or the count of rows kept
    (``"valid"``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                axis, normalization):
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.opts = (grad_scale, ignore_label, use_ignore, axis,
                    normalization)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, axis, normalization = ctx.opts
        lab = label.long().unsqueeze(axis)
        grad = p - (lab == positions_along(p, axis)).to(p.dtype)
        valid = lab != ignore_label
        if use_ignore:
            grad = grad * valid.to(p.dtype)
        if normalization == "batch":
            grad = grad / p.shape[0]
        elif normalization == "valid":
            n = valid.sum().clamp(min=1) if use_ignore else label.numel()
            grad = grad / n
        return grad * grad_scale, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1,
                   use_ignore=False, multi_output=False,
                   normalization="null"):
    """Output layer with an implicit cross-entropy loss (reference
    ``SoftmaxOutput``): forward ``softmax(data)`` over the classes (axis 1
    with ``multi_output``, else the last); backward the loss's gradient,
    whatever the head gradient. ``label`` gets no gradient."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                int(ignore_label), bool(use_ignore),
                                1 if multi_output else -1,
                                str(normalization))


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Layer norm over ``axis``, population variance."""
    if axis % x.dim() != x.dim() - 1:
        return layer_norm(x.movedim(axis, -1), gamma, beta, -1,
                          eps).movedim(-1, axis)
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


@register("InstanceNorm", aliases=("instance_norm",))
def instance_norm(x, gamma, beta, eps=1e-3):
    """Each (sample, channel) normalized over its spatial axes."""
    return F.instance_norm(x, weight=gamma, bias=beta, eps=eps)


@register("GroupNorm", aliases=("group_norm",))
def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """Each group of ``C / num_groups`` consecutive channels of a sample
    normalized together."""
    return F.group_norm(x, num_groups, gamma, beta, eps)


@register("RMSNorm", aliases=("rms_norm",))
def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """``x / sqrt(mean(x**2) + eps) * gamma``, the mean over ``axis`` in
    fp32."""
    ms = x.float().square().mean(dim=axis, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype) * gamma


@register("L2Normalization", aliases=("l2_normalization",))
def l2_normalization(x, eps=1e-10, mode="instance"):
    """``x`` over the L2 norm of each sample (``"instance"``), of each
    position's channels (``"channel"``) or of each channel's spatial plane
    (``"spatial"``)."""
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.dim()))
    return x / torch.sqrt(x.square().sum(dim=axes, keepdim=True) + eps)


@register("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size=1):
    """The mean of each of ``output_size`` equal windows (H and W must
    divide by it, as in the reference)."""
    oh, ow = _ntuple(output_size, 2)
    n, c, h, w = x.shape
    return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


@register("Embedding", aliases=("embedding",))
def embedding(indices, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Rows of ``weight`` at ``indices`` (truncated to integers), as
    ``jnp.take(weight, indices, axis=0)``: an index in ``[-n, -1]`` counts
    from the end, a row outside ``[-n, n)`` is NaN (a padding id of -1
    reads the last row, and no index leaves the table). ``input_dim``,
    ``output_dim``, ``dtype`` and ``sparse_grad`` are the reference's
    attributes (the weight gives them; the gradient is dense)."""
    idx, outside = wrap_index(indices, weight.shape[0])
    return F.embedding(idx, weight).masked_fill(outside.unsqueeze(-1),
                                                gather_fill(weight.dtype))


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation, and the reference's
    # Activation("gelu") takes that default
    return F.gelu(x, approximate="tanh")


@register("softsign")
def softsign(x):
    return x / (1 + x.abs())


@register("softrelu", aliases=("softplus",))
def softrelu(x):
    return F.softplus(x)


@register("gelu")
def gelu(x, approximate=True):
    """``approximate``: the tanh form (``jax.nn.gelu``'s default), else
    the exact erf form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register("silu", aliases=("swish",))
def silu(x):
    return F.silu(x)


@register("mish")
def mish(x):
    return x * torch.tanh(F.softplus(x))


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("LeakyReLU", aliases=("leaky_relu",))
def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """Reference ``LeakyReLU``: ``leaky`` (``slope``), ``prelu`` (the
    learned ``gamma``, one a channel on axis 1), ``elu`` (``slope``),
    ``selu``, and ``gelu``, the exact erf form here (unlike ``gelu`` and
    ``Activation("gelu")``). ``lower_bound``/``upper_bound`` belong to
    ``rrelu``, which the reference does not take either."""
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        if gamma.dim() == 1 and x.dim() > 2:
            gamma = gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x > 0, x, gamma * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        return F.selu(x)
    if act_type == "gelu":
        return F.gelu(x)
    raise ValueError(f"unknown LeakyReLU act_type {act_type!r}")


_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": F.softplus, "softsign": softsign, "gelu": _gelu,
         "silu": F.silu, "log_sigmoid": F.logsigmoid, "mish": mish}


@register("Activation", aliases=("activation",))
def activation(x, act_type="relu"):
    """Reference ``Activation(act_type=...)``: relu, sigmoid, tanh,
    softrelu, softsign, gelu (tanh approximation), silu, log_sigmoid,
    mish."""
    if act_type not in _ACTS:
        raise ValueError(f"unknown act_type {act_type!r}; known "
                         f"{sorted(_ACTS)}")
    return _ACTS[act_type](x)


@register("Dropout", aliases=("dropout",))
def dropout(x, p=0.5, mode="training", axes=(), training=True,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout (reference ``Dropout``); the identity unless
    ``training``. One mask value is drawn for every position along
    ``axes`` (the mask broadcast along them). The mask is drawn from
    ``generator`` (the device's ``random.generator`` by default).
    ``mode`` is the reference's attribute, which it does not read
    either."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        from .. import random as _random
        from ..device import Context

        ctx = Context("cpu") if x.device.type == "cpu" else \
            Context("gpu", x.device.index or 0)
        generator = _random.generator(ctx)
    shape = list(x.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(x, weight, bias=None, kernel=None, stride=1, pad=0,
                dilate=1, num_filter=None, num_group=1, no_bias=False,
                layout="NCHW"):
    """Reference ``Convolution``: NC + 1-3 spatial axes in and out, weight
    (O, I/num_group, *k), zero padding ``pad`` on both sides of each
    spatial axis. ``kernel`` and ``num_filter`` are the reference's
    attributes (the weight gives them)."""
    nsp = x.dim() - 2
    if nsp not in _CONV:
        raise ValueError(f"Convolution takes 1-3 spatial axes, got x of "
                         f"shape {tuple(x.shape)}")
    return _CONV[nsp](x, weight, None if no_bias else bias,
                      _ntuple(stride, nsp), _ntuple(pad, nsp),
                      _ntuple(dilate, nsp), num_group)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(x, weight, bias=None, kernel=None, stride=1, pad=0, adj=0,
                  dilate=1, num_filter=None, num_group=1, no_bias=False):
    """Reference ``Deconvolution`` (transposed convolution): NC + 1-3
    spatial axes, weight (I, O/num_group, *k); each spatial axis of the
    output is ``(n - 1) * stride + dilate * (k - 1) + 1 - 2 * pad + adj``.
    The full transposed convolution is cut by ``pad`` at both ends and
    extended by ``adj`` at the end, so any ``adj`` works (PyTorch's
    ``output_padding`` must stay below the stride)."""
    nsp = x.dim() - 2
    if nsp not in _CONV_T:
        raise ValueError(f"Deconvolution takes 1-3 spatial axes, got x of "
                         f"shape {tuple(x.shape)}")
    pad, adj = _ntuple(pad, nsp), _ntuple(adj, nsp)
    y = _CONV_T[nsp](x, weight, None, _ntuple(stride, nsp), 0, 0, num_group,
                     _ntuple(dilate, nsp))
    y = F.pad(y, [w for p, a in zip(reversed(pad), reversed(adj))
                  for w in (-p, a - p)])
    if bias is not None and not no_bias:
        y = y + bias.reshape((1, -1) + (1,) * nsp)
    return y


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each ``kernel`` window at ``stride``, no padding."""
    if x.dim() == 3:                 # 1-D: as 2-D windows of height 1
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling", aliases=("pooling",))
def pooling(x, kernel=(2, 2), pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True,
            pooling_convention="valid", layout="NCHW"):
    """Reference ``Pooling``: NC + 1-3 spatial axes. ``pool_type`` "max"
    (padding is -inf), "avg" (``count_include_pad`` divides by the window
    size, else by the input elements it covers), "sum" or "lp" (the L2
    norm of the window); ``stride`` defaults to ``kernel``;
    ``global_pool`` reduces every spatial axis to 1 (by the max, or for any
    other type by the mean, as the reference);
    ``pooling_convention="full"`` takes ``ceil`` windows, the last one
    padded at the end, as the reference's. ``layout="NHWC"`` (2-D max
    pooling) takes and returns channels-last tensors without a copy."""
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"layout {layout!r}: NCHW or NHWC")
    if layout == "NHWC":
        x = x.permute(0, 3, 1, 2)
        out = pooling(x, kernel, pool_type, stride, pad, global_pool,
                      count_include_pad, pooling_convention)
        return out.permute(0, 2, 3, 1)
    nsp = x.dim() - 2
    if nsp not in _MAX_POOL:
        raise ValueError(f"Pooling takes 1-3 spatial axes, got x of shape "
                         f"{tuple(x.shape)}")
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    spatial = tuple(range(2, x.dim()))
    if global_pool:                  # the reference's: any but max is a mean
        if pool_type == "max":
            return x.amax(dim=spatial, keepdim=True)
        return x.mean(dim=spatial, keepdim=True)
    kernel = _ntuple(kernel, nsp)
    stride = kernel if stride is None else _ntuple(stride, nsp)
    pad = _ntuple(pad, nsp)
    extra = (0,) * nsp
    if pooling_convention == "full":
        # ceil windows: pad the end of each axis until the last one fits
        extra = tuple(max(0, (-(-(n + 2 * p - k) // s)) * s + k - n - 2 * p)
                      for n, k, s, p in zip(x.shape[2:], kernel, stride,
                                            pad))
    elif pooling_convention != "valid":
        raise ValueError(f"pooling_convention {pooling_convention!r}: "
                         "valid or full")
    inside = not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel))
    if pool_type == "max":
        if inside:                   # torch pads with -inf itself
            return _MAX_POOL[nsp](x, kernel, stride, pad)
        return _MAX_POOL[nsp](_pad(x, pad, extra, float("-inf")), kernel,
                              stride)
    if pool_type == "lp":
        x = x * x
    s = _window_sum(_pad(x, pad, extra, 0.0), kernel, stride)
    if pool_type == "sum":
        return s
    if pool_type == "lp":
        return torch.sqrt(s)
    if count_include_pad:
        return s / math.prod(kernel)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return s / _window_sum(_pad(ones, pad, extra, 0.0), kernel, stride)


def _pad(x, pad, extra, value):
    """``x`` padded by ``pad`` on both sides of each spatial axis and
    ``extra`` more at the end."""
    if not any(pad) and not any(extra):
        return x
    widths = []
    for p, e in zip(reversed(pad), reversed(extra)):
        widths += [p, p + e]
    return F.pad(x, widths, value=value)


@register("BatchNorm", aliases=("batch_norm",))
def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1, training=False):
    """Reference ``BatchNorm``: ``(x - mean) / sqrt(var + eps) * gamma +
    beta`` over every axis but ``axis``. In training (and not
    ``use_global_stats``) the batch's mean and *biased* variance, and the
    result is ``(out, mean, var)`` (fp32 statistics for a 16-bit ``x``)
    for the caller to
    fold into its running statistics (the reference's own update is
    functional; ``momentum`` is the caller's); else the moving statistics
    and ``out`` alone. ``fix_gamma`` takes gamma as ones.

    One call of PyTorch's batch norm (cuDNN or ATen) computes the
    normalization and its gradient. The affine parameters and statistics
    go in as fp32 for a 16-bit ``x``, so a bf16 ``x`` gives a bf16
    ``out``. The returned batch statistics are their own reductions of
    ``x``, so a gradient flows through them too, as through the
    reference's ``jnp.mean``/``jnp.var``."""
    if axis < 0:
        axis += x.dim()
    if axis != 1:
        x = x.movedim(axis, 1)
    # the statistics' type: fp32 for a 16-bit x, else x's own
    st = torch.float32 if x.element_size() < 4 else x.dtype
    g = torch.ones_like(gamma, dtype=st) if fix_gamma else gamma.to(st)
    be = beta.to(st)
    if training and not use_global_stats:
        out = F.batch_norm(x, None, None, g, be, training=True, eps=eps)
        dims = [0] + list(range(2, x.dim()))
        stats = (x.to(st).mean(dims), x.to(st).var(dims, unbiased=False))
    else:
        out = F.batch_norm(x, moving_mean.to(st), moving_var.to(st), g, be,
                           training=False, eps=eps)
        stats = None
    if axis != 1:
        out = out.movedim(1, axis)
    return out if stats is None else (out, *stats)

@register("scaled_dot_product_attention")
def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 causal=False):
    """The dense attention chain: q, k, v (B, H, T, D). In the reference's
    order of operations: the scores in ``q.dtype``, times ``scale``
    (default ``1/sqrt(D)`` rounded to ``q.dtype``); ``causal`` keeps the
    bottom-right triangle (``col <= row + Tk - Tq``); ``mask`` (broadcast
    to the scores) keeps a score where it is nonzero; every other score is
    ``-inf``; softmax in fp32, cast back to ``q.dtype``, times V. No
    kernel: the reference computes it outside any Pallas kernel too."""
    if scale is None:
        scale = float(torch.tensor(math.sqrt(q.shape[-1])).to(
            q.dtype).reciprocal())
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=scores.device).tril(tk - tq)
        scores = scores.masked_fill(~keep, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(mask == 0, float("-inf"))
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(w, v)
