"""More ops: per-parameter samplers, image ops, LRN, masked softmax,
im2col/col2im, Correlation, DeformableConvolution, CTC loss, the fused
transformer matmuls, shape and index stragglers, and contrib ops.

Counterpart of the JAX package's ``ops/more.py`` (the reference's
``sample_op.cc``, ``src/operator/image/``, ``lrn.cc``, ``im2col.h``,
``correlation.cc``, contrib ``deformable_convolution``, ``ctc_loss.cc``,
``interleaved_matmul_*.cc``, ``svm_output.cc`` and the contrib stragglers).
None is a TPU kernel there, so each is plain PyTorch here, written as the
JAX package computes it:

* ``Correlation`` is its FlowNet fast path: the mean over channels of
  ``a`` times (or minus) ``b`` shifted, for every displacement; it reads
  neither ``kernel_size`` nor ``stride1``.
* ``DeformableConvolution`` is its bilinear gathers (zero outside) and
  one contraction, with ``num_deformable_group`` (the card machine has no
  torchvision).
* ``CTCLoss`` is optax's lattice, the one the JAX package runs: log(0) is
  the finite ``-1e5``, so an alignment that cannot be made (a label longer
  than the frames) costs about 1e5, where ``F.ctc_loss`` gives inf.
* ``masked_softmax``/``masked_log_softmax`` guard a row with no valid
  position before the softmax: 0 (or -inf) forward and a 0 gradient, where
  a softmax over an all ``-inf`` row gives NaN.
* ``image_resize`` is ``jax.image.resize``: antialiased when it shrinks,
  half-pixel centres for ``interp=0``; ``image_random_flip_left_right``
  draws one coin for the whole batch.

The per-parameter samplers replace ``ops/random_ops.py``'s aliases
``sample_uniform``/``sample_normal`` (this module registers after it, as
in the reference). ``MakeLoss``/``make_loss`` stay ``ops/misc.py``'s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import resolve_dtype
from . import random_ops as _r
from .nn import batch_norm
from .registry import register
from .tensor import take_along


# -- per-parameter samplers (one sample row per parameter element) ----------
def _sample(fn):
    """``f(*params, shape=(), dtype, rng)``: ``params[0].shape + shape``
    draws, each parameter broadcast along the ``shape`` axes."""
    def f(*params, shape=(), dtype="float32", rng=None):
        extra = _r._shape(shape)
        out_shape = tuple(params[0].shape) + extra
        ps = [p.float().reshape(tuple(p.shape) + (1,) * len(extra))
              for p in params]
        return fn(rng, ps, out_shape).to(resolve_dtype(dtype))

    f.__doc__ = fn.__doc__
    return f


@register("sample_uniform", needs_rng=True, differentiable=False)
@_sample
def sample_uniform(rng, ps, shape):
    """Uniform on [low, high) per element of ``low``/``high``."""
    low, high = ps
    u = torch.rand(shape, generator=rng, device=rng.device)
    return u * (high - low) + low


@register("sample_normal", needs_rng=True, differentiable=False)
@_sample
def sample_normal(rng, ps, shape):
    """Normal(mu, sigma) per element of ``mu``/``sigma``."""
    mu, sigma = ps
    return torch.randn(shape, generator=rng, device=rng.device) * sigma + mu


@register("sample_gamma", needs_rng=True, differentiable=False)
@_sample
def sample_gamma(rng, ps, shape):
    """Gamma of shape ``alpha``, scale ``beta``, per element."""
    alpha, beta = ps
    return _r.standard_gamma(alpha.expand(shape).contiguous(), rng) * beta


@register("sample_exponential", needs_rng=True, differentiable=False)
@_sample
def sample_exponential(rng, ps, shape):
    """Exponential of rate ``lam`` per element."""
    (lam,) = ps
    return _r.exponential(shape, rng) / lam


@register("sample_poisson", needs_rng=True, differentiable=False)
@_sample
def sample_poisson(rng, ps, shape):
    """Poisson of rate ``lam`` per element (float32 counts)."""
    (lam,) = ps
    return _r.poisson(lam.expand(shape).contiguous(), rng)


@register("sample_negative_binomial", needs_rng=True, differentiable=False)
@_sample
def sample_negative_binomial(rng, ps, shape):
    """Negative binomial of ``k`` successes of probability ``p`` per
    element: the gamma-Poisson mixture."""
    k, p = ps
    lam = _r.standard_gamma(k.expand(shape).contiguous(), rng) * (1 - p) / p
    return _r.poisson(lam, rng)


# -- image ops (the mx.nd.image namespace), HWC or NHWC ------------------------
@register("image_to_tensor")
def image_to_tensor(x):
    """HWC (or NHWC) in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""
    x = x.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


@register("image_normalize")
def image_normalize(x, mean=(0.0,), std=(1.0,)):
    """``(x - mean) / std`` per channel of a CHW (or NCHW) ``x``."""
    shape = (-1, 1, 1) if x.dim() == 3 else (1, -1, 1, 1)
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean.reshape(shape)) / std.reshape(shape)


@register("image_resize")
def image_resize(x, size=None, keep_ratio=False, interp=1):
    """Resize an HWC (or NHWC) image to ``size`` = (width, height), or a
    square of ``size``. ``interp=1`` is ``jax.image.resize``'s bilinear,
    antialiased where it shrinks; ``interp=0`` its nearest, with
    half-pixel centres (``"nearest-exact"``). An integer image resizes to
    float32, as ``jax.image.resize`` gives it."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    if not x.is_floating_point():
        x = x.to(torch.float32)
    batch = x if x.dim() == 4 else x.unsqueeze(0)
    nchw = batch.permute(0, 3, 1, 2)
    if interp == 0:
        out = F.interpolate(nchw, size=(h, w), mode="nearest-exact")
    else:
        out = F.interpolate(nchw, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1)
    return out if x.dim() == 4 else out[0]


@register("image_crop")
def image_crop(x, x0=0, y0=0, width=1, height=1):
    if x.dim() == 3:
        return x[y0:y0 + height, x0:x0 + width, :]
    return x[:, y0:y0 + height, x0:x0 + width, :]


@register("image_flip_left_right")
def image_flip_left_right(x):
    return torch.flip(x, (-2,))


@register("image_flip_top_bottom")
def image_flip_top_bottom(x):
    return torch.flip(x, (-3,))


@register("image_random_flip_left_right", needs_rng=True,
          differentiable=False)
def image_random_flip_left_right(x, rng=None):
    """Flip left-right with probability 1/2: one coin for the whole
    batch, as the reference draws it."""
    coin = torch.rand((), generator=rng, device=rng.device) < 0.5
    return torch.where(coin, torch.flip(x, (-2,)), x)


# -- classic NN stragglers ----------------------------------------------------
@register("LRN", aliases=("lrn",))
def lrn(x, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across the channels of NCHW ``x``."""
    pad = nsize // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, pad, pad))
    acc = torch.zeros_like(x)
    for i in range(nsize):
        acc = acc + sq[:, i:i + x.shape[1]]
    return x / torch.pow(knorm + alpha / nsize * acc, beta)


@register("softmin")
def softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


def _masked_scores(x, mask, axis, temperature):
    """fp32 scores, -inf where ``mask`` is 0; a row with no valid position
    becomes 0 (its result is masked out after the softmax), so neither the
    softmax nor its gradient sees a row of -inf alone."""
    keep = mask.to(torch.bool).expand_as(x)
    s = torch.where(keep, x.to(torch.float32) / temperature,
                    torch.tensor(-math.inf, device=x.device))
    any_valid = keep.any(dim=axis, keepdim=True)
    return torch.where(any_valid, s, torch.zeros((), device=x.device)), keep


@register("masked_softmax")
def masked_softmax(x, mask, axis=-1, temperature=1.0):
    """Softmax over the positions where ``mask`` is nonzero; 0 elsewhere
    (and on a row with no valid position)."""
    s, keep = _masked_scores(x, mask, axis, temperature)
    out = torch.softmax(s, dim=axis)
    return torch.where(keep, out, torch.zeros((), device=x.device)).to(
        x.dtype)


@register("masked_log_softmax")
def masked_log_softmax(x, mask, axis=-1, temperature=1.0):
    """Log-softmax over the positions where ``mask`` is nonzero; -inf
    elsewhere."""
    s, keep = _masked_scores(x, mask, axis, temperature)
    out = torch.log_softmax(s, dim=axis)
    return torch.where(keep, out, torch.tensor(-math.inf,
                                               device=x.device)).to(x.dtype)


@register("identity", aliases=("_copy",))
def identity(x):
    """A copy of ``x`` (``invoke`` copies a result that aliases an
    input)."""
    return x


@register("stop_gradient_op", aliases=("BlockGrad",))
def stop_gradient_op(x):
    return x.detach()


@register("add_n", aliases=("ElementWiseSum",))
def add_n(*arrays):
    """The sum of N arrays, left to right."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


@register("argmax_channel", differentiable=False)
def argmax_channel(x):
    """argmax over axis 1, as float32."""
    return torch.argmax(x, dim=1).to(torch.float32)


@register("Crop", aliases=("crop_like",), differentiable=False)
def crop_op(x, shape_like=None, offset=(0, 0), h_w=(0, 0),
            center_crop=False):
    """NCHW ``x`` cut to ``shape_like``'s H, W (or ``h_w``), at ``offset``
    (y, x) or centred."""
    th, tw = (shape_like.shape[2], shape_like.shape[3]) \
        if shape_like is not None else h_w
    h, w = x.shape[2], x.shape[3]
    y0, x0 = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    return x[:, :, y0:y0 + th, x0:x0 + tw]


# -- im2col / col2im: (N, C*kh*kw, L), the channel outermost -------------------
def _pairs(kernel, stride, dilate, pad):
    return (tuple(kernel), tuple(stride), tuple(dilate), tuple(pad))


@register("im2col")
def im2col(x, kernel=(3, 3), stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """(N, C, H, W) -> (N, C*kh*kw, L) patches."""
    k, s, d, p = _pairs(kernel, stride, dilate, pad)
    return F.unfold(x, k, dilation=d, padding=p, stride=s)


@register("col2im")
def col2im(col, output_size=None, kernel=(3, 3), stride=(1, 1),
           dilate=(1, 1), pad=(0, 0)):
    """The inverse layout of :func:`im2col`: overlapping patches sum."""
    k, s, d, p = _pairs(kernel, stride, dilate, pad)
    return F.fold(col, tuple(output_size), k, dilation=d, padding=p,
                  stride=s)


# -- Correlation (the FlowNet matching cost) ----------------------------------
@register("Correlation", aliases=("correlation",))
def correlation(a, b, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """For each displacement (dy, dx) in steps of ``stride2`` up to
    ``max_displacement``: the mean over channels of ``a * b`` shifted (or
    ``|a - b|``), (N, D*D, H, W). The reference's fast path: it reads
    neither ``kernel_size`` nor ``stride1``."""
    _, _, h, w = a.shape
    d = max_displacement
    o = d + pad_size
    bp = F.pad(b, (o, o, o, o))
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            shifted = bp[:, :, o + dy:o + dy + h, o + dx:o + dx + w]
            outs.append((a * shifted).mean(1) if is_multiply
                        else (a - shifted).abs().mean(1))
    return torch.stack(outs, dim=1)


# -- DeformableConvolution: bilinear gathers + one contraction -----------------
def _bilinear_nchw(x, sy, sx):
    """Bilinear samples of x (N, C, H, W) at float coordinates sy, sx
    (N, OH, OW); zero outside."""
    n, c, h, w = x.shape
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0).to(x.dtype)[:, None]
    wx = (sx - x0).to(x.dtype)[:, None]
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    flat = x.reshape(n, c, h * w)

    def gather(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(x.dtype)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        return vals.reshape(n, c, *yi.shape[1:]) * valid[:, None]

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


@register("DeformableConvolution", aliases=("deformable_convolution",))
def deformable_convolution(x, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_filter=None, num_deformable_group=1,
                           no_bias=False):
    """(N, C, H, W) with offsets (N, 2*kh*kw*G, OH, OW), (y, x) per tap
    and group -> (N, F, OH, OW): each tap bilinear-sampled at its grid
    point plus its offset, then contracted with the weights."""
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (dh, dw), (ph, pw) = _pairs(kernel, stride, dilate,
                                                    pad)
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    g = num_deformable_group
    offs = offset.reshape(n, g, kh * kw, 2, oh, ow)
    gy = (torch.arange(oh, device=x.device) * sh - ph).to(x.dtype)[:, None]
    gx = (torch.arange(ow, device=x.device) * sw - pw).to(x.dtype)[None, :]
    cg = c // g
    cols = []
    for gi in range(g):
        xg = x[:, gi * cg:(gi + 1) * cg]
        taps = []
        for ki in range(kh):
            for kj in range(kw):
                k = ki * kw + kj
                taps.append(_bilinear_nchw(xg, gy + ki * dh + offs[:, gi, k, 0],
                                           gx + kj * dw + offs[:, gi, k, 1]))
        cols.append(torch.stack(taps, dim=2))   # (N, cg, kh*kw, OH, OW)
    col = torch.cat(cols, dim=1).reshape(n, c * kh * kw, oh * ow)
    out = torch.einsum("fk,nkl->nfl", weight.reshape(weight.shape[0], -1),
                       col).reshape(n, weight.shape[0], oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -- CTC loss: optax's lattice ------------------------------------------------
_LOG_EPSILON = -1e5


def _ctc_lattice(logits, logitpad, labels, labelpad, blank_id):
    """optax ``ctc_loss_with_forward_probs``' forward pass: ``logits``
    (B, T, K), ``logitpad`` (B, T) and ``labelpad`` (B, N) 1.0 where
    padded, ``labels`` (B, N) int64; the per-sequence loss (B,)."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - labelpad.sum(1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(torch.float32),
                   (0, 1))
    phi_lp = logprobs[:, :, blank_id].transpose(0, 1)[..., None]  # (T,B,1)
    emit_lp = torch.gather(logprobs, 2, labels[:, None, :].expand(b, t, n)
                           ).transpose(0, 1)                      # (T,B,N)
    pads = logitpad.transpose(0, 1)[..., None]                    # (T,B,1)
    phi = torch.full((b, n + 1), _LOG_EPSILON, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), _LOG_EPSILON, device=logits.device)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for i in range(t):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + _LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit_lp[i],
                                    emit + emit_lp[i])
        next_phi = add_phi(prev_phi + phi_lp[i],
                           emit + phi_lp[i] + _LOG_EPSILON * (1.0 - repeat))
        pad = pads[i]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -last.gather(1, labellens[:, None])[:, 0]


@register("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC negative log likelihood per sample (N,): ``data`` (T, N, C)
    activations before the softmax, ``label`` (N, L) padded with -1 (or
    cut by ``label_lengths``), the blank 0 (``"first"``) or C-1
    (``"last"``). optax's lattice, whose log(0) is -1e5: an alignment that
    cannot be made costs about 1e5, not inf."""
    p = data.transpose(0, 1).to(torch.float32)               # (N, T, C)
    b, t, _ = p.shape
    lab = label.to(torch.int64)
    lpad = torch.where(lab < 0, torch.zeros_like(lab), lab)
    if use_data_lengths and data_lengths is not None:
        pos = torch.arange(t, device=data.device)[None, :]
        logitpad = (pos >= data_lengths.to(torch.int64)[:, None]).float()
    else:
        logitpad = torch.zeros((b, t), device=data.device)
    if use_label_lengths and label_lengths is not None:
        pos = torch.arange(lab.shape[1], device=data.device)[None, :]
        labelpad = (pos >= label_lengths.to(torch.int64)[:, None]).float()
    else:
        labelpad = (lab < 0).float()
    blank_id = 0 if blank_label == "first" else data.shape[-1] - 1
    return _ctc_lattice(p, logitpad, lpad, labelpad, blank_id)


# -- the fused transformer matmuls: (T, N, H, 3, D) interleaved per head --------
def _heads(x, t, n, heads, d):
    """(T, N, H, D) -> (N*H, T, D)."""
    return x.permute(1, 2, 0, 3).reshape(n * heads, t, d)


def _scaled(q, d):
    return q * (1.0 / torch.sqrt(torch.tensor(float(d), dtype=q.dtype,
                                              device=q.device)))


@register("interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """(T, N, 3*H*D), q/k/v interleaved per head -> scores (N*H, T, T),
    q scaled by 1/sqrt(D) before the product."""
    t, n, hd3 = queries_keys_values.shape
    d = hd3 // (3 * heads)
    x = queries_keys_values.reshape(t, n, heads, 3, d)
    q = _heads(x[:, :, :, 0], t, n, heads, d)
    k = _heads(x[:, :, :, 1], t, n, heads, d)
    return torch.bmm(_scaled(q, d), k.transpose(1, 2))


@register("interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """Values of (T, N, 3*H*D) and attention (N*H, T, T) -> (T, N, H*D)."""
    t, n, hd3 = queries_keys_values.shape
    d = hd3 // (3 * heads)
    v = _heads(queries_keys_values.reshape(t, n, heads, 3, d)[:, :, :, 2],
               t, n, heads, d)
    out = torch.bmm(attention, v).reshape(n, heads, t, d)
    return out.permute(2, 0, 1, 3).reshape(t, n, heads * d)


@register("interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """q (Tq, N, H*D) and k/v interleaved (Tk, N, 2*H*D) -> (N*H, Tq,
    Tk)."""
    tq, n, hd = queries.shape
    d = hd // heads
    tk = keys_values.shape[0]
    q = _heads(queries.reshape(tq, n, heads, d), tq, n, heads, d)
    k = _heads(keys_values.reshape(tk, n, heads, 2, d)[:, :, :, 0], tk, n,
               heads, d)
    return torch.bmm(_scaled(q, d), k.transpose(1, 2))


@register("interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    """Values of (Tk, N, 2*H*D) and attention (N*H, Tq, Tk) -> (Tq, N,
    H*D)."""
    tk, n, hd2 = keys_values.shape
    d = hd2 // (2 * heads)
    v = _heads(keys_values.reshape(tk, n, heads, 2, d)[:, :, :, 1], tk, n,
               heads, d)
    tq = attention.shape[1]
    out = torch.bmm(attention, v).reshape(n, heads, tq, d)
    return out.permute(2, 0, 1, 3).reshape(tq, n, heads * d)


# -- shape-derived and indexing stragglers ------------------------------------
@register("arange_like", differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i``, each value ``repeat`` times, float32: of
    ``data``'s shape (``axis`` None), else of its length along ``axis``."""
    n = data.numel() if axis is None else data.shape[axis]
    base = start + step * torch.arange(n // repeat, dtype=torch.float32,
                                       device=data.device)
    out = base.repeat_interleave(repeat)
    return out.reshape(data.shape) if axis is None else out


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = rhs.shape[ra]
    return lhs.expand(shape)


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("nan_to_num")
def nan_to_num(data, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(data, nan=nan, posinf=posinf, neginf=neginf)


def _rows(index, n):
    """Integer row indices, a negative one counted from the end, and
    whether each lies inside [0, n) (a write outside is dropped)."""
    idx = index.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


@register("choose_element_0index", differentiable=False)
def choose_element_0index(data, index):
    """``out[i] = data[i, index[i]]``."""
    return take_along(data, index.reshape(-1, 1), 1)[:, 0]


@register("fill_element_0index", differentiable=False)
def fill_element_0index(lhs, mhs, rhs):
    """``lhs`` with ``lhs[i, rhs[i]] = mhs[i]``."""
    idx, inside = _rows(rhs, lhs.shape[1])
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    out = lhs.clone()
    out[rows[inside], idx[inside]] = mhs.to(lhs.dtype)[inside]
    return out


@register("index_copy", differentiable=False)
def index_copy(old, index_vector, new_tensor):
    """``old`` with its rows at ``index_vector`` replaced by
    ``new_tensor``'s rows."""
    idx, inside = _rows(index_vector, old.shape[0])
    out = old.clone()
    out[idx[inside]] = new_tensor.to(old.dtype)[inside]
    return out


@register("sparse_retain_rows", differentiable=False)
def sparse_retain_rows(data, indices):
    """``data`` with every row not in ``indices`` zeroed (the dense view
    of ``sparse.retain``)."""
    idx, inside = _rows(indices, data.shape[0])
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[idx[inside]] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


# -- the loss and contrib ops -------------------------------------------------
class _SVMOutput(torch.autograd.Function):
    """Forward the identity; backward the multi-class hinge gradient
    times the regularization coefficient, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.reg_coef = margin, reg_coef
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        lab = label.to(torch.int64)
        onehot = F.one_hot(lab, data.shape[-1]).to(data.dtype)
        true = torch.gather(data, -1, lab[..., None])
        violate = ((data - true + ctx.margin > 0) & (onehot == 0)).to(
            data.dtype)
        grad = violate - onehot * violate.sum(-1, keepdim=True)
        return grad * ctx.reg_coef, None, None, None


@register("SVMOutput", aliases=("svm_output",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """SVM output layer: forward the identity, backward the multi-class
    hinge gradient (the reference reads ``use_linear`` nowhere)."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient))


@register("div_sqrt_dim", aliases=("contrib_div_sqrt_dim",))
def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])``."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype,
                                          device=data.device))


@register("quadratic", aliases=("contrib_quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data.square() + b * data + c


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("gradientmultiplier", aliases=("contrib_gradientmultiplier",))
def gradientmultiplier(data, scalar=1.0):
    """Forward the identity, backward the head gradient times ``scalar``
    (a gradient reversal where it is negative)."""
    return _GradientMultiplier.apply(data, float(scalar))


@register("AdaptiveAvgPooling2D",
          aliases=("contrib_AdaptiveAvgPooling2D", "adaptive_avg_pooling2d"))
def adaptive_avg_pooling2d(data, output_size=1):
    """NCHW adaptive average pooling: output cell i averages the input
    rows [floor(i*H/OH), ceil((i+1)*H/OH)), and likewise the columns."""
    if isinstance(output_size, (tuple, list)):
        oh, ow = int(output_size[0]), int(output_size[1])
    else:
        oh = ow = int(output_size)
    _, _, h, w = data.shape
    rows = []
    for i in range(oh):
        r0, r1 = (i * h) // oh, -((-(i + 1) * h) // oh)
        cols = [data[:, :, r0:r1, (j * w) // ow:-((-(j + 1) * w) // ow)]
                .mean(dim=(2, 3)) for j in range(ow)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@register("BatchNormWithReLU", aliases=("contrib_BatchNormWithReLU",
                                        "batch_norm_with_relu"))
def batch_norm_with_relu(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
                         momentum=0.9, fix_gamma=False,
                         use_global_stats=False, axis=1, training=False):
    """``BatchNorm`` then ReLU; in training (and not
    ``use_global_stats``) ``(out, mean, var)``."""
    out = batch_norm(x, gamma, beta, moving_mean, moving_var, eps=eps,
                     momentum=momentum, fix_gamma=fix_gamma,
                     use_global_stats=use_global_stats, axis=axis,
                     training=training)
    if isinstance(out, tuple):
        return (torch.relu(out[0]),) + out[1:]
    return torch.relu(out)


@register("requantize", aliases=("contrib_requantize",),
          differentiable=False)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulators of range [``min_range``, ``max_range``] -> int8
    in the calibrated range (or the data's own): ``(q, -absmax,
    absmax)``."""
    big = torch.tensor(1e-20, device=data.device)
    in_scale = torch.maximum(torch.maximum(min_range.abs(), max_range.abs()),
                             big) / 2147483647.0
    vals = data.to(torch.float32) * in_scale
    if min_calib_range is not None and max_calib_range is not None:
        absmax = torch.tensor(max(abs(float(min_calib_range)),
                                  abs(float(max_calib_range))),
                              dtype=torch.float32, device=data.device)
    else:
        absmax = (data.to(torch.float32).abs().max() * in_scale).reshape(
            in_scale.shape)
    out_scale = torch.maximum(absmax, big) / 127.0
    q = torch.clamp(torch.round(vals / out_scale), -127, 127).to(torch.int8)
    return q, -absmax, absmax
