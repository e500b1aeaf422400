"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_attention.py``.
``flash_attention`` keeps that module's contract. A CUDA tensor always
launches the kernels: the forward (which replaces the TPU kernel
``_flash_fwd_kernel``) on the route :func:`flash_fwd_route` names: the
bf16 tensor-core kernel of ``csrc/flash_fwd_tc.cu`` (``"tc"``: training
and prefill), the fp32 kernel of ``csrc/flash_fwd_f32.cu`` (``"f32"``:
register micro-tiles on the FP32 pipes, training and prefill), the
kernels of ``csrc/flash_fwd_split.cu`` that split the
keys of a decode step (one query row) over blocks and merge them
(``"split"``), or the SIMT kernel of ``csrc/flash_fwd.cu`` (``"simt"``);
and, for a gradient, the two backward kernels (``_flash_bwd_dq_kernel``
and ``_flash_bwd_dkv_kernel``) on the route :func:`flash_bwd_route`
names: the bf16 tensor-core kernels of ``csrc/flash_bwd_tc.cu``
(``"tc"``), the fp32 kernels of ``csrc/flash_bwd_f32.cu`` (``"f32"``:
register micro-tiles on the FP32 pipes) or the SIMT kernels of
``csrc/flash_bwd.cu`` (``"simt"``). A CPU tensor takes the plain
versions, ``flash_attention_reference`` and
``flash_attention_bwd_reference``. There is no size crossover to a dense
path here: whether one pays on this card has not been measured.

Layouts: q (B, H, Tq, D), k/v (B, H, Tk, D), any strides with a contiguous
head dimension, so the head-split views of a fused QKV projection go in
without copies. The output is a (B, H, Tq, D) view of a (B, Tq, H, D)
buffer: ``out.transpose(1, 2).reshape(B, Tq, H * D)`` merges the heads
without a copy. The gradients come back in the same layout.

Gradients: when grad is enabled and one of q, k, v requires it,
``flash_attention`` runs :class:`FlashAttentionFunction`, the counterpart of
the JAX package's ``_flash_core`` custom VJP: the forward saves the output
and the fp32 row log-sum-exp, the backward computes ``delta = sum(g * o)``
in plain PyTorch and runs the two backward kernels (or, on the CPU, their
plain version). The route rules are ones of dtype, shape and alignment,
decided before the launch: a launch that fails raises, whatever its
route, and no route gives way to another.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build
from . import launches as _launches
from .registry import register

__all__ = ["FlashAttentionFunction", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_reference", "flash_bwd_dkv",
           "flash_bwd_dkv_reference", "flash_bwd_dq", "flash_bwd_dq_reference",
           "flash_bwd_route", "flash_bwd_dkv_launches",
           "flash_bwd_dkv_f32_launches", "flash_bwd_dkv_simt_launches",
           "flash_bwd_dkv_tc_launches", "flash_bwd_dq_launches",
           "flash_bwd_dq_f32_launches", "flash_bwd_dq_simt_launches",
           "flash_bwd_dq_tc_launches", "flash_fwd_launches",
           "flash_fwd_f32_launches", "flash_fwd_route",
           "flash_fwd_simt_launches",
           "flash_fwd_split_launches", "flash_fwd_tc_launches",
           "split_plan"]

#: kernel launches made by each wrapper (one per call, whatever the route
#: and however many CUDA launches it makes); reset them to 0 before a run
#: and read them after, to show the run went through the kernels
flash_fwd_launches = 0
#: the forward calls by route (see :func:`flash_fwd_route`)
flash_fwd_tc_launches = flash_fwd_split_launches = 0
flash_fwd_f32_launches = flash_fwd_simt_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
#: the backward launches by route (see :func:`flash_bwd_route`)
flash_bwd_dq_tc_launches = flash_bwd_dq_simt_launches = 0
flash_bwd_dkv_tc_launches = flash_bwd_dkv_simt_launches = 0
flash_bwd_dq_f32_launches = flash_bwd_dkv_f32_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_TC_HEAD_DIMS = (64, 128)
#: the split kernels (one query row): keys a tile of the chunk, and the
#: blocks an SM the plan aims for (at 8 slots x 12 heads against a 512-key
#: cache, chunks of one tile: PERF.md)
SPLIT_TILE = 64
SPLIT_BLOCKS_PER_SM = 8
#: the fewest query rows an fp32 call takes the f32 forward with (up to 32
#: the SIMT kernel, at every batch measured): see :func:`flash_fwd_route`
FWD_F32_MIN_TQ = 33
_fwd_fns = {}
_bwd_fns = {}
_sm_counts = {}


def _resolve(q, k, lengths, scale, causal, cache_offset):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, T, D); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    s = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if cache_offset:
        if lengths is None:
            raise ValueError("cache_offset=True requires per-sample "
                             "lengths (the cache fill per slot)")
        causal = True
    return s, bool(causal)


def _valid(q, k, lengths, causal, cache_offset):
    """(B or 1, 1, Tq, Tk) bool: the (query, key) pairs the call attends."""
    b, _, tq, _ = q.shape
    tk = k.shape[2]
    rows = torch.arange(tq, device=q.device).view(1, 1, tq, 1)
    cols = torch.arange(tk, device=q.device).view(1, 1, 1, tk)
    valid = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=q.device)
    lens = None
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=q.device).to(torch.int64)
        lens = lens.view(b, 1, 1, 1)
        valid = valid & (cols < lens)
    if causal:
        off = (lens - tq) if cache_offset else (tk - tq)
        valid = valid & (cols <= rows + off)
    return valid


def flash_attention_reference(q, k, v, lengths=None, scale=None,
                              causal=False, cache_offset=False,
                              return_lse=False):
    """Plain PyTorch attention with the kernel's contract, computed in
    fp32 whatever the input dtype (output cast back to it). Rows with no
    valid key give 0 and lse = -inf, as the kernel does."""
    s, causal = _resolve(q, k, lengths, scale, causal, cache_offset)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
    valid = _valid(q, k, lengths, causal, cache_offset)
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, v.float()) / l.clamp_min(1e-37)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-37)),
                      torch.full_like(l, float("-inf")))
    return out, lse.squeeze(-1)


def _bwd_probs(q, k, v, lengths, lse, delta, g, scale, causal,
               cache_offset):
    """fp32 probabilities p and score cotangents dS of the backward,
    recomputed from the forward's lse (rows with a non-finite lse give 0)."""
    s, causal = _resolve(q, k, lengths, scale, causal, cache_offset)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
    valid = _valid(q, k, lengths, causal, cache_offset)
    lse = lse.float().unsqueeze(-1)
    finite = torch.isfinite(lse)
    p = torch.where(valid & finite,
                    torch.exp(scores - torch.where(finite, lse, 0.0)), 0.0)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.float().unsqueeze(-1)) * s
    return p, ds


def flash_bwd_dq_reference(q, k, v, lengths, lse, delta, g, scale=None,
                           causal=False, cache_offset=False):
    """Plain version of the dq kernel: dense, in fp32, dq in q's dtype."""
    _, ds = _bwd_probs(q, k, v, lengths, lse, delta, g, scale, causal,
                       cache_offset)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, lengths, lse, delta, g, scale=None,
                            causal=False, cache_offset=False):
    """Plain version of the dk/dv kernel: dense, in fp32, (dk, dv) in the
    input dtypes."""
    p, ds = _bwd_probs(q, k, v, lengths, lse, delta, g, scale, causal,
                       cache_offset)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), g.float()).to(v.dtype)
    return dk, dv


def flash_attention_bwd_reference(q, k, v, lengths, lse, delta, g,
                                  scale=None, causal=False,
                                  cache_offset=False):
    """Plain PyTorch version of the two backward kernels: ``lse`` and
    ``delta`` are the (B, H, Tq) fp32 row statistics (``delta = sum(g *
    o)``), ``g`` the output cotangent. Dense, in fp32; returns (dq, dk, dv)
    in the input dtypes."""
    args = (q, k, v, lengths, lse, delta, g, scale, causal, cache_offset)
    return (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))


def _fwd_kernel(route):
    """The forward entry point of the route's library: ``"simt"``
    ``csrc/flash_fwd.cu`` (a dtype argument before the stream), ``"tc"``
    ``csrc/flash_fwd_tc.cu`` (bf16 only), ``"f32"``
    ``csrc/flash_fwd_f32.cu`` (fp32 only), ``"split"``
    ``csrc/flash_fwd_split.cu`` (one query row: the workspace after
    lengths, no Tq and no causal flags; dtype, chunk and chunk count
    before the stream)."""
    fn = _fwd_fns.get(route)
    if fn is None:
        source = {"simt": "flash_fwd", "tc": "flash_fwd_tc",
                  "f32": "flash_fwd_f32", "split": "flash_fwd_split"}[route]
        fn = getattr(_build.load(source), "mxtpu_" + source)
        p, i = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        if route == "split":
            fn.argtypes = [p] * 7 + [i, i, i, i, strides, ctypes.c_float,
                                     i, i, i, p]
        else:
            fn.argtypes = [p] * 6 + [i, i, i, i, i, strides, ctypes.c_float,
                                     i, i] + ([i] if route == "simt" else
                                              []) + [p]
        fn.restype = i
        _fwd_fns[route] = fn
    return fn


def _bwd_kernels(route):
    """(dq, dkv) entry points of the route's library: ``"simt"``
    ``csrc/flash_bwd.cu`` (a dtype argument before the stream), ``"tc"``
    ``csrc/flash_bwd_tc.cu`` (bf16 only), ``"f32"``
    ``csrc/flash_bwd_f32.cu`` (fp32 only)."""
    fns = _bwd_fns.get(route)
    if fns is None:
        simt = route == "simt"
        suffix = "" if simt else "_" + route
        lib = _build.load("flash_bwd" + suffix)
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_float, i, i] + ([i] if simt else []) + [p]
        dq = getattr(lib, "mxtpu_flash_bwd_dq" + suffix)
        dkv = getattr(lib, "mxtpu_flash_bwd_dkv" + suffix)
        dq.argtypes = [p] * 8 + tail
        dkv.argtypes = [p] * 9 + tail
        dq.restype = dkv.restype = i
        fns = _bwd_fns[route] = dq, dkv
    return fns


def _aligned16(t, d):
    """``t`` is (B, H, T, d) with a contiguous head dim, a base address
    and (b, h, t) strides that are multiples of 16 bytes (a dim of size 1
    has no stride to hold to): TMA can describe it, and its rows read in
    16-byte vectors."""
    if t.dim() != 4 or t.shape[-1] != d or t.stride(3) != 1 \
            or t.data_ptr() % 16:
        return False
    size = t.element_size()
    return not any(t.shape[i] > 1 and t.stride(i) * size % 16
                   for i in range(3))


def _fwd_routes(q, k, v, out):
    """The forward routes whose kernels take this call: ``"simt"`` any;
    with every operand 16-byte aligned, ``"split"`` one query row in fp32
    or bf16 with D in (32, 64, 128), ``"tc"`` bf16 with D 64 or 128,
    ``"f32"`` fp32 with D 64 or 128 and more than one query row."""
    d = q.shape[-1]
    routes = ["simt"]
    ops = (q, k, v) + (() if out is None else (out,))
    if q.dtype in _DTYPE_CODE and d in _HEAD_DIMS and all(
            t.dtype == q.dtype and _aligned16(t, d) for t in ops):
        if q.shape[2] == 1:
            routes.append("split")
        if q.dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
            routes.append("tc")
        if q.dtype == torch.float32 and d in _TC_HEAD_DIMS \
                and q.shape[2] > 1:
            routes.append("f32")
    return routes


def flash_fwd_route(q, k, v, out=None):
    """Which forward kernel a call takes on the card: ``"split"``
    (``csrc/flash_fwd_split.cu``) for a decode step (Tq = 1), fp32 or
    bf16, D in (32, 64, 128); ``"tc"`` (``csrc/flash_fwd_tc.cu``) for the
    rest in bf16 with D 64 or 128; ``"f32"`` (``csrc/flash_fwd_f32.cu``:
    register micro-tiles on the FP32 pipes, fed by TMA; no tensor-core
    path keeps fp32 off TF32) for the rest in fp32 with D 64 or 128 and at
    least ``FWD_F32_MIN_TQ`` query rows; ``"simt"`` (``csrc/flash_fwd.cu``)
    for everything else: D = 32, misaligned views and fp32 prompts
    shorter than that. The split, tc and f32 routes
    need q, k, v and the output ``out`` with a contiguous head dim, a base
    address and (b, h, t) strides that are multiples of 16 bytes, as TMA
    and 16-byte loads need. Decided from dtype, shape and alignment before
    the launch. Measured on an H100 (``tools/torch_flash_fwd_routes.py``,
    PERF.md): at Tq = 1 the split kernels beat the tensor-core kernel in
    bf16 and the SIMT one 8x in fp32. A prompt takes tc, f32 or SIMT: a
    split with 8 query rows a block, since removed, was slower than tc at
    every Tq above 1 and than SIMT on prompts of 2 to 24 tokens. In fp32
    a B=1 causal prompt of 12 heads takes the f32 kernel about 0.0078 ms
    from Tq = 2 to 64 (12 blocks of 64 rows on 132 SMs: one tile's
    latency), the SIMT kernel 0.0048 at Tq = 2, 0.0064 at 16, 0.0072 at
    24, 0.0080 at 32 (the f32 kernel 0.0078 there: within 3%, a tie
    kept on SIMT), 0.0105 at 40 and 0.0129 at 64; at T=256 0.0239 against
    0.0422. The crossover does not move with the grid: from B = 1 to 64
    (12 to 768 heads, a tenth of the SMs to about six waves of 64-row
    tiles) SIMT wins at every Tq from 2 to 24, is level at 32 up to B = 4
    and ahead beyond (B = 64: 0.0226 against 0.0354), and loses at 40 and
    64 everywhere (B = 64, Tq = 40: 0.0554 against 0.0356). So fp32 calls
    of 32 query rows or fewer stay on SIMT whatever B and H
    (``FWD_F32_MIN_TQ``)."""
    routes = _fwd_routes(q, k, v, out)
    if "split" in routes:
        return "split"
    if "tc" in routes:
        return "tc"
    if "f32" in routes and q.shape[2] >= FWD_F32_MIN_TQ:
        return "f32"
    return "simt"


def _pick_fwd_route(q, k, v, out, route):
    """:func:`flash_fwd_route`'s choice, or ``route`` where a caller names
    one whose kernel takes the call (to time one route beside another):
    ``"simt"`` any call, ``"split"``, ``"tc"`` and ``"f32"`` aligned
    operands of their dtypes and head dims, ``"split"`` one query row,
    ``"f32"`` more than one."""
    if route is None:
        return flash_fwd_route(q, k, v, out)
    if route in _fwd_routes(q, k, v, out):
        return route
    raise ValueError(f"route {route!r}: this call ({q.dtype}, D="
                     f"{q.shape[-1]}, its strides and alignment) takes "
                     f"{flash_fwd_route(q, k, v, out)!r}")


def split_plan(b, h, tk, sms=132):
    """(keys a chunk, chunks) of the split kernels: chunks of whole 64-key
    tiles, as few as give about ``SPLIT_BLOCKS_PER_SM`` blocks an SM over
    the ``sms`` SMs (at least one tile a chunk)."""
    tiles = -(-tk // SPLIT_TILE)
    nsplit = min(tiles, max(1, -(-SPLIT_BLOCKS_PER_SM * sms // (b * h))))
    chunk = SPLIT_TILE * -(-tiles // nsplit)
    return chunk, -(-tk // chunk)


def _sm_count(device):
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def flash_bwd_route(q, k, v, g, outs=()):
    """Which backward kernels a call takes on the card, for D 64 or 128
    where every operand (q, k, v, g and the outputs ``outs``) has one dtype,
    a contiguous head dim, a base address and (b, h, t) strides that are
    multiples of 16 bytes (a dim of size 1 has no stride to hold to):
    ``"tc"`` (the tensor-core kernels of ``csrc/flash_bwd_tc.cu``, TMA and
    ``wgmma``) in bf16, ``"f32"`` (``csrc/flash_bwd_f32.cu``: register
    micro-tiles on the FP32 pipes, fed by TMA; no tensor-core path keeps
    fp32 off TF32) in fp32. ``"simt"`` (``csrc/flash_bwd.cu``) takes
    everything else: D = 32 and misaligned views. Measured on an H100
    (``chip_smoke.py``'s backward kernel phase, PERF.md): on the same fp32
    inputs the f32 kernels beat the SIMT ones at every shape of the
    phase. Decided from dtype, shape and alignment before the launch."""
    d = q.shape[-1]
    if q.dtype not in _DTYPE_CODE or d not in _TC_HEAD_DIMS:
        return "simt"
    for t in (q, k, v, g, *outs):
        if t.dtype != q.dtype or not _aligned16(t, d):
            return "simt"
    return "tc" if q.dtype == torch.bfloat16 else "f32"


def _pick_bwd_route(q, k, v, g, outs, route):
    """:func:`flash_bwd_route`'s choice, or ``route`` where a caller names
    one: ``"simt"`` takes any call (to time the SIMT kernels beside the
    tensor-core or f32 ones), ``"tc"`` and ``"f32"`` only what the rule
    sends there."""
    rule = flash_bwd_route(q, k, v, g, outs)
    if route is None or route == rule or route == "simt":
        return rule if route is None else route
    raise ValueError(f"route {route!r}: this call ({q.dtype}, D="
                     f"{q.shape[-1]}, its strides and alignment) takes "
                     f"{rule!r}")


def _check_cuda(q, k, v, lengths):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    b, h, tq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[:2] != (b, h) \
            or k.shape[3] != d:
        raise ValueError(f"k/v must be (B={b}, H={h}, Tk, D={d}); got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if tq < 1 or k.shape[2] < 1:
        raise ValueError("empty query or key sequence")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name} head dim must be contiguous "
                             f"(stride {t.stride(3)})")
        if min(t.stride()) < 0:
            raise ValueError(f"{name} has a negative stride")
    if lengths is not None:
        lengths = torch.as_tensor(lengths)
        if lengths.shape != (b,) or lengths.is_floating_point():
            raise ValueError(f"lengths must be ({b},) integers, got "
                             f"{tuple(lengths.shape)} {lengths.dtype}")
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    return lengths


def _check_bwd(q, lse, delta, g):
    """The backward kernels' extra inputs: g like q with a contiguous head
    dim (copied otherwise), lse and delta contiguous fp32 (B, H, Tq)."""
    if g.shape != q.shape:
        raise ValueError(f"g must be shaped like q {tuple(q.shape)}, got "
                         f"{tuple(g.shape)}")
    if g.dtype != q.dtype or g.device != q.device:
        raise TypeError(f"g ({g.dtype}, {g.device}) must match q "
                        f"({q.dtype}, {q.device})")
    if (g.stride(3) != 1 and g.shape[3] > 1) or min(g.stride()) < 0:
        g = g.contiguous()
    rows = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != rows or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be fp32 {rows} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return g, lse.contiguous(), delta.contiguous()


def _like_out(q):
    """A (B, H, T, D) view of a fresh (B, T, H, D) buffer."""
    b, h, t, d = q.shape
    return torch.empty((b, t, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _forward(q, k, v, lengths, scale, causal, cache_offset, return_lse,
             route=None):
    """The forward on the route :func:`_pick_fwd_route` names (a CPU
    tensor: the plain version, after checking a named route)."""
    if _device_of(q) == "cpu":
        if route is not None:
            _pick_fwd_route(q, k, v, None, route)
        return flash_attention_reference(q, k, v, lengths, scale, causal,
                                         cache_offset, return_lse)
    s, causal = _resolve(q, k, lengths, scale, causal, cache_offset)
    lengths = _check_cuda(q, k, v, lengths)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = _like_out(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    route = _pick_fwd_route(q, k, v, out, route)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            lengths.data_ptr() if lengths is not None else None)
    fn = _fwd_kernel(route)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "split":
            chunk, nchunks = split_plan(b, h, tk, _sm_count(q.device))
            part = torch.empty(b * h * nchunks * (d + 2),
                               dtype=torch.float32, device=q.device)
            err = fn(*head, part.data_ptr(), b, h, tk, d, strides, s,
                     _DTYPE_CODE[q.dtype], chunk, nchunks, stream)
        else:
            dtype = (_DTYPE_CODE[q.dtype],) if route == "simt" else ()
            err = fn(*head, b, h, tq, tk, d, strides, s, int(causal),
                     int(bool(cache_offset)), *dtype, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed ({route} route):"
                           f" CUDA error {err}")
    _launches.count(__name__, f"flash_fwd_{route}_launches",
                    "flash_fwd_launches")
    return (out, lse) if return_lse else out


def _launch_bwd(which, q, k, v, lengths, lse, delta, g, scale, causal,
                cache_offset, route):
    """Launch the dq (``which == 0``) or dk/dv kernel on CUDA tensors, on
    the route :func:`_pick_bwd_route` names; returns (outputs, route)."""
    s, causal = _resolve(q, k, lengths, scale, causal, cache_offset)
    lengths = _check_cuda(q, k, v, lengths)
    g, lse, delta = _check_bwd(q, lse, delta, g)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    outs = (_like_out(q),) if which == 0 else (_like_out(k), _like_out(v))
    route = _pick_bwd_route(q, k, v, g, outs, route)
    ostrides = [x for o in outs for x in o.stride()[:3]]
    ostrides += [0] * (6 - len(ostrides))
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        *ostrides)
    fn = _bwd_kernels(route)[which]
    dtype = (_DTYPE_CODE[q.dtype],) if route == "simt" else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 lengths.data_ptr() if lengths is not None else None,
                 *(o.data_ptr() for o in outs), b, h, tq, tk, d, strides, s,
                 int(causal), int(bool(cache_offset)), *dtype, stream)
    if err != 0:
        name = ("flash_bwd_dq", "flash_bwd_dkv")[which]
        raise RuntimeError(f"{name} kernel launch failed ({route} route): "
                           f"CUDA error {err}")
    return outs, route


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    return q.device.type


def flash_bwd_dq(q, k, v, lengths, lse, delta, g, scale=None, causal=False,
                 cache_offset=False, route=None):
    """dq of the flash backward: a CPU tensor takes
    :func:`flash_bwd_dq_reference`, a CUDA tensor launches the dq kernel of
    the route :func:`flash_bwd_route` names (or ``route="simt"``: the SIMT
    kernel whatever the type) or raises. A ``route`` the rule does not
    allow raises on the CPU too."""
    if _device_of(q) == "cpu":
        if route is not None:
            _pick_bwd_route(q, k, v, g, (), route)
        return flash_bwd_dq_reference(q, k, v, lengths, lse, delta, g, scale,
                                      causal, cache_offset)
    (dq,), route = _launch_bwd(0, q, k, v, lengths, lse, delta, g, scale,
                               causal, cache_offset, route)
    _launches.count(__name__, f"flash_bwd_dq_{route}_launches",
                    "flash_bwd_dq_launches")
    return dq


def flash_bwd_dkv(q, k, v, lengths, lse, delta, g, scale=None, causal=False,
                  cache_offset=False, route=None):
    """(dk, dv) of the flash backward: a CPU tensor takes
    :func:`flash_bwd_dkv_reference`, a CUDA tensor launches the dk/dv kernel
    of the route :func:`flash_bwd_route` names (or ``route="simt"``) or
    raises. A ``route`` the rule does not allow raises on the CPU too."""
    if _device_of(q) == "cpu":
        if route is not None:
            _pick_bwd_route(q, k, v, g, (), route)
        return flash_bwd_dkv_reference(q, k, v, lengths, lse, delta, g,
                                       scale, causal, cache_offset)
    (dk, dv), route = _launch_bwd(1, q, k, v, lengths, lse, delta, g, scale,
                                  causal, cache_offset, route)
    _launches.count(__name__, f"flash_bwd_dkv_{route}_launches",
                    "flash_bwd_dkv_launches")
    return dk, dv


def flash_attention_bwd(q, k, v, lengths, lse, delta, g, scale=None,
                        causal=False, cache_offset=False, route=None):
    """The flash backward, the counterpart of the JAX package's
    ``_flash_bwd``: (dq, dk, dv) in the input dtypes from the forward's
    ``lse`` and ``delta = sum(g * o)`` (both fp32 (B, H, Tq)); ``route``
    as :func:`flash_bwd_dq` takes it."""
    args = (q, k, v, lengths, lse, delta, g, scale, causal, cache_offset)
    return (flash_bwd_dq(*args, route=route),
            *flash_bwd_dkv(*args, route=route))


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``_flash_core``
    custom VJP). Returns ``(out, lse)``; lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, causal, cache_offset,
                route=None):
        out, lse = _forward(q, k, v, lengths, scale, causal, cache_offset,
                            True, route)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.lengths = lengths
        ctx.flags = (scale, causal, cache_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        # delta from the output in its stored type, as the JAX package does
        delta = (g.float() * out.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, ctx.lengths, lse, delta,
                                         g.to(q.dtype), *ctx.flags)
        return dq, dk, dv, None, None, None, None, None


@register("flash_attention")
def flash_attention(q, k, v, lengths=None, scale=None, causal=False,
                    cache_offset=False, return_lse=False, route=None):
    """Block-tiled flash attention. q (B, H, Tq, D), k/v (B, H, Tk, D);
    ``lengths`` (B,) optional per-sample valid key length.

    ``causal`` aligns the diagonal bottom-right (``col <= row + Tk - Tq``).
    ``cache_offset=True`` is the KV-cache decode alignment: K/V are the
    ``[0, lengths_b)`` prefix of a fixed buffer and the Tq queries are the
    last Tq of that prefix, so query row i attends keys
    ``[0, lengths_b - Tq + i]``. It requires ``lengths`` and implies
    ``causal``. With ``return_lse`` also returns the fp32 (B, H, Tq)
    log-sum-exp per row. A row with no valid key gives 0 and lse -inf.

    When grad is enabled and q, k or v requires it, the call runs
    :class:`FlashAttentionFunction`, so a backward pass reaches the
    backward kernels. A CPU tensor takes the plain versions; a CUDA tensor
    launches the forward kernel of the route :func:`flash_fwd_route` names
    (or ``route``: ``"simt"`` for any call, ``"split"`` (one query row) or
    ``"tc"`` where their kernels take it) or raises. A ``route`` whose kernel cannot take
    the call raises on the CPU too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = FlashAttentionFunction.apply(q, k, v, lengths, scale,
                                                causal, cache_offset, route)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, lengths, scale, causal, cache_offset,
                    return_lse, route)
