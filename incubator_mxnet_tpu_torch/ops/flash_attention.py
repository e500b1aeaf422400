"""Flash attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/pallas_attention.py``.
``flash_attention`` keeps that module's contract; a CUDA tensor always
launches the kernel in ``csrc/flash_fwd.cu`` (which replaces the TPU kernel
``_flash_fwd_kernel``), a CPU tensor takes ``flash_attention_reference``.
There is no size crossover to a dense path here: whether one pays on this
card has not been measured.

Layouts: q (B, H, Tq, D), k/v (B, H, Tk, D), any strides with a contiguous
head dimension, so the head-split views of a fused QKV projection go in
without copies. The output is a (B, H, Tq, D) view of a (B, Tq, H, D)
buffer: ``out.transpose(1, 2).reshape(B, Tq, H * D)`` merges the heads
without a copy.

No backward yet (the TPU backward kernels are a later slice): the CUDA path
refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_fwd_launches"]

#: kernel launches made by ``flash_attention`` (one per CUDA call); reset
#: it to 0 before a run and read it after, to show the run went through
#: the kernel
flash_fwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_fn = None


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


def flash_attention_reference(q, k, v, lengths=None, scale=None,
                              causal=False, cache_offset=False,
                              return_lse=False):
    """Plain PyTorch attention with the kernel's contract, computed in
    fp32 whatever the input dtype (output cast back to it). Rows with no
    valid key give 0 and lse = -inf, as the kernel does."""
    s, causal = _resolve(q, k, lengths, scale, causal, cache_offset)
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
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


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_fwd").mxtpu_flash_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA has no backward kernel yet; call it "
            "under torch.no_grad()")
    if lengths is not None:
        lengths = torch.as_tensor(lengths)
        if lengths.shape != (b,) or lengths.is_floating_point():
            raise ValueError(f"lengths must be ({b},) integers, got "
                             f"{tuple(lengths.shape)} {lengths.dtype}")
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    return lengths


def flash_attention(q, k, v, lengths=None, scale=None, causal=False,
                    cache_offset=False, return_lse=False):
    """Block-tiled flash attention. q (B, H, Tq, D), k/v (B, H, Tk, D);
    ``lengths`` (B,) optional per-sample valid key length.

    ``causal`` aligns the diagonal bottom-right (``col <= row + Tk - Tq``).
    ``cache_offset=True`` is the KV-cache decode alignment: K/V are the
    ``[0, lengths_b)`` prefix of a fixed buffer and the Tq queries are the
    last Tq of that prefix, so query row i attends keys
    ``[0, lengths_b - Tq + i]``. It requires ``lengths`` and implies
    ``causal``. With ``return_lse`` also returns the fp32 (B, H, Tq)
    log-sum-exp per row. A row with no valid key gives 0 and lse -inf.

    A CPU tensor takes :func:`flash_attention_reference`; a CUDA tensor
    launches the kernel or raises."""
    global flash_fwd_launches
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, scale, causal,
                                         cache_offset, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    s, causal = _resolve(q, k, lengths, scale, causal, cache_offset)
    lengths = _check_cuda(q, k, v, lengths)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    buf = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    out = buf.transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 lengths.data_ptr() if lengths is not None else None,
                 b, h, tq, tk, d, strides, s, int(causal),
                 int(bool(cache_offset)), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_fwd_launches += 1
    return (out, lse) if return_lse else out
