"""Fused conv + BatchNorm: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_conv.py``. ``fused_conv_bn``
keeps that module's contract: NHWC activations, HWIO weights, odd square
or rectangular kernels, stride 1 or 2, symmetric padding, fp32 or bf16.
The previous layer's BatchNorm (``a``, ``b``), the residual join
(``resid`` with ``resid_scale``, ``resid_shift``) and the ReLU run as a
prologue on the input; the conv's own per-channel ``sum`` and ``sumsq``
come out of its epilogue, to be folded by :func:`bn_scale_shift` into the
next call's prologue.

A CUDA tensor always launches the kernels: the forward (which replaces
the TPU kernel ``_fused_conv_kernel``, both of its stride-2 layouts in one
kernel) and, for a gradient, the input-gradient and weight-gradient
kernels (``_conv_bwd_dx_kernel``, ``_conv_bwd_dw_kernel``; stride 2
included, where the JAX package's default keeps XLA for dx).
:func:`conv_route` picks each by type and widths: bf16 with Ci and Co
multiples of 8 goes to the tensor-core kernels of ``csrc/fused_conv_tc.cu``
and ``csrc/conv_bwd_tc.cu`` (wgmma fed by TMA); fp32 with Ci and Co
multiples of 4 and 16-byte aligned operands to ``csrc/fused_conv_f32.cu``
and ``csrc/conv_bwd_f32.cu`` (register micro-tiles on the FP32 pipes, fed
by TMA); everything else to ``csrc/fused_conv.cu`` and
``csrc/conv_bwd.cu`` (scalar fp32 FMAs). A
CPU tensor takes the plain versions, :func:`fused_conv_reference`,
:func:`conv_bwd_dx_reference` and :func:`conv_bwd_dw_reference`, which
follow the JAX package's ``_apply_prologue_host`` and ``_conv_raw`` with
``F.conv2d`` and ``torch.nn.grad``. None of the JAX package's
``MXTPU_CONV_*`` knobs (VMEM budget, output-channel block, row target,
im2col, stride-2 layout, backward dispatch, epilogue) has a counterpart:
there is one kernel per function, and the model always takes the
residual-epilogue chain.

Numerics, as the TPU kernels: the prologue runs in fp32 and is rounded to
x's type before the product; the conv accumulates in fp32 and ``y`` is
stored in x's type, while ``sum``/``sumsq`` are taken of the fp32
accumulator; the backward folds the statistics cotangents into ``dy``
(``dy + ds + 2*y*dss`` in fp32, rounded to y's type) and masks with the
strict ``lin > 0`` of the recomputed prologue.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build
from .registry import register

__all__ = ["FusedConvEpiFunction", "FusedConvFunction", "apply_prologue",
           "bn_scale_shift", "conv_bwd_dw", "conv_bwd_dw_launches",
           "conv_bwd_dw_reference", "conv_bwd_dx", "conv_bwd_dx_launches",
           "conv_bwd_dx_reference", "conv_bwd_dx_f32_launches",
           "conv_bwd_dw_f32_launches", "conv_route", "dw_splits",
           "dw_tc_box", "dw_tc_taps", "dx_tc_box", "dx_tc_cols",
           "dx_tc_taps", "fused_conv", "fwd_tc_cols", "fwd_tc_splits",
           "tc_box",
           "fused_conv_bn", "fused_conv_f32_launches", "fused_conv_launches",
           "fused_conv_reference",
           "join_defaults"]

#: kernel launches made by each wrapper (one per CUDA call); reset them to
#: 0 before a run and read them after, to show the run went through the
#: kernels
fused_conv_launches = 0
conv_bwd_dx_launches = 0
conv_bwd_dw_launches = 0
#: the same launches by route (see :func:`conv_route`)
fused_conv_tc_launches = fused_conv_simt_launches = 0
fused_conv_f32_launches = 0
conv_bwd_dx_tc_launches = conv_bwd_dx_simt_launches = 0
conv_bwd_dx_f32_launches = 0
conv_bwd_dw_tc_launches = conv_bwd_dw_simt_launches = 0
conv_bwd_dw_f32_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64          # rows and columns of a kernel tile
_KSTEP = 16         # pixels per step of the weight-gradient kernel
_DW_BLOCKS = 528    # weight-gradient blocks to aim for: 4 per SM of an H100
_TC_ROWS = 64       # pixels of a tensor-core block (one m64 wgmma)
_TC_BLOCKS = 264    # tensor-core blocks to aim for: 2 per SM of an H100
_SMS = 132          # streaming multiprocessors of an H100
_fns = {}


def _out_size(h, pad, k, stride):
    return (h + 2 * pad - k) // stride + 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def apply_prologue(x, a=None, b=None, r=None, ar=None, br=None, relu=True):
    """``relu(a*x + b [+ ar*r + br])`` in fp32, rounded to x's type (the
    JAX package's ``_apply_prologue_host``). With neither ``a`` nor ``r``
    it is x itself, with no ReLU. The activation is ``where(lin > 0, lin,
    0)``, so its gradient is the strict ``lin > 0`` mask of the kernels."""
    if a is None and r is None:
        return x
    xf = x.float()
    if a is not None:
        xf = xf * a.float() + b.float()
    if r is not None:
        rf = r.float()
        xf = xf + (rf if ar is None else rf * ar.float()) \
            + (0.0 if br is None else br.float())
    if relu:
        xf = torch.where(xf > 0.0, xf, torch.zeros_like(xf))
    return xf.to(x.dtype)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def fused_conv_reference(x, w, a=None, b=None, stride=1, pad=0, relu=True,
                         r=None, ar=None, br=None, emit=False):
    """Plain version of the forward kernel: the prologue, then a dense fp32
    conv (``F.conv2d``) of the rounded prologue output with w. Returns
    ``(y, sum, sumsq)`` (+ the prologue output when ``emit``); the sums are
    of the fp32 conv output, y is it rounded to x's type."""
    xp = apply_prologue(x, a, b, r, ar, br, relu)
    acc = _nhwc(F.conv2d(_nchw(xp.float()), _oihw(w.float()), stride=stride,
                         padding=pad))
    s = acc.sum(dim=(0, 1, 2))
    ss = (acc * acc).sum(dim=(0, 1, 2))
    out = (acc.to(x.dtype), s, ss)
    return out + (xp,) if emit else out


def _fold(dy, y, ds, dss):
    """``dy + ds + 2*y*dss`` in fp32, rounded to y's type, as fp32."""
    dyt = dy.float() + ds.float() + 2.0 * y.float() * dss.float()
    return dyt.to(y.dtype).float()


def conv_bwd_dx_reference(x, w, a, b, y, dy, ds, dss, stride=1, pad=0,
                          relu=True, r=None, ar=None, br=None, g=None):
    """Plain version of the input-gradient kernel. Returns ``(dx, da, db)``
    (``da``/``db`` None when ``a`` is None), and ``(dx, da, db, dr, dar)``
    with a residual; ``g`` is the emitted activation's cotangent."""
    dyt = _fold(dy, y, ds, dss)
    n, h, wd, ci = x.shape
    dxp = _nhwc(torch.nn.grad.conv2d_input(
        (n, ci, h, wd), _oihw(w.float()), _nchw(dyt), stride=stride,
        padding=pad))
    if g is not None:
        dxp = dxp + g.float()
    if a is None and r is None:
        return dxp.to(x.dtype), None, None
    x32 = x.float()
    av = a.float() if a is not None else torch.ones_like(x32[0, 0, 0])
    lin = x32 * av + (b.float() if a is not None else 0.0)
    if r is not None:
        r32 = r.float()
        lin = lin + r32 * ar.float() + br.float()
    dxf = torch.where(lin > 0.0, dxp, torch.zeros_like(dxp)) if relu \
        else dxp
    dx = (dxf * av).to(x.dtype)
    da = (dxf * x32).sum(dim=(0, 1, 2)) if a is not None else None
    db = dxf.sum(dim=(0, 1, 2)) if a is not None else None
    if r is None:
        return dx, da, db
    dr = (dxf * ar.float()).to(x.dtype)
    dar = (dxf * r32).sum(dim=(0, 1, 2))
    return dx, da, db, dr, dar


def conv_bwd_dw_reference(x, w, a, b, y, dy, ds, dss, stride=1, pad=0,
                          relu=True, r=None, ar=None, br=None):
    """Plain version of the weight-gradient kernel: the prologue output and
    the folded cotangent (both rounded as the kernel rounds them) in a
    dense fp32 weight gradient, cast to w's type."""
    xp = apply_prologue(x, a, b, r, ar, br, relu).float()
    dw = torch.nn.grad.conv2d_weight(
        _nchw(xp), tuple(_oihw(w).shape), _nchw(_fold(dy, y, ds, dss)),
        stride=stride, padding=pad)
    return dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        shape = [i] * 11 + [i, i, p]       # N..Wo, relu, dtype, stream
        if name == "fwd":
            fn = _build.load("fused_conv").mxtpu_fused_conv_fwd
            fn.argtypes = [p] * 12 + shape
        elif name == "fwd_tc":       # relu, bw, bh, bn, cols, taps, splits
            fn = _build.load("fused_conv_tc").mxtpu_fused_conv_tc
            fn.argtypes = [p] * 13 + [i] * 18 + [p]
        elif name == "fwd_f32":      # relu, then bw, bh, bn
            fn = _build.load("fused_conv_f32").mxtpu_fused_conv_f32
            fn.argtypes = [p] * 12 + [i] * 15 + [p]
        elif name == "dx":
            fn = _build.load("conv_bwd").mxtpu_conv_bwd_dx
            fn.argtypes = [p] * 18 + shape
        elif name == "dw":
            fn = _build.load("conv_bwd").mxtpu_conv_bwd_dw
            fn.argtypes = [p] * 12 + [i] + shape
        elif name == "dx_tc":        # relu, then bw, bh, bn, cols, taps
            fn = _build.load("conv_bwd_tc").mxtpu_conv_bwd_dx_tc
            fn.argtypes = [p] * 18 + [i] * 17 + [p]
        elif name == "dx_f32":       # relu, then bw, bh, bn
            fn = _build.load("conv_bwd_f32").mxtpu_conv_bwd_dx_f32
            fn.argtypes = [p] * 18 + [i] * 15 + [p]
        elif name == "dw_f32":       # splits, N..Wo, relu, bw, bh, bn, taps
            fn = _build.load("conv_bwd_f32").mxtpu_conv_bwd_dw_f32
            fn.argtypes = [p] * 12 + [i] * 17 + [p]
        else:                        # dw_tc: relu, then bw, bh, bn, taps
            fn = _build.load("conv_bwd_tc").mxtpu_conv_bwd_dw_tc
            fn.argtypes = [p] * 12 + [i] * 17 + [p]
        fn.restype = i
        _fns[name] = fn
    return fn


def _device_of(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv runs on cpu or cuda, got {x.device}")
    return x.device.type


def _geometry(x, w, stride, pad):
    """Check the call contract; returns (n, h, w, ci, co, kh, kw, ho, wo)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be NHWC and w HWIO, got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_conv takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"w dtype {w.dtype} != x dtype {x.dtype}")
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    if wci != ci:
        raise ValueError(f"channel mismatch: x has {ci}, w takes {wci}")
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel {kh}x{kw}: only odd sizes")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: only 1 or 2")
    if pad < 0:
        raise ValueError(f"pad {pad} < 0")
    ho, wo = _out_size(h, pad, kh, stride), _out_size(wd, pad, kw, stride)
    if min(n, h, wd, ci, co) < 1 or ho < 1 or wo < 1:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, output {ho}x{wo}")
    return n, h, wd, ci, co, kh, kw, ho, wo


def _same(name, t, like):
    """``t`` as a contiguous tensor shaped, typed and placed like ``like``."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype \
            or t.device != like.device:
        raise ValueError(f"{name} must be {like.dtype} {tuple(like.shape)} "
                         f"on {like.device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    return t.contiguous()


def _vec(name, t, c, dev):
    """A per-channel operand as contiguous fp32 (c,) on ``dev``, 16-byte
    aligned (the tensor-core kernels read it 8 channels a load)."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor) and t.dtype == torch.float32 \
            and t.device == dev and t.shape == (c,) and t.is_contiguous() \
            and t.data_ptr() % 16 == 0:
        return t    # as the model passes them: no conversion to pay for
    t = torch.as_tensor(t)
    if t.shape != (c,):
        raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    t = t.to(device=dev, dtype=torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(fn, x, *args):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _prologue_operands(x, a, b, r, ar, br, ci):
    dev = x.device
    if (a is None) != (b is None):
        raise ValueError("a and b come together")
    if r is not None and (ar is None or br is None):
        raise ValueError("resid needs resid_scale and resid_shift")
    return (_vec("a", a, ci, dev), _vec("b", b, ci, dev),
            _same("resid", r, x),
            _vec("resid_scale", ar, ci, dev) if r is not None else None,
            _vec("resid_shift", br, ci, dev) if r is not None else None)


def fused_conv(x, w, a=None, b=None, stride=1, pad=0, relu=True, r=None,
               ar=None, br=None, emit=False, route=None):
    """The forward kernel: ``(y, sum, sumsq)`` (+ the prologue output when
    ``emit``). A CPU tensor takes :func:`fused_conv_reference`; a CUDA
    tensor launches the kernel :func:`conv_route` names for its widths
    and operands (or ``route="simt"``: ``csrc/fused_conv.cu`` whatever the
    type) or raises."""
    global fused_conv_launches, fused_conv_tc_launches
    global fused_conv_simt_launches, fused_conv_f32_launches
    n, h, wd, ci, co, kh, kw, ho, wo = _geometry(x, w, stride, pad)
    if emit and r is None:
        raise ValueError("emit needs a resid operand")
    if _device_of(x) == "cpu":
        _pick_route(x.dtype, ci, co, route)
        return fused_conv_reference(x, w, a, b, stride, pad, relu, r, ar, br,
                                    emit)
    x, w = x.contiguous(), w.contiguous()
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    a, b, r, ar, br = _prologue_operands(x, a, b, r, ar, br, ci)
    route = _pick_route(x.dtype, ci, co, route, "fused_conv",
                        (x, w, a, b, r, ar, br))
    dev = x.device
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=dev)
    s = torch.empty(co, dtype=torch.float32, device=dev)
    ss = torch.empty(co, dtype=torch.float32, device=dev)
    xp = torch.empty_like(x) if emit else None
    ptrs = (_ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(r), _ptr(ar), _ptr(br),
            _ptr(y), _ptr(s), _ptr(ss), _ptr(xp))
    dims = (n, h, wd, ci, co, kh, kw, stride, pad, ho, wo, int(bool(relu)))
    if route == "tc":
        taps = dw_tc_taps(kw, stride, wo, r is not None)
        box = dw_tc_box(n, ho, wo, kw, taps)
        cols = fwd_tc_cols(co, taps)
        splits = fwd_tc_splits(n, ho, wo, ci, co, kh, kw, taps, cols)
        boxes = _boxes(n, ho, wo, box)
        part = torch.empty(2 * boxes * co, dtype=torch.float32, device=dev)
        part_y = torch.empty(splits * boxes * _TC_ROWS * co,
                             dtype=torch.float32, device=dev) \
            if splits > 1 else None
        _run(_kernel("fwd_tc"), x, *ptrs, _ptr(part), _ptr(part_y), *dims,
             *box, cols, taps, splits)
        fused_conv_tc_launches += 1
    else:   # f32 and SIMT: the sums' partials over 64-row tiles of y
        part = torch.empty(2 * -(-n * ho * wo // _TILE) * co,
                           dtype=torch.float32, device=dev)
        if route == "f32":
            _run(_kernel("fwd_f32"), x, *ptrs, _ptr(part), *dims,
                 *tc_box(n, ho, wo))
            fused_conv_f32_launches += 1
        else:
            _run(_kernel("fwd"), x, *ptrs, _ptr(part), *dims,
                 _DTYPE_CODE[x.dtype])
            fused_conv_simt_launches += 1
    fused_conv_launches += 1
    return (y, s, ss, xp) if emit else (y, s, ss)


def _backward_operands(x, w, y, dy, stride, pad):
    geo = _geometry(x, w, stride, pad)
    n, _, _, _, co, _, _, ho, wo = geo
    want = (n, ho, wo, co)
    for name, t in (("y", y), ("dy", dy)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    return geo


def conv_bwd_dx(x, w, a, b, y, dy, ds, dss, stride=1, pad=0, relu=True,
                r=None, ar=None, br=None, g=None, route=None):
    """The input-gradient kernel: ``(dx, da, db)`` (+ ``dr, dar`` with a
    residual). A CPU tensor takes :func:`conv_bwd_dx_reference`; a CUDA
    tensor launches the kernel :func:`conv_route` names for its widths
    and operands (or ``route="simt"``: the SIMT kernel whatever the type)
    or raises."""
    global conv_bwd_dx_launches, conv_bwd_dx_tc_launches
    global conv_bwd_dx_simt_launches, conv_bwd_dx_f32_launches
    n, h, wd, ci, co, kh, kw, ho, wo = _backward_operands(
        x, w, y, dy, stride, pad)
    if _device_of(x) == "cpu":
        _pick_route(x.dtype, ci, co, route, "conv_bwd_dx")
        return conv_bwd_dx_reference(x, w, a, b, y, dy, ds, dss, stride, pad,
                                     relu, r, ar, br, g)
    x = x.contiguous()
    w, y, g = w.contiguous(), y.contiguous(), _same("g", g, x)
    dy = _same("dy", dy.to(y.dtype), y)
    if y.dtype != x.dtype or w.device != x.device or y.device != x.device:
        raise ValueError("x, w, y and dy must share one type and device")
    a, b, r, ar, br = _prologue_operands(x, a, b, r, ar, br, ci)
    ds, dss = _vec("ds", ds, co, x.device), _vec("dss", dss, co, x.device)
    dev = x.device
    pro = a is not None or r is not None
    dx = torch.empty_like(x)
    dr = torch.empty_like(x) if r is not None else None
    f32 = dict(dtype=torch.float32, device=dev)
    da = torch.empty(ci, **f32) if a is not None else None
    db = torch.empty(ci, **f32) if a is not None else None
    dar = torch.empty(ci, **f32) if r is not None else None
    hq, wq = -(-h // stride), -(-wd // stride)     # the widest phase
    ptrs = (_ptr(dy), _ptr(y), _ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(ds),
            _ptr(dss), _ptr(r), _ptr(ar), _ptr(br), _ptr(g), _ptr(dx),
            _ptr(da), _ptr(db), _ptr(dr), _ptr(dar))
    dims = (n, h, wd, ci, co, kh, kw, stride, pad, ho, wo, int(bool(relu)))
    route = _pick_route(x.dtype, ci, co, route, "conv_bwd_dx",
                        (dy, y, x, w, a, b, ds, dss, r, ar, br, g, dx, dr))
    if route == "f32":
        box = dx_tc_box(n, h, wd, kw, stride, 1)
        rows = stride * stride * _boxes(n, hq, wq, box)
        part = torch.empty(3 * rows * ci if pro else 1, **f32)
        _run(_kernel("dx_f32"), x, *ptrs, _ptr(part), *dims, *box)
        conv_bwd_dx_f32_launches += 1
    elif route == "tc":
        taps = dx_tc_taps(kw, stride, wd)
        box = dx_tc_box(n, h, wd, kw, stride, taps)
        rows = stride * stride * _boxes(n, hq, wq, box)
        part = torch.empty(3 * rows * ci if pro else 1, **f32)
        _run(_kernel("dx_tc"), x, *ptrs, _ptr(part), *dims, *box,
             dx_tc_cols(n, h, wd, ci, stride, taps), taps)
        conv_bwd_dx_tc_launches += 1
    else:
        rows = stride * stride * -(-n * hq * wq // _TILE)
        part = torch.empty(3 * rows * ci if pro else 1, **f32)
        _run(_kernel("dx"), x, *ptrs, _ptr(part), *dims,
             _DTYPE_CODE[x.dtype])
        conv_bwd_dx_simt_launches += 1
    conv_bwd_dx_launches += 1
    return (dx, da, db, dr, dar) if r is not None else (dx, da, db)


def conv_route(dtype, ci, co, kernel="fused_conv", operands=()):
    """Which kernel ``kernel`` (``"fused_conv"``: K1, ``"conv_bwd_dx"``:
    K2, ``"conv_bwd_dw"``: K3) takes on the card: ``"tc"`` (the
    tensor-core kernels of ``csrc/fused_conv_tc.cu`` and
    ``csrc/conv_bwd_tc.cu``) for bf16 with ``ci`` and ``co`` multiples of
    8, whose NHWC rows are whole 16-byte units as TMA needs; for fp32 with
    ``ci`` and ``co`` multiples of 4 (16-byte rows) and every tensor of
    ``operands`` (those the wrapper hands the kernel: the C entries of
    ``csrc/fused_conv_f32.cu`` and ``csrc/conv_bwd_f32.cu`` check the
    same) on a 16-byte boundary, ``"f32"`` (register micro-tiles on the
    FP32 pipes, fed by TMA; no tensor-core path keeps fp32 off TF32);
    ``"simt"`` (``csrc/fused_conv.cu``, ``csrc/conv_bwd.cu``) for
    everything else: ragged widths and misaligned fp32 operands. Measured
    on an H100 (``chip_smoke.py``'s conv kernel phase,
    ``tools/torch_resnet_conv_times.py``; PERF.md): the f32 kernels beat
    the SIMT ones on the same inputs at ResNet-50's 52 shapes (K1 at 1x1
    64->256 plain level), so the three kernels share one rule (``kernel``
    names the one asked about)."""
    if dtype == torch.bfloat16 and ci % 8 == 0 and co % 8 == 0:
        return "tc"
    if dtype == torch.float32 and ci % 4 == 0 and co % 4 == 0 \
            and _aligned16(*operands):
        return "f32"
    return "simt"


def _aligned16(*tensors):
    """Every tensor given (None aside) starts on a 16-byte boundary."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _pick_route(dtype, ci, co, route, kernel="fused_conv", operands=()):
    """:func:`conv_route`'s choice for ``kernel``, or ``route`` where a
    caller names one: ``"simt"`` takes any call (to time the SIMT kernels
    beside the tensor-core or f32 ones), ``"tc"`` and ``"f32"`` only what
    the rule sends there."""
    rule = conv_route(dtype, ci, co, kernel, operands)
    if route is None or route == rule or route == "simt":
        return rule if route is None else route
    off = "" if _aligned16(*operands) else \
        ", an operand off a 16-byte boundary,"
    raise ValueError(f"route {route!r}: {dtype} with Ci={ci}, Co={co}"
                     f"{off} takes {rule!r}")


def tc_box(n, h, w):
    """The box of pixels a tensor-core block takes from an (n, h, w)
    extent: ``(bw, bh, bn)``, at most 64 pixels, whole rows of the width
    where they fit, then whole images, so that one 4-D TMA load brings
    it."""
    bw = min(w, _TC_ROWS)
    bh = min(h, _TC_ROWS // bw) if bw == w else 1
    bn = min(n, _TC_ROWS // (bw * bh)) if bw == w and bh == h else 1
    return bw, bh, bn


def _boxes(n, h, w, box=None):
    """How many boxes (default :func:`tc_box`'s) cover an (n, h, w)
    extent."""
    bw, bh, bn = tc_box(n, h, w) if box is None else box
    return -(-w // bw) * -(-h // bh) * -(-n // bn)


def dw_tc_taps(kw, stride, wo, res):
    """Taps of one kernel row that a tensor-core or f32 weight-gradient
    block, or a step of a tensor-core forward block, takes: all 3 of a
    3-wide stride-1 kernel without a residual, whose output rows and the 2
    columns its taps reach past them fit a block (one box of x then serves
    the 3 taps, rewritten once); 1 otherwise."""
    return 3 if kw == 3 and stride == 1 and not res \
        and wo + kw - 1 <= _TC_ROWS else 1


def dw_tc_box(n, ho, wo, kw, taps):
    """The output box of a tensor-core weight-gradient or forward block:
    :func:`tc_box` for one tap; for a row of taps, whole output rows
    widened by the ``kw - 1`` columns the taps reach past them (no output
    pixels there)."""
    if taps == 1:
        return tc_box(n, ho, wo)
    bw = wo + kw - 1
    return bw, min(ho, _TC_ROWS // bw), 1


def dx_tc_taps(kw, stride, w):
    """Taps of one kernel row a tensor-core dx step takes: all 3 of a
    3-wide stride-1 kernel whose input rows and the 2 columns its taps
    reach past them fit a block (one box of dy, folded once, serves the 3
    taps); 1 otherwise."""
    return 3 if kw == 3 and stride == 1 and w + kw - 1 <= _TC_ROWS else 1


def dx_tc_box(n, h, w, kw, stride, taps):
    """The box of input pixels of a tensor-core or f32 dx block:
    :func:`tc_box` over a stride phase for one tap; for a row of taps
    (tensor cores only), whole rows widened by the ``kw - 1`` columns the
    taps reach (no pixels of dx there)."""
    if taps == 1:
        return tc_box(n, -(-h // stride), -(-w // stride))
    bw = w + kw - 1
    return bw, min(h, _TC_ROWS // bw), 1


def dx_tc_cols(n, h, w, ci, stride, taps=1):
    """Input channels per tensor-core dx block: 128 where Ci is wider than
    64, the grid still holds ``_TC_BLOCKS`` blocks and a step takes one
    tap (three weight tiles of 128 would leave room for one block an SM),
    else 64."""
    if taps != 1:
        return 64
    blocks = stride * stride * _boxes(n, -(-h // stride), -(-w // stride))
    return 128 if ci > 64 and blocks * -(-ci // 128) >= _TC_BLOCKS else 64


def fwd_tc_cols(co, taps=1):
    """Output channels per tensor-core forward block: 128 where Co is wider
    than 64 and a step takes one tap (three weight tiles of 128 would leave
    room for one block an SM), else 64. A block of 128 rewrites its x tile
    once for twice the channels: on an H100 it was the faster at every
    ResNet-50 shape tried, 7x7 grids of 128 blocks included (PERF.md)."""
    return 128 if taps == 1 and co > 64 else 64


def fwd_tc_splits(n, ho, wo, ci, co, kh, kw, taps=1, cols=64):
    """How many ranges of whole steps (64 channels of one tap, or of a row
    of taps) a tensor-core forward block's K is cut into: 1 unless the grid
    (boxes by column blocks) would busy at most half the card's SMs at a
    deep K (32 steps or more: Ci = 2048 at 1x1); then enough ranges of at
    least 4 steps to come near ``_TC_BLOCKS`` blocks, none empty. The
    ranges add up in fp32 planes, summed in order (no atomics). On an H100
    a split was faster only there (1x1 2048->512 at 7x7, B=8); at 16 to 25
    steps and at B=32 it was slower (PERF.md)."""
    blocks = _boxes(n, ho, wo, dw_tc_box(n, ho, wo, kw, taps)) \
        * -(-co // cols)
    steps = kh * (kw // taps) * -(-ci // _TILE)
    if blocks > _SMS // 2 or steps < 32:
        return 1
    want = max(1, min(_TC_BLOCKS // blocks, steps // 4))
    return -(-steps // -(-steps // want))


def dw_splits(n, ho, wo, ci, co, kh, kw, route="simt", taps=1):
    """How many ranges the weight-gradient kernel cuts its N*Ho*Wo pixels
    into, each of whole steps, enough to fill the card. ``"simt"``: about
    ``_DW_BLOCKS`` blocks of 64x64, each range at least 8 steps of 16
    pixels. ``"tc"`` and ``"f32"``: at most
    ``_TC_BLOCKS`` blocks of 64x64 (by ``taps`` taps) where the tiles allow
    (one wave of two blocks per SM: a second, short wave would double the
    time), a step is a box of :func:`dw_tc_box`, each range at least 4
    boxes, and no range is empty. ``"f32"`` where the tiles alone would
    leave one block on most SMs (more than half of ``_TC_BLOCKS``, fewer
    than all): about four blocks an SM instead, since one f32 block alone
    leaves its SM idle between steps (3x3 256->256 at 14x14: 0.38 ms
    against 0.58 in one range on an H100, ``tools/torch_dw_f32_splits.py``;
    PERF.md)."""
    tiles = kh * (kw // taps) * -(-ci // _TILE) * -(-co // _TILE)
    if route == "simt":
        steps = -(-n * ho * wo // _KSTEP)
        return max(1, min(-(-_DW_BLOCKS // tiles), steps // 8))
    boxes = _boxes(n, ho, wo, dw_tc_box(n, ho, wo, kw, taps))
    want = _TC_BLOCKS // tiles
    if route == "f32" and _TC_BLOCKS // 2 < tiles < _TC_BLOCKS:
        want = -(-2 * _TC_BLOCKS // tiles)
    want = max(1, min(want, boxes // 4))
    return -(-boxes // -(-boxes // want))


def conv_bwd_dw(x, w, a, b, y, dy, ds, dss, stride=1, pad=0, relu=True,
                r=None, ar=None, br=None, route=None):
    """The weight-gradient kernel: dW in w's type. A CPU tensor takes
    :func:`conv_bwd_dw_reference`; a CUDA tensor launches the kernel
    :func:`conv_route` names for its widths and operands (or
    ``route="simt"``) or raises."""
    global conv_bwd_dw_launches, conv_bwd_dw_tc_launches
    global conv_bwd_dw_simt_launches, conv_bwd_dw_f32_launches
    n, h, wd, ci, co, kh, kw, ho, wo = _backward_operands(
        x, w, y, dy, stride, pad)
    if _device_of(x) == "cpu":
        _pick_route(x.dtype, ci, co, route, "conv_bwd_dw")
        return conv_bwd_dw_reference(x, w, a, b, y, dy, ds, dss, stride, pad,
                                     relu, r, ar, br)
    x = x.contiguous()
    w, y = w.contiguous(), y.contiguous()
    dy = _same("dy", dy.to(y.dtype), y)
    if y.dtype != x.dtype or w.device != x.device or y.device != x.device:
        raise ValueError("x, w, y and dy must share one type and device")
    a, b, r, ar, br = _prologue_operands(x, a, b, r, ar, br, ci)
    ds, dss = _vec("ds", ds, co, x.device), _vec("dss", dss, co, x.device)
    route = _pick_route(x.dtype, ci, co, route, "conv_bwd_dw",
                        (x, dy, y, a, b, ds, dss, r, ar, br))
    taps = dw_tc_taps(kw, stride, wo, r is not None) if route != "simt" \
        else 1
    splits = dw_splits(n, ho, wo, ci, co, kh, kw, route, taps)
    dw = torch.empty_like(w)
    # the f32 kernel writes dW itself when there is one range
    part = torch.empty(1 if route == "f32" and splits == 1
                       else splits * kh * kw * ci * co,
                       dtype=torch.float32, device=x.device)
    args = (_ptr(x), _ptr(dy), _ptr(y), _ptr(a), _ptr(b), _ptr(ds),
            _ptr(dss), _ptr(r), _ptr(ar), _ptr(br), _ptr(dw), _ptr(part),
            splits, n, h, wd, ci, co, kh, kw, stride, pad, ho, wo,
            int(bool(relu)))
    if route == "tc":
        _run(_kernel("dw_tc"), x, *args, *dw_tc_box(n, ho, wo, kw, taps),
             taps)
        conv_bwd_dw_tc_launches += 1
    elif route == "f32":
        _run(_kernel("dw_f32"), x, *args, *dw_tc_box(n, ho, wo, kw, taps),
             taps)
        conv_bwd_dw_f32_launches += 1
    else:
        _run(_kernel("dw"), x, *args, _DTYPE_CODE[x.dtype])
        conv_bwd_dw_simt_launches += 1
    conv_bwd_dw_launches += 1
    return dw


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _cotangents(y, dy, ds, dss):
    """Materialized cotangents in the kernels' types: dy in y's type, the
    statistics cotangents fp32."""
    return dy.to(y.dtype), ds.float(), dss.float()


class FusedConvFunction(torch.autograd.Function):
    """Differentiable fused conv without a residual (the JAX package's
    ``_fused_conv`` custom VJP): outputs ``(y, sum, sumsq)``, cotangents
    ``(dy, ds, dss)``. A cotangent that is not used arrives as zeros."""

    @staticmethod
    def forward(ctx, x, w, a, b, stride, pad, relu):
        y, s, ss = fused_conv(x, w, a, b, stride, pad, relu)
        ctx.save_for_backward(x, w, a, b, y)
        ctx.conf = (stride, pad, relu)
        return y, s, ss

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds, dss):
        x, w, a, b, y = ctx.saved_tensors
        dy, ds, dss = _cotangents(y, dy, ds, dss)
        need = ctx.needs_input_grad
        dx = dw = da = db = None
        if need[1]:
            dw = conv_bwd_dw(x, w, a, b, y, dy, ds, dss, *ctx.conf)
        if need[0] or need[2] or need[3]:
            dx, da, db = conv_bwd_dx(x, w, a, b, y, dy, ds, dss, *ctx.conf)
        return dx, dw, da, db, None, None, None


class FusedConvEpiFunction(torch.autograd.Function):
    """Differentiable fused conv with the residual join in its prologue and
    an optional emitted activation (the JAX package's ``_fused_conv_epi``):
    outputs ``(y, sum, sumsq[, joined])``; the shift's gradient equals the
    prologue shift's (``dbr = db``)."""

    @staticmethod
    def forward(ctx, x, w, a, b, r, ar, br, stride, pad, relu, emit):
        outs = fused_conv(x, w, a, b, stride, pad, relu, r, ar, br, emit)
        ctx.save_for_backward(x, w, a, b, r, ar, br, outs[0])
        ctx.conf = (stride, pad, relu)
        ctx.emit = emit
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds, dss, *g):
        x, w, a, b, r, ar, br, y = ctx.saved_tensors
        dy, ds, dss = _cotangents(y, dy, ds, dss)
        g = g[0].to(x.dtype) if ctx.emit else None
        need = ctx.needs_input_grad
        dx = dw = da = db = dr = dar = None
        if need[1]:
            dw = conv_bwd_dw(x, w, a, b, y, dy, ds, dss, *ctx.conf, r, ar, br)
        if any(need[i] for i in (0, 2, 3, 4, 5, 6)):
            dx, da, db, dr, dar = conv_bwd_dx(x, w, a, b, y, dy, ds, dss,
                                              *ctx.conf, r, ar, br, g)
        return dx, dw, da, db, dr, dar, db, None, None, None, None


@register("fused_conv_bn")
def fused_conv_bn(x, w, a=None, b=None, stride=1, pad=0, relu=True,
                  resid=None, resid_scale=None, resid_shift=None,
                  emit_act=False):
    """Fused (BatchNorm prologue + ReLU [+ residual join]) -> conv ->
    (statistics epilogue), differentiable.

    x: (N, H, W, Ci) NHWC; w: (kh, kw, Ci, Co) HWIO; a, b: optional (Ci,)
    fp32 scale and shift of the previous BatchNorm (``a = gamma /
    sqrt(var + eps)``, ``b = beta - mean * a``). Returns ``(y, sum,
    sumsq)``: y is the raw conv output in x's type, the fp32 per-channel
    sums feed :func:`bn_scale_shift`. With ``resid`` (x-shaped) the
    prologue is the whole bottleneck junction ``relu(a*x + b +
    resid_scale*resid + resid_shift)``, scale 1 and shift 0 by default,
    and a missing ``a`` is the identity; ``emit_act`` also returns that
    joined activation. ``emit_act`` without ``resid`` raises."""
    if resid is None:
        if emit_act:
            raise ValueError(
                "emit_act requires a resid operand (the emitted activation "
                "is the joined shortcut input; without a residual the "
                "caller already holds x)")
        return FusedConvFunction.apply(x, w, a, b, int(stride), int(pad),
                                       bool(relu))
    a, b, ar, br = join_defaults(x, a, b, resid_scale, resid_shift)
    return FusedConvEpiFunction.apply(x, w, a, b, resid, ar, br, int(stride),
                                      int(pad), bool(relu), bool(emit_act))


def join_defaults(x, a, b, resid_scale, resid_shift):
    """The residual join's operands with the JAX package's defaults: a
    missing prologue is the identity (a=1, b=0), a missing residual scale
    1 and shift 0. Returns ``(a, b, resid_scale, resid_shift)``."""
    ci = x.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    if a is None:
        a, b = torch.ones(ci, **f32), torch.zeros(ci, **f32)
    ar = torch.ones(ci, **f32) if resid_scale is None else resid_scale
    br = torch.zeros(ci, **f32) if resid_shift is None else resid_shift
    return a, b, ar, br


def bn_scale_shift(s, ss, count, gamma, beta, eps=1e-5):
    """Fold batch statistics and the BatchNorm parameters into the next
    prologue's fp32 ``(a, b)``; returns ``(a, b, mean, var)`` with the
    biased batch variance ``max(ss/count - mean^2, 0)`` (what the running
    variance averages, as in the JAX package)."""
    count = float(count)
    mean = s / count
    var = torch.clamp(ss / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = gamma.float() * inv
    b = beta.float() - mean * a
    return a, b, mean, var

