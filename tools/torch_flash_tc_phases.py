#!/usr/bin/env python3
"""Where the tensor-core flash kernels spend their cycles.

    python3 tools/torch_flash_tc_phases.py

Builds instrumented copies of ``incubator_mxnet_tpu_torch/csrc/
flash_bwd_tc.cu`` and ``flash_fwd_tc.cu`` (in a temporary directory; the
package's own libraries are untouched) in which consumer thread 0 of
every block reads ``clock64()`` at the phase boundaries of its loop, and
sums the cycles per phase over the blocks: ``setup`` (barriers, the row
statistics of dq), ``wait_first`` (the TMA loads of Q and dO, of K and V,
or of Q), per tile ``pre`` (zeroing the score accumulators; in the
forward the loop's own overhead), ``wait_full`` (the stage's TMA loads),
``mma_s`` (S and dP, or S in the forward: issue and wait), ``softmax`` (p,
dS and the masks in registers, or the online softmax, the rescale and the
bf16 packing), ``mma_d`` (dQ, dV and dK, or O += P.V: issue, wait, the
stage given back), and ``tail`` (the epilogue). Runs K5 and K6 once each
in bf16 at ``chip_smoke.BWD_CASES``' shapes and K4 at the bf16 cases of
``chip_smoke.fwd_cases()`` that take the tensor-core route, and prints
the mean cycles per block and the blocks' mean tiles. Needs ``nvcc`` and
a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402

PHASES = ("setup", "wait_first", "pre", "wait_full", "mma_s", "softmax",
          "mma_d", "tail")
_SLOT = {"tail": 0, "pre": 1, "wait_full": 2, "mma_s": 3, "softmax": 4,
         "mma_d": 5, "wait_first": 6, "setup": 7}

_PROBES = r'''
__device__ unsigned long long g_phase[3][10];
#define TSTART long long t_last = clock64(); long long t_acc[8] = {}; \
    int t_tiles = 0;
#define TMARK(i) do { long long t_now = clock64(); \
    t_acc[i] += t_now - t_last; t_last = t_now; } while (0)
#define TFLUSH(k) do { for (int q = 0; q < 8; ++q) \
    atomicAdd(&g_phase[k][q], (unsigned long long)t_acc[q]); \
    atomicAdd(&g_phase[k][8], 1ull); \
    atomicAdd(&g_phase[k][9], (unsigned long long)t_tiles); } while (0)
'''

_READERS = r'''
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_reset() {
  unsigned long long z[30] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));
}
'''


def _sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"the kernel source changed: no {old.strip()!r}")
    return text.replace(old, new, 1)


def instrumented_source() -> str:
    """flash_bwd_tc.cu with the phase probes in both kernels (slot 0: dq,
    1: dk/dv)."""
    src = (_build.CSRC / "flash_bwd_tc.cu").read_text()
    src = _sub(src, '#include "flash_tc.cuh"',
               '#include "flash_tc.cuh"\n' + _PROBES)
    i5 = src.index("flash_bwd_dq_tc_kernel(")
    i6 = src.index("flash_bwd_dkv_tc_kernel(")
    i7 = src.index("// host: tensor maps")
    bodies = []
    for k, body, bar, end in (
            (0, src[i5:i6], "qbar",
             "  store_tile<D>(acc, qs, dq + b * sb + h * sh + q0 * st, st, "
             "rows);\n"),
            (1, src[i6:i7], "kvbar",
             "  store_tile<D>(dva, vs, dv + off, st, rows);\n")):
        body = _sub(body, "  const int tid = threadIdx.x;",
                    "  const int tid = threadIdx.x;\n  TSTART")
        first = f"  if (ntiles > 0) mbar_wait({bar}, 0);\n"
        body = _sub(body, first, "  TMARK(7);\n" + first + "  TMARK(6);\n")
        wait = "    mbar_wait(&full[s], (it / kStages) & 1);\n"
        body = _sub(body, wait, "    TMARK(1);\n" + wait + "    TMARK(2);\n")
        mma_s = ("    wgmma_commit();\n    wgmma_wait<0>();\n"
                 "    fence_regs(sc);\n    fence_regs(dp);\n")
        body = _sub(body, mma_s, mma_s + "    TMARK(3);\n")
        rs = "    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4;"
        body = _sub(body, rs, "    TMARK(4);\n" + rs)
        arrive = "    mbar_arrive(&empty[s]);\n  }\n"
        body = _sub(body, arrive, "    mbar_arrive(&empty[s]);\n    "
                    "TMARK(5);\n    ++t_tiles;\n  }\n")
        body = _sub(body, end, end + f"  TMARK(0);\n  if (tid == 0) "
                    f"TFLUSH({k});\n")
        bodies.append(body)
    return src[:i5] + bodies[0] + bodies[1] + src[i7:] + _READERS


def instrumented_fwd_source() -> str:
    """flash_fwd_tc.cu with the phase probes in its kernel (slot 2)."""
    src = (_build.CSRC / "flash_fwd_tc.cu").read_text()
    src = _sub(src, '#include "flash_tc.cuh"',
               '#include "flash_tc.cuh"\n' + _PROBES)
    i4 = src.index("flash_fwd_tc_kernel(")
    i5 = src.index("// host: tensor maps")
    body = src[i4:i5]
    body = _sub(body, "  const int tid = threadIdx.x;",
                "  const int tid = threadIdx.x;\n  TSTART")
    first = "  if (ntiles > 0) mbar_wait(qbar, 0);\n"
    body = _sub(body, first, "  TMARK(7);\n" + first + "  TMARK(6);\n")
    wait = "    mbar_wait(&full[s], (it / kStages) & 1);\n"
    body = _sub(body, wait, "    TMARK(1);\n" + wait + "    TMARK(2);\n")
    mma_s = ("    wgmma_commit();\n    wgmma_wait<0>();\n"
             "    fence_regs(sc);\n")
    body = _sub(body, mma_s, mma_s + "    TMARK(3);\n")
    rs = "    fence_regs(acc);\n    wgmma_fence();\n"
    body = _sub(body, rs, "    TMARK(4);\n" + rs)
    arrive = "    mbar_arrive(&empty[s]);\n  }\n"
    body = _sub(body, arrive, "    mbar_arrive(&empty[s]);\n    TMARK(5);\n"
                "    ++t_tiles;\n  }\n")
    end = ("  store_tile<D>(acc, qs, o + b * sb + h * sh + q0 * st, st, "
           "rows);\n")
    body = _sub(body, end, end + "  TMARK(0);\n  if (tid == 0) TFLUSH(2);\n")
    return src[:i4] + body + src[i5:] + _READERS


def _build_lib(tmp, name, text):
    cu, so = f"{tmp}/{name}.cu", f"{tmp}/{name}.so"
    pathlib.Path(cu).write_text(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, cu], check=True)
    return ctypes.CDLL(so)


def _print(label, vals):
    blocks = max(1, vals[8])
    print(f"{label}: {vals[8]} blocks, {vals[9] / blocks:.2f} tiles per "
          "block; mean cycles per block " + ", ".join(
              f"{ph}={vals[_SLOT[ph]] / blocks:.0f}" for ph in PHASES),
          flush=True)


def forward_phases(lib, dev):
    """K4's phases at the bf16 cases of ``chip_smoke.fwd_cases()`` that take
    the tensor-core route."""
    fn = lib.mxtpu_flash_fwd_tc
    saved_fn = fa._fwd_fns.get("tc")
    fa._fwd_kernel("tc")               # the argtypes, set on the package's
    fn.argtypes = fa._fwd_fns["tc"].argtypes
    fn.restype = ctypes.c_int
    fa._fwd_fns["tc"] = fn
    buf = (ctypes.c_ulonglong * 30)()
    rs = np.random.RandomState(0)
    try:
        for name, b, tq, tk, d, causal, cache_offset, lengths, _ in \
                cs.fwd_cases():
            if cs.fwd_route_expected(tq, d, torch.bfloat16) != "tc":
                continue
            q, k, v = (torch.from_numpy(rs.randn(b, 12, t, d).astype(
                np.float32)).to(dev, torch.bfloat16) for t in (tq, tk, tk))
            lens = None if lengths is None else \
                torch.tensor(lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset,
                      return_lse=True)
            fa.flash_attention(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            lib.phase_reset()
            fa.flash_attention(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            lib.phase_read(buf)
            _print(f"{name} fwd", list(buf)[20:30])
    finally:
        if saved_fn is None:
            fa._fwd_fns.pop("tc", None)
        else:
            fa._fwd_fns["tc"] = saved_fn


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("torch_flash_tc_phases: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build_lib(tmp, "flash_bwd_tc", instrumented_source())
        fwd_lib = _build_lib(tmp, "flash_fwd_tc", instrumented_fwd_source())
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, i, i, i, p]
    dq, dkv = lib.mxtpu_flash_bwd_dq_tc, lib.mxtpu_flash_bwd_dkv_tc
    dq.argtypes = [p] * 8 + tail
    dkv.argtypes = [p] * 9 + tail
    dq.restype = dkv.restype = i
    saved = dict(fa._bwd_fns)
    fa._bwd_fns["tc"] = dq, dkv
    buf = (ctypes.c_ulonglong * 30)()
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    forward_phases(fwd_lib, dev)
    rs = np.random.RandomState(0)
    try:
        for name, b, tq, tk, d, causal, cache_offset, lengths in \
                cs.BWD_CASES:
            q, k, v, g = (torch.from_numpy(rs.randn(b, 12, t, d).astype(
                np.float32)).to(dev, torch.bfloat16)
                for t in (tq, tk, tk, tq))
            lens = None if lengths is None else \
                torch.tensor(lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset)
            out, lse = fa.flash_attention(q, k, v, lens, return_lse=True,
                                          **kw)
            delta = (g.float() * out.float()).sum(-1)
            args = (q, k, v, lens, lse, delta, g)
            for slot, label, run in ((0, "dq", fa.flash_bwd_dq),
                                     (1, "dkv", fa.flash_bwd_dkv)):
                run(*args, **kw)
                torch.cuda.synchronize()
                lib.phase_reset()
                run(*args, **kw)
                torch.cuda.synchronize()
                lib.phase_read(buf)
                _print(f"{name} {label}", list(buf)[10 * slot:10 * slot + 10])
    finally:
        fa._bwd_fns.clear()
        fa._bwd_fns.update(saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
