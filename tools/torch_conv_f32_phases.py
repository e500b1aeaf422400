#!/usr/bin/env python3
"""Where the fp32 input-gradient conv kernels (K2) spend their cycles: the
SIMT kernel of ``csrc/conv_bwd.cu`` and the register micro-tile kernel of
``csrc/conv_bwd_f32.cu``, on the same inputs.

    python3 tools/torch_conv_f32_phases.py [--batch N]

Builds instrumented copies of both sources (in a temporary directory; the
package's own libraries are untouched) in which thread 0 of every block
reads ``clock64()`` at the phase boundaries of its main loop, and prints
the mean cycles per block of each phase. The SIMT kernel: ``setup``, per
16-channel step ``store`` (the wait for the previous step's gathered
loads of dy, y and w, the fold and the transposing stores to shared
memory), ``bar1`` (the barrier after them), ``load`` (issuing the next
step's loads), ``product`` (the 64x64 tile step) and ``bar2`` (the
barrier after it), and ``tail`` (the epilogue). The f32 kernel:
``setup``, per 32-channel step ``pre`` (the step's tap, ds and dss),
``wait`` (the stage's TMA loads), ``fold`` (the in-place fold of the dy
tile), ``bar`` (the barrier, and thread 0 starting a stage's loads),
``product`` (the micro-tile step), and ``tail`` (the epilogue). Runs K2
in fp32 at ``chip_smoke.CONV_CASES`` (their batch, or ``--batch``), then
times both kernels there (CUDA-graph replay). Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import fused_conv as fc  # noqa: E402

# (name, clock64 slot) of each kernel's phases, in the order printed
SIMT_PHASES = (("setup", 7), ("store", 1), ("bar1", 2), ("load", 3),
               ("product", 4), ("bar2", 5), ("tail", 0))
F32_PHASES = (("setup", 7), ("pre", 1), ("wait", 2), ("fold", 3),
              ("bar", 4), ("product", 5), ("tail", 0))

_PROBES = r'''
__device__ unsigned long long g_phase[10];
#define TSTART long long t_last = clock64(); long long t_acc[8] = {};
#define TMARK(i) do { long long t_now = clock64(); \
    t_acc[i] += t_now - t_last; t_last = t_now; } while (0)
#define TFLUSH() do { for (int q = 0; q < 8; ++q) \
    atomicAdd(&g_phase[q], (unsigned long long)t_acc[q]); \
    atomicAdd(&g_phase[8], 1ull); } while (0)
'''

_READERS = r'''
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_reset() {
  unsigned long long z[10] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));
}
'''

_TAIL = "  if (!pro) return;  // uniform over the block: no sums to take"


def _sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"a conv source changed: no {old.strip()!r}")
    return text.replace(old, new, 1)


def instrumented_simt_source() -> str:
    """conv_bwd.cu with the phase probes in conv_bwd_dx_kernel."""
    src = (_build.CSRC / "conv_bwd.cu").read_text()
    src = _sub(src, '#include "conv_common.cuh"',
               '#include "conv_common.cuh"\n' + _PROBES)
    i = src.index("conv_bwd_dx_kernel(")
    j = src.index("conv_bwd_dw_kernel(")
    body = src[i:j]
    body = _sub(body, "  const int tid = threadIdx.x;\n",
                "  const int tid = threadIdx.x;\n  TSTART\n")
    body = _sub(body, "  int t = 0, c0 = 0;\n", "  TMARK(7);\n"
                "  int t = 0, c0 = 0;\n")
    body = _sub(body, "    store(c0);\n    __syncthreads();\n",
                "    store(c0);\n    TMARK(1);\n    __syncthreads();\n"
                "    TMARK(2);\n")
    body = _sub(body, "    if (step + 1 < nsteps) load(t, c0);\n"
                "    tile_product(As, Bs, acc, ty, tx);\n    __syncthreads();\n",
                "    if (step + 1 < nsteps) load(t, c0);\n    TMARK(3);\n"
                "    tile_product(As, Bs, acc, ty, tx);\n    TMARK(4);\n"
                "    __syncthreads();\n    TMARK(5);\n")
    body = _sub(body, _TAIL, "  TMARK(0);\n  if (tid == 0) TFLUSH();\n"
                + _TAIL)
    return src[:i] + body + src[j:] + _READERS


def instrumented_f32_source() -> str:
    """conv_bwd_f32.cu with the phase probes in its kernel."""
    src = (_build.CSRC / "conv_bwd_f32.cu").read_text()
    src = _sub(src, '#include "f32_tile.cuh"',
               '#include "f32_tile.cuh"\n' + _PROBES)
    tid = "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
    src = _sub(src, tid, tid + "  TSTART\n")
    src = _sub(src, "  Walk walk;\n", "  TMARK(7);\n  Walk walk;\n")
    wait = "    mbar_wait(&bars[step % S], (step / S) & 1);\n"
    src = _sub(src, wait, "    TMARK(1);\n" + wait + "    TMARK(2);\n")
    bar = "    // the folded tile whole, and every thread done with the stage"
    src = _sub(src, bar, "    TMARK(3);\n" + bar)
    fetch = "    if (tid == 0 && step + S - 1 < nsteps) fetch(step + S - 1);\n"
    src = _sub(src, fetch, fetch + "    TMARK(4);\n")
    end = "  }\n  __syncthreads();  // every product has read its stage\n"
    src = _sub(src, end, "    TMARK(5);\n" + end)
    src = _sub(src, _TAIL, "  TMARK(0);\n  if (tid == 0) TFLUSH();\n" + _TAIL)
    return src + _READERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_f32_phases: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"simt": instrumented_simt_source(),
                   "f32": instrumented_f32_source()}
        procs = {}
        for name, text in sources.items():
            cu, so = f"{tmp}/{name}.cu", f"{tmp}/{name}.so"
            pathlib.Path(cu).write_text(text)
            procs[name] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                 str(_build.CSRC), "-o", so, cu]))
        libs = {}
        for name, (so, proc) in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for the instrumented {name}")
            libs[name] = ctypes.CDLL(so)
    fns = {"simt": libs["simt"].mxtpu_conv_bwd_dx,
           "f32": libs["f32"].mxtpu_conv_bwd_dx_f32}
    for key, fn in (("dx", fns["simt"]), ("dx_f32", fns["f32"])):
        ref = fc._kernel(key)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    buf = (ctypes.c_ulonglong * 10)()
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    for case in cs.CONV_CASES:
        if args.batch is not None:
            case = (case[0] + f"_B{args.batch}", args.batch) + case[2:]
        _, _, _, _, _, _, stride, pad, _, _, _ = cs._conv_dims(case)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t = cs._conv_inputs(case, torch.float32, dev, gen)
        rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"),
                   g=t.get("g"))
        fargs = (t["x"], t["w"], t.get("a"), t.get("b"), stride, pad, True)
        y = fc.fused_conv_reference(*fargs, r=rkw["r"], ar=rkw["ar"],
                                    br=rkw["br"])[0]
        bargs = fargs[:4] + (y, t["dy"], t["ds"], t["dss"], stride, pad,
                             True)
        ms = {}
        for route, key, phases in (("simt", "dx", SIMT_PHASES),
                                   ("f32", "dx_f32", F32_PHASES)):
            saved = fc._fns[key]
            fc._fns[key] = fns[route]
            lib = libs[route]
            try:
                fc.conv_bwd_dx(*bargs, route=route, **rkw)
                torch.cuda.synchronize()
                lib.phase_reset()
                fc.conv_bwd_dx(*bargs, route=route, **rkw)
                torch.cuda.synchronize()
                lib.phase_read(buf)
            finally:
                fc._fns[key] = saved
            vals = list(buf)
            blocks = max(1, vals[8])
            print(f"{case[0]} fp32 dx {route}: {vals[8]} blocks; mean "
                  "cycles per block " + ", ".join(
                      f"{ph}={vals[slot] / blocks:.0f}"
                      for ph, slot in phases), flush=True)
            ms[route] = cs.device_ms(
                lambda: fc.conv_bwd_dx(*bargs, route=route, **rkw))
        print(f"{case[0]} fp32 dx: simt {ms['simt']:.5f} ms, f32 "
              f"{ms['f32']:.5f} ms (CUDA-graph replay)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
