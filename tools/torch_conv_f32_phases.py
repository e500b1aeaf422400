#!/usr/bin/env python3
"""Where the fp32 conv kernels K1 (forward), K2 (input gradient) and K3
(weight gradient) spend their cycles: the SIMT kernels of
``csrc/fused_conv.cu`` and ``csrc/conv_bwd.cu`` and the register
micro-tile kernels of ``csrc/fused_conv_f32.cu`` and
``csrc/conv_bwd_f32.cu``, on the same inputs.

    python3 tools/torch_conv_f32_phases.py [--batch N]

Builds instrumented copies of the four sources (in a temporary directory;
the package's own libraries are untouched) in which thread 0 of every
block reads ``clock64()`` at the phase boundaries of its main loop, and
prints the mean cycles per block of each phase. The SIMT kernels:
``setup``, per step ``store`` (the wait for the previous step's gathered
loads, the prologue or the fold, and the transposing stores to shared
memory), ``bar1`` (the barrier after them), ``load`` (issuing the next
step's loads), ``product`` (the 64x64 tile step) and ``bar2`` (the barrier
after it), and ``tail`` (the epilogue). The f32 kernels: ``setup``, per
step ``pre`` (the step's tap and channels and the per-channel operands it
reads), ``wait`` (the stage's TMA loads), ``rewrite`` (the fold of dy, or
the prologue of x, in place), ``bar`` (the barrier, and thread 0 starting
a stage's loads), ``product`` (the micro-tile step), and ``tail`` (the
epilogue). Runs each kernel in fp32 at
``chip_smoke.CONV_CASES`` (their batch, or ``--batch``), then times both
routes there (CUDA-graph replay). Needs ``nvcc`` and a card.
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

# (name, clock64 slot) of each route's phases, in the order printed
SIMT_PHASES = (("setup", 7), ("store", 1), ("bar1", 2), ("load", 3),
               ("product", 4), ("bar2", 5), ("tail", 0))
F32_PHASES = (("setup", 7), ("pre", 1), ("wait", 2), ("rewrite", 3),
              ("bar", 4), ("product", 5), ("tail", 0))

_PROBES = r"""
__device__ unsigned long long g_phase[10];
#define TSTART long long t_last = clock64(); long long t_acc[8] = {};
#define TMARK(i) do { long long t_now = clock64(); \
    t_acc[i] += t_now - t_last; t_last = t_now; } while (0)
#define TFLUSH() do { for (int q = 0; q < 8; ++q) \
    atomicAdd(&g_phase[q], (unsigned long long)t_acc[q]); \
    atomicAdd(&g_phase[8], 1ull); } while (0)
"""

_READERS = r"""
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_reset() {
  unsigned long long z[10] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));
}
"""

_FLUSH = "  TMARK(0);\n  if (tid == 0) TFLUSH();\n"
_SIMT_TID = "  const int tid = threadIdx.x;\n"
_F32_TID = "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
_F32_WAIT = "    mbar_wait(&bars[step % S], (step / S) & 1);\n"
_F32_LOOP = ("  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);\n"
             "  for (int step = 0; step < nsteps; ++step) {\n")
_NEXT = "    if (tid == 0 && step + 1 < nsteps) fetch(step + 1);\n"
_SIMT_STORE = "    __syncthreads();\n"

# Each kernel's body, from the text that starts it to the text after it,
# and the (old, new) probes put into it, each old text once.
KERNELS = {
    ("fused_conv", "simt"): ("fused_conv.cu", "fused_conv_fwd_kernel(",
                             "template <typename T>\nint launch(", [
        (_SIMT_TID, _SIMT_TID + "  TSTART\n"),
        ("  int tap = 0, c0 = 0;\n", "  TMARK(7);\n  int tap = 0, c0 = 0;\n"),
        ("    store(c0);\n" + _SIMT_STORE,
         "    store(c0);\n    TMARK(1);\n" + _SIMT_STORE + "    TMARK(2);\n"),
        ("    if (step + 1 < nsteps) load(tap, c0);\n"
         "    tile_product(As, Bs, acc, ty, tx);\n" + _SIMT_STORE,
         "    if (step + 1 < nsteps) load(tap, c0);\n    TMARK(3);\n"
         "    tile_product(As, Bs, acc, ty, tx);\n    TMARK(4);\n"
         + _SIMT_STORE + "    TMARK(5);\n"),
        ("col] = t;\n  }\n}\n", "col] = t;\n  }\n" + _FLUSH + "}\n")]),
    ("conv_bwd_dx", "simt"): ("conv_bwd.cu", "conv_bwd_dx_kernel(",
                              "conv_bwd_dw_kernel(", [
        (_SIMT_TID, _SIMT_TID + "  TSTART\n"),
        ("  int t = 0, c0 = 0;\n", "  TMARK(7);\n  int t = 0, c0 = 0;\n"),
        ("    store(c0);\n" + _SIMT_STORE,
         "    store(c0);\n    TMARK(1);\n" + _SIMT_STORE + "    TMARK(2);\n"),
        ("    if (step + 1 < nsteps) load(t, c0);\n"
         "    tile_product(As, Bs, acc, ty, tx);\n" + _SIMT_STORE,
         "    if (step + 1 < nsteps) load(t, c0);\n    TMARK(3);\n"
         "    tile_product(As, Bs, acc, ty, tx);\n    TMARK(4);\n"
         + _SIMT_STORE + "    TMARK(5);\n"),
        ("  if (!pro) return;", _FLUSH + "  if (!pro) return;")]),
    ("conv_bwd_dw", "simt"): ("conv_bwd.cu", "conv_bwd_dw_kernel(",
                              "template <typename T>\nint launch_dx(", [
        (_SIMT_TID, _SIMT_TID + "  TSTART\n"),
        ("  if (nsteps > 0) load(k_begin);\n",
         "  TMARK(7);\n  if (nsteps > 0) load(k_begin);\n"),
        ("    store();\n" + _SIMT_STORE,
         "    store();\n    TMARK(1);\n" + _SIMT_STORE + "    TMARK(2);\n"),
        ("    tile_product(As, Bs, acc, ty, tx);\n" + _SIMT_STORE,
         "    TMARK(3);\n    tile_product(As, Bs, acc, ty, tx);\n"
         "    TMARK(4);\n" + _SIMT_STORE + "    TMARK(5);\n"),
        ("= acc[i][j];\n    }\n  }\n}\n",
         "= acc[i][j];\n    }\n  }\n" + _FLUSH + "}\n")]),
    ("fused_conv", "f32"): ("fused_conv_f32.cu", "fused_conv_f32_kernel(",
                            "tile_stats_kernel(", [
        (_F32_TID, _F32_TID + "  TSTART\n"),
        (_F32_LOOP, "  TMARK(7);\n" + _F32_LOOP),
        (_F32_WAIT, "    TMARK(1);\n" + _F32_WAIT + "    TMARK(2);\n"),
        ("    // the rewritten tile whole",
         "    TMARK(3);\n    // the rewritten tile whole"),
        (_NEXT, _NEXT + "    TMARK(4);\n"),
        ("  }\n  __syncthreads();  // every product has read its stage\n",
         "    TMARK(5);\n  }\n  __syncthreads();  // every product has read "
         "its stage\n"),
        ("        v.z, v.w);\n  }\n}\n", "        v.z, v.w);\n  }\n" + _FLUSH
         + "}\n")]),
    ("conv_bwd_dx", "f32"): ("conv_bwd_f32.cu", "conv_bwd_dx_f32_kernel(",
                             "// K3: dW", [
        (_F32_TID, _F32_TID + "  TSTART\n"),
        ("  Walk walk;\n", "  TMARK(7);\n  Walk walk;\n"),
        (_F32_WAIT, "    TMARK(1);\n" + _F32_WAIT + "    TMARK(2);\n"),
        ("    // the folded tile whole", "    TMARK(3);\n"
         "    // the folded tile whole"),
        ("    if (tid == 0 && step + S - 1 < nsteps) fetch(step + S - 1);\n",
         "    if (tid == 0 && step + S - 1 < nsteps) fetch(step + S - 1);\n"
         "    TMARK(4);\n"),
        ("  }\n  __syncthreads();  // every product has read its stage\n",
         "    TMARK(5);\n  }\n  __syncthreads();  // every product has read "
         "its stage\n"),
        ("  if (!pro) return;", _FLUSH + "  if (!pro) return;")]),
    ("conv_bwd_dw", "f32"): ("conv_bwd_f32.cu", "conv_bwd_dw_f32_kernel(",
                             "// host: tensor maps", [
        (_F32_TID, _F32_TID + "  TSTART\n"),
        (_F32_LOOP, "  TMARK(7);\n" + _F32_LOOP),
        (_F32_WAIT, "    TMARK(1);\n" + _F32_WAIT + "    TMARK(2);\n"),
        ("    // the rewritten tiles whole",
         "    TMARK(3);\n    // the rewritten tiles whole"),
        (_NEXT, _NEXT + "    TMARK(4);\n"),
        ("  }\n\n  // the block's tiles of dW",
         "    TMARK(5);\n  }\n\n  // the block's tiles of dW"),
        ("            acc[t][i][2], acc[t][i][3]);\n    }\n  }\n}\n",
         "            acc[t][i][2], acc[t][i][3]);\n    }\n  }\n" + _FLUSH
         + "}\n")]),
}
# each kernel's key in fused_conv._fns and its C entry point
ENTRIES = {("fused_conv", "simt"): ("fwd", "mxtpu_fused_conv_fwd"),
           ("fused_conv", "f32"): ("fwd_f32", "mxtpu_fused_conv_f32"),
           ("conv_bwd_dx", "simt"): ("dx", "mxtpu_conv_bwd_dx"),
           ("conv_bwd_dx", "f32"): ("dx_f32", "mxtpu_conv_bwd_dx_f32"),
           ("conv_bwd_dw", "simt"): ("dw", "mxtpu_conv_bwd_dw"),
           ("conv_bwd_dw", "f32"): ("dw_f32", "mxtpu_conv_bwd_dw_f32")}
SHORT = {"fused_conv": "K1", "conv_bwd_dx": "K2", "conv_bwd_dw": "K3"}


def _sub(text, old, new):
    if text.count(old) < 1:
        raise RuntimeError(f"a conv source changed: no {old.strip()!r}")
    return text.replace(old, new, 1)


def instrumented_source(source, kernels) -> str:
    """``source`` with the phase probes in each of ``kernels`` (keys of
    ``KERNELS`` whose source it is)."""
    src = (_build.CSRC / source).read_text()
    first = src.index('#include "')
    src = src[:first] + src[first:].replace("\n", "\n" + _PROBES, 1)
    for key in kernels:
        _, start, stop, probes = KERNELS[key]
        i = src.index(start)
        j = src.index(stop, i)
        body = src[i:j]
        for old, new in probes:
            body = _sub(body, old, new)
        src = src[:i] + body + src[j:]
    return src + _READERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_f32_phases: no CUDA device", file=sys.stderr)
        return 2
    sources = {}
    for key in KERNELS:
        sources.setdefault(KERNELS[key][0], []).append(key)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for source, kernels in sources.items():
            stem = source[:-3]
            cu, so = f"{tmp}/{stem}.cu", f"{tmp}/{stem}.so"
            pathlib.Path(cu).write_text(instrumented_source(source, kernels))
            procs[source] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                 str(_build.CSRC), "-o", so, cu]))
        for source, (so, proc) in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for the instrumented "
                                   f"{source}")
            for key in sources[source]:
                libs[key] = ctypes.CDLL(so)
    fns = {}
    for key in KERNELS:
        fkey, entry = ENTRIES[key]
        fn = getattr(libs[key], entry)
        ref = fc._kernel(fkey)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        fns[key] = fn
    buf = (ctypes.c_ulonglong * 10)()
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    for case in cs.CONV_CASES:
        if args.batch is not None:
            case = (case[0] + f"_B{args.batch}", args.batch) + case[2:]
        _, _, _, _, _, _, stride, pad, kind, _, _ = cs._conv_dims(case)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t = cs._conv_inputs(case, torch.float32, dev, gen)
        res = kind == "res"
        rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
        fargs = (t["x"], t["w"], t.get("a"), t.get("b"), stride, pad, True)
        y = fc.fused_conv_reference(*fargs, **rkw)[0]
        bargs = fargs[:4] + (y, t["dy"], t["ds"], t["dss"], stride, pad,
                             True)
        calls = {
            "fused_conv": lambda route: fc.fused_conv(
                *fargs, emit=res, route=route, **rkw),
            "conv_bwd_dx": lambda route: fc.conv_bwd_dx(
                *bargs, g=t.get("g"), route=route, **rkw),
            "conv_bwd_dw": lambda route: fc.conv_bwd_dw(
                *bargs, route=route, **rkw)}
        for kernel in SHORT:
            ms = {}
            for route, phases in (("simt", SIMT_PHASES),
                                  ("f32", F32_PHASES)):
                key = (kernel, route)
                fkey = ENTRIES[key][0]
                saved = fc._kernel(fkey)
                fc._fns[fkey] = fns[key]
                lib = libs[key]
                try:
                    calls[kernel](route)
                    torch.cuda.synchronize()
                    lib.phase_reset()
                    calls[kernel](route)
                    torch.cuda.synchronize()
                    lib.phase_read(buf)
                finally:
                    fc._fns[fkey] = saved
                vals = list(buf)
                blocks = max(1, vals[8])
                print(f"{case[0]} fp32 {SHORT[kernel]} {route}: {vals[8]} "
                      "blocks; mean cycles per block " + ", ".join(
                          f"{ph}={vals[slot] / blocks:.0f}"
                          for ph, slot in phases), flush=True)
                ms[route] = cs.device_ms(lambda: calls[kernel](route))
            print(f"{case[0]} fp32 {SHORT[kernel]}: simt {ms['simt']:.5f} "
                  f"ms, f32 {ms['f32']:.5f} ms (CUDA-graph replay)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
