#!/usr/bin/env python3
"""Where the tensor-core conv kernels spend their cycles.

    python3 tools/torch_conv_tc_phases.py [--batch N]

Builds instrumented copies of ``incubator_mxnet_tpu_torch/csrc/
fused_conv_tc.cu`` and ``conv_bwd_tc.cu`` (in a temporary directory; the
package's own libraries are untouched) in which thread 0 of every block
reads ``clock64()`` at the phase boundaries of its main loop, and sums the
cycles per phase over the blocks: ``setup`` (barriers, per-thread
constants), per step ``pre`` (the step's tap or box, the per-channel
operands of the fold or the prologue), ``wait_full`` (the TMA loads of the
stage), ``transform`` (the in-place fold and prologue rewrite of the
tiles; none in a plain forward), ``fence_bar`` (``fence.proxy.async`` and
the warpgroup barrier), ``mma`` (issuing the wgmma, waiting for the
previous step's, giving the stage back), and ``tail`` (the epilogue). Runs
K1, K2 and K3 once each in bf16 at ``chip_smoke.CONV_CASES``' ResNet-50
shapes (their batch, or ``--batch``) and prints the mean cycles per block.
Needs ``nvcc`` and a card.
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

PHASES = ("tail", "pre", "wait_full", "transform", "fence_bar", "mma",
          "setup")
_SLOT = {"tail": 0, "pre": 1, "wait_full": 2, "transform": 3,
         "fence_bar": 4, "mma": 5, "setup": 7}

_PROBES = r'''
__device__ unsigned long long g_phase[3][10];
#define TSTART long long t_last = clock64(); long long t_acc[8] = {};
#define TMARK(i) do { long long t_now = clock64(); \
    t_acc[i] += t_now - t_last; t_last = t_now; } while (0)
#define TFLUSH(k) do { for (int q = 0; q < 8; ++q) \
    atomicAdd(&g_phase[k][q], (unsigned long long)t_acc[q]); \
    atomicAdd(&g_phase[k][8], 1ull); } while (0)
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
        raise RuntimeError(f"a tensor-core source changed: no "
                           f"{old.strip()!r}")
    return text.replace(old, new, 1)


def instrumented_fwd_source() -> str:
    """fused_conv_tc.cu with the phase probes in K1 (slot 2)."""
    src = (_build.CSRC / "fused_conv_tc.cu").read_text()
    src = _sub(src, '#include "tc_common.cuh"',
               '#include "tc_common.cuh"\n' + _PROBES)
    src = _sub(src, "  const int tid = threadIdx.x;",
               "  const int tid = threadIdx.x;\n  TSTART")
    src = _sub(src, "  float acc[BN / 2];", "  TMARK(7);\n  float acc[BN / 2];")
    src = _sub(src, "    mbar_wait(&full[st], round & 1);",
               "    TMARK(1);\n    mbar_wait(&full[st], round & 1);\n"
               "    TMARK(2);")
    src = _sub(src, "      fence_proxy_async();\n      sync_consumers();",
               "      TMARK(3);\n      fence_proxy_async();\n"
               "      sync_consumers();\n      TMARK(4);")
    arrive = "    if (step > 0) mbar_arrive(&empty[(step - 1) % kStages]);\n"
    src = _sub(src, arrive + "  }", arrive + "    TMARK(5);\n  }")
    src = _sub(src, "  if (split) return;  // uniform over the grid",
               "  TMARK(0);\n  if (tid == 0) TFLUSH(2);\n"
               "  if (split) return;  // uniform over the grid")
    return src + _READERS


def instrumented_source() -> str:
    """conv_bwd_tc.cu with the phase probes in both kernels."""
    src = (_build.CSRC / "conv_bwd_tc.cu").read_text()
    src = _sub(src, '#include "tc_common.cuh"',
               '#include "tc_common.cuh"\n' + _PROBES)
    i2 = src.index("conv_bwd_dx_tc_kernel(")
    i3 = src.index("conv_bwd_dw_tc_kernel(")
    i4 = src.index("// host: tensor maps")
    bodies = []
    for k, body in ((0, src[i2:i3]), (1, src[i3:i4])):
        body = _sub(body, "  const int tid = threadIdx.x;",
                    "  const int tid = threadIdx.x;\n  TSTART")
        acc = "  float acc[BN / 2];" if k == 0 else "  float acc[T][32];"
        body = _sub(body, acc, "  TMARK(7);\n" + acc)
        body = _sub(body, "    mbar_wait(&full[st], round & 1);",
                    "    TMARK(1);\n    mbar_wait(&full[st], round & 1);\n"
                    "    TMARK(2);")
        body = _sub(body, "    fence_proxy_async();\n    sync_consumers();",
                    "    TMARK(3);\n    fence_proxy_async();\n"
                    "    sync_consumers();\n    TMARK(4);")
        ring = "kS" if k == 0 else "kStages"
        arrive = ("    if (step > 0) mbar_arrive(&empty[(step - 1) % "
                  f"{ring}]);\n")
        body = _sub(body, arrive + "  }", arrive + "    TMARK(5);\n  }")
        if k == 0:
            body = _sub(body, "  if (!pro) return;  // uniform over the "
                              "block: no sums to take",
                        "  TMARK(0);\n  if (tid == 0) TFLUSH(0);\n"
                        "  if (!pro) return;  // uniform over the block: "
                        "no sums to take")
        else:
            end = body.rindex("\n}\n")
            body = body[:end] + "\n  TMARK(0);\n  if (tid == 0) TFLUSH(1);" \
                + body[end:]
        bodies.append(body)
    return src[:i2] + bodies[0] + bodies[1] + src[i4:] + _READERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_tc_phases: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"bwd": instrumented_source(),
                   "fwd": instrumented_fwd_source()}
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib, flib = libs["bwd"], libs["fwd"]
    dx, dw = lib.mxtpu_conv_bwd_dx_tc, lib.mxtpu_conv_bwd_dw_tc
    fwd = flib.mxtpu_fused_conv_tc
    dx.argtypes = [p] * 18 + [i] * 17 + [p]
    dw.argtypes = [p] * 12 + [i] * 17 + [p]
    fwd.argtypes = [p] * 13 + [i] * 18 + [p]
    dx.restype = dw.restype = fwd.restype = i
    saved = dict(fc._fns)
    fc._fns["dx_tc"], fc._fns["dw_tc"], fc._fns["fwd_tc"] = dx, dw, fwd
    buf = (ctypes.c_ulonglong * 30)()
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    try:
        for case in cs.CONV_CASES[:6]:
            if args.batch is not None:
                case = (case[0] + f"_B{args.batch}", args.batch) + case[2:]
            _, _, _, _, _, _, stride, pad, _, _, _ = cs._conv_dims(case)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            t = cs._conv_inputs(case, torch.bfloat16, dev, gen)
            rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
            fargs = (t["x"], t["w"], t.get("a"), t.get("b"), stride, pad,
                     True)
            y = fc.fused_conv_reference(*fargs, **rkw)[0]
            bargs = fargs[:4] + (y, t["dy"], t["ds"], t["dss"], stride, pad,
                                 True)
            res = case[-1] == "res"
            runs = (("fwd", 2, flib, lambda: fc.fused_conv(
                        *fargs, emit=res, **rkw)),
                    ("dx", 0, lib, lambda: fc.conv_bwd_dx(
                        *bargs, g=t.get("g"), **rkw)),
                    ("dw", 1, lib, lambda: fc.conv_bwd_dw(*bargs, **rkw)))
            for name, k, which, run in runs:
                run()
                torch.cuda.synchronize()
                which.phase_reset()
                run()
                torch.cuda.synchronize()
                which.phase_read(buf)
                vals = list(buf)[10 * k:10 * k + 10]
                blocks = max(1, vals[8])
                print(f"{case[0]} {name}: {blocks} blocks; mean cycles per "
                      "block " + ", ".join(
                          f"{ph}={vals[_SLOT[ph]] / blocks:.0f}"
                          for ph in PHASES), flush=True)
    finally:
        fc._fns.clear()
        fc._fns.update(saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
