#!/usr/bin/env python3
"""Time K7's ``saxpy`` under each design tried for it, in one run.

    python3 tools/torch_saxpy_designs.py [--seed 0] [--reps 3]

Needs a card. Over 163,037,184 floats (the imperative path's flat vector,
``chip_smoke.RTC_FLAT``), ``out = a * 2 + b``, each design compiled by
``mx.rtc.CudaModule`` with ``--fmad=false`` and held bit for bit against
``saxpy_reference`` before it is timed:

* ``committed``: ``csrc/rtc/saxpy.cu`` as ``saxpy_plan`` launches it (a
  16-byte quad of each operand a thread, one 1024-float tile a block);
* ``one_wave``: the same kernel on a grid of one wave of resident blocks
  (8 blocks of 256 threads an SM), its grid-stride loop walking the rest;
* ``evict_first``: the committed kernel with its quad loads and stores
  marked evict-first (``ld.global.cs.v4.f32``, ``st.global.cs.v4.f32``):
  the stream is 1.96 GB, far past the 50 MB L2;
* ``scalar``: the kernel it replaced (one float a thread, a grid-stride
  loop over at most 16 blocks of 256 threads an SM);

beside ``torch.add(b, a, alpha=2)`` and the byte bound (two reads and one
write of 4 bytes an element at 3.35 TB/s). The designs take ``--reps``
turns, each timed as ``chip_smoke.device_ms`` times (CUDA-graph replay).
Prints one line per turn and one JSON line. Runs against the package
beside it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

N = 163_037_184
SCALAR = r'''
extern "C" __global__ void saxpy(const float *a, const float *b, float *out,
                                 float alpha, int n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = a[i] * alpha + b[i];
  }
}
'''
EVICT_FIRST = (
    ("__device__ __forceinline__ float4 load4(const float4 *p) "
     "{ return *p; }",
     "__device__ __forceinline__ float4 load4(const float4 *p) {\n"
     "  float4 v;\n"
     "  asm volatile(\"ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];\"\n"
     "               : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), \"=f\"(v.w)\n"
     "               : \"l\"(p));\n"
     "  return v;\n}"),
    ("__device__ __forceinline__ void store4(float4 *p, float4 v) "
     "{ *p = v; }",
     "__device__ __forceinline__ void store4(float4 *p, float4 v) {\n"
     "  asm volatile(\"st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\"\n"
     "               :: \"l\"(p), \"f\"(v.x), \"f\"(v.y), \"f\"(v.z),\n"
     "                  \"f\"(v.w) : \"memory\");\n}"))


def _once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"saxpy.cu changed: {old!r} is not there once; "
                           "update the design's anchors")
    return text.replace(old, new)


def evict_first_source():
    src = (ROOT / "incubator_mxnet_tpu_torch" / "csrc" / "rtc"
           / "saxpy.cu").read_text()
    for old, new in EVICT_FIRST:
        src = _once(src, old, new)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_saxpy_designs: no CUDA device", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    dev, ctx = torch.device("cuda", 0), mx.gpu(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    card = cs.card_line()
    print(card, flush=True)
    a, b = (NDArray(torch.randn(N, generator=gen, device=dev))
            for _ in range(2))
    out = NDArray(torch.empty(N, device=dev))
    want = rk.saxpy_reference(a.as_torch(), b.as_torch(), 2.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sig = rk.KERNELS["saxpy"].signature
    opts = rk.KERNELS["saxpy"].options
    plan = rk.saxpy_plan(N)
    designs = {
        "committed": (rk.kernel("saxpy"), plan),
        "one_wave": (rk.kernel("saxpy"), ((sms * 8, 1, 1), plan[1])),
        "evict_first": (mx.rtc.CudaModule(evict_first_source(),
                                          options=opts).get_kernel(
                                              "saxpy", sig), plan),
        "scalar": (mx.rtc.CudaModule(SCALAR, options=opts).get_kernel(
            "saxpy", sig), ((min(-(-N // 256), sms * 16), 1, 1),
                            (256, 1, 1))),
    }
    calls = {}
    for name, (k, (grid, block)) in designs.items():
        def launch(k=k, grid=grid, block=block):
            k.launch([a, b, out, 2.0, N], ctx, grid, block)
        out.as_torch().zero_()
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out.as_torch(), want):
            raise AssertionError(f"saxpy design {name} differs from its "
                                 "plain version")
        calls[name] = launch
    calls["torch_add"] = lambda: torch.add(b.as_torch(), a.as_torch(),
                                           alpha=2.0)
    bound = 3 * N * 4 / cs.HBM_BYTES_PER_S * 1e3
    times = {name: [] for name in calls}
    for rep in range(args.reps):
        for name, fn in calls.items():
            times[name].append(cs.device_ms(fn))
        print(f"turn {rep}: " + ", ".join(
            f"{name} {t[-1]:.5f}" for name, t in times.items())
            + f" ms; bound {bound:.5f} ms", flush=True)
    grids = {name: g[0] for name, (_, (g, _)) in designs.items()}
    print(json.dumps({"card": card, "n": N, "bound_ms": bound,
                      "grids": grids, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
