#!/usr/bin/env python3
"""What one warp's 16-byte shared-memory load (LDS.128) costs on this card,
by the pattern of addresses its 32 lanes read.

    python3 tools/torch_lds_wavefronts.py

Builds a probe kernel (in a temporary directory, with the package's
``nvcc`` flags) in which every warp of a 1024-thread block runs a long
run of independent ``ld.shared.v4.f32`` at one pattern, and prints the
SM's clock cycles per warp-wide load. The patterns are the ones the fp32
micro-tile kernels (``csrc/flash_bwd_f32.cu``, ``csrc/flash_fwd_f32.cu``,
``csrc/fused_conv_f32.cu``, ``csrc/conv_bwd_f32.cu``) read with:
``a_rows`` (4 distinct 16-byte chunks in 4 bank quads, 8 lanes on each: a
micro-tile's A rows; the conv K3's dy chunks), ``b_rows`` (8 distinct
chunks in the 8 bank quads, 4 lanes on each: its B rows, the second
products' B chunks, the conv K1's w rows and K3's x chunks); and, to read
them
against, ``broadcast`` (one chunk), ``distinct`` (32 chunks, 512
contiguous bytes) and ``conflict4`` (4 chunks in one bank quad). About 1
cycle a load means one wavefront; 4 means the hardware serves the warp in
four passes. Needs ``nvcc`` and a card.
"""

from __future__ import annotations

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

# the 16-byte chunk each lane reads (bank quad = chunk % 8)
PATTERNS = {
    "a_rows": "lane >> 3",
    "b_rows": "lane & 7",
    "broadcast": "0",
    "distinct": "lane",
    "conflict4": "(lane >> 3) * 8",
}

_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

template <int P>
__device__ __forceinline__ int chunk_of(int lane) {
  %(cases)s
}

template <int P>
__global__ void __launch_bounds__(1024, 1)
lds_probe(float* out, long long* cycles, int iters) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // 16 independent loads a step, each 64 chunks (1 KB, the same bank
  // quads) past the last
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(
      buf + chunk_of<P>(lane)));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      float x, y, z, w;
      asm volatile("ld.shared.v4.f32 {%%0, %%1, %%2, %%3}, [%%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                   : "r"(base + ((u + it) & 31) * 1024));
      acc[u & 3] += x;  // one add a load: the loads set the pace
      (void)y, (void)z, (void)w;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      acc[0] + acc[1] + acc[2] + acc[3];
}

extern "C" int lds_run(int pattern, float* out, long long* cycles,
                       int blocks, int iters) {
  switch (pattern) {
%(launches)s
  }
  return (int)cudaDeviceSynchronize();
}
'''


def source() -> str:
    cases = "\n  ".join(
        f"if constexpr (P == {i}) return {expr};"
        for i, expr in enumerate(PATTERNS.values())) + "\n  return 0;"
    launches = "\n".join(
        f"    case {i}: lds_probe<{i}><<<blocks, 1024>>>(out, cycles, "
        "iters); break;" for i in range(len(PATTERNS)))
    return _SOURCE % {"cases": cases, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lds_wavefronts: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = f"{tmp}/lds_probe.cu", f"{tmp}/lds_probe.so"
        pathlib.Path(cu).write_text(source())
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                        cu], check=True)
        lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lds_run.argtypes = [i, p, p, i, i]
    lib.lds_run.restype = i
    dev = torch.device("cuda", 0)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    iters, warps = 4096, 32
    out = torch.empty(blocks * 1024, device=dev)
    cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
    for k, name in enumerate(PATTERNS):
        for _ in range(2):                       # the second run counts
            err = lib.lds_run(k, out.data_ptr(), cycles.data_ptr(), blocks,
                              iters)
            if err:
                raise RuntimeError(f"lds_probe {name}: CUDA error {err}")
        per = cycles.double().mean().item() / (warps * iters * 16)
        print(f"{name} ({PATTERNS[name]}): {per:.3f} cycles per warp-wide "
              f"LDS.128 on one SM ({warps} warps, {iters * 16} loads each)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
