// scale: y = x * factor over n floats. Compiled at run time by
// mx.rtc.CudaModule (NVRTC, sm_90a) from ops/rtc_kernels.py.
//
// The CUDA counterpart of the Pallas kernel `_scale_kernel` that the JAX
// package's tests/test_rtc.py launches through rtc.py:66
// `PallasKernel._launch_fn`. Bound by bytes: each element is read once and
// written once (8 bytes), so at 3.35 TB/s n = 163,037,184 takes at least
// 0.389 ms.
//
// A block takes a tile of 4 * blockDim.x contiguous floats per step of a
// grid-stride loop, so any grid is right; the caller launches one tile a
// block (ops/rtc_kernels.py `scale_plan`), so the blocks in flight cover
// one window of memory. When x and y share their 16-byte alignment phase:
// a scalar head up to x's first 16-byte boundary, one 16-byte load and
// store a thread a step, a scalar tail (head and tail under 4 floats
// each, also walked grid-stride). When they do not (a view at another
// offset): four floats a thread, blockDim.x apart. One product per
// element, so y equals x * factor bit for bit. On an NVIDIA H100 80GB HBM3
// at 700 W this takes 0.431 ms against torch.mul's 0.433, where the scalar
// grid-stride kernel it replaces took 0.537 (tools/torch_rtc_times.py,
// both in one run), and 0.467 on a grid of one wave of resident blocks
// (tools/torch_rtc_designs.py).

__device__ __forceinline__ float4 mul(float4 v, float f) {
  return make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
}

extern "C" __global__ void scale(const float *x, float *y, float factor,
                                 int n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const unsigned ax = reinterpret_cast<unsigned long long>(x) & 15;
  if (ax != (reinterpret_cast<unsigned long long>(y) & 15)) {
    const long long tile = 4ll * blockDim.x;
    for (long long base = blockIdx.x * tile; base < n;
         base += gridDim.x * tile) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = base + k * blockDim.x + threadIdx.x;
        if (i < n) v[k] = x[i];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = base + k * blockDim.x + threadIdx.x;
        if (i < n) y[i] = v[k] * factor;
      }
    }
    return;
  }
  const int head = min(n, (int)((16 - ax) & 15) >> 2);
  const long long n4 = (n - head) >> 2;
  const float4 *x4 = reinterpret_cast<const float4 *>(x + head);
  float4 *y4 = reinterpret_cast<float4 *>(y + head);
  for (long long i = tid; i < n4; i += threads) y4[i] = mul(x4[i], factor);
  for (long long i = tid; i < head; i += threads) y[i] = x[i] * factor;
  for (long long i = head + 4 * n4 + tid; i < n; i += threads)
    y[i] = x[i] * factor;
}
