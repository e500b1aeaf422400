// saxpy: out = a * alpha + b over n floats. Compiled at run time by
// mx.rtc.CudaModule (NVRTC, sm_90a, --fmad=false) from ops/rtc_kernels.py.
//
// The CUDA counterpart of the Pallas kernel `_saxpy_kernel` (a * 2.0 + b)
// that the JAX package's tests/test_rtc.py launches through rtc.py:66
// `PallasKernel._launch_fn`, with alpha an argument. Compiled without FMA
// contraction, so the product is rounded before the sum as in the plain
// version (two rounded torch ops), and the two agree bit for bit. Bound by
// bytes: two reads and one write of 4 bytes per element, at least 0.584 ms
// for n = 163,037,184 at 3.35 TB/s.
//
// The layout of scale.cu: a block takes a tile of 4 * blockDim.x
// contiguous floats per step of a grid-stride loop, so any grid is right;
// the caller launches one tile a block (ops/rtc_kernels.py `saxpy_plan`).
// When a, b and out share their 16-byte alignment phase: a scalar head up
// to the first 16-byte boundary, one 16-byte load of each input and one
// 16-byte store a thread a step, a scalar tail (head and tail under 4
// floats each, also walked grid-stride). When they do not (a view at
// another offset): four floats a thread, blockDim.x apart.

__device__ __forceinline__ float4 load4(const float4 *p) { return *p; }

__device__ __forceinline__ void store4(float4 *p, float4 v) { *p = v; }

__device__ __forceinline__ float4 axpy4(float4 a, float4 b, float alpha) {
  return make_float4(a.x * alpha + b.x, a.y * alpha + b.y,
                     a.z * alpha + b.z, a.w * alpha + b.w);
}

extern "C" __global__ void saxpy(const float *a, const float *b, float *out,
                                 float alpha, int n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const unsigned pa = reinterpret_cast<unsigned long long>(a) & 15;
  if (pa != (reinterpret_cast<unsigned long long>(b) & 15) ||
      pa != (reinterpret_cast<unsigned long long>(out) & 15)) {
    const long long tile = 4ll * blockDim.x;
    for (long long base = blockIdx.x * tile; base < n;
         base += gridDim.x * tile) {
      float va[4], vb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = base + k * blockDim.x + threadIdx.x;
        if (i < n) {
          va[k] = a[i];
          vb[k] = b[i];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = base + k * blockDim.x + threadIdx.x;
        if (i < n) out[i] = va[k] * alpha + vb[k];
      }
    }
    return;
  }
  const int head = min(n, (int)((16 - pa) & 15) >> 2);
  const long long n4 = (n - head) >> 2;
  const float4 *a4 = reinterpret_cast<const float4 *>(a + head);
  const float4 *b4 = reinterpret_cast<const float4 *>(b + head);
  float4 *out4 = reinterpret_cast<float4 *>(out + head);
  for (long long i = tid; i < n4; i += threads)
    store4(out4 + i, axpy4(load4(a4 + i), load4(b4 + i), alpha));
  for (long long i = tid; i < head; i += threads) out[i] = a[i] * alpha + b[i];
  for (long long i = head + 4 * n4 + tid; i < n; i += threads)
    out[i] = a[i] * alpha + b[i];
}
