// saxpy: out = a * alpha + b over n floats. Compiled at run time by
// mx.rtc.CudaModule (NVRTC, sm_90a, --fmad=false) from ops/rtc_kernels.py.
//
// The CUDA counterpart of the Pallas kernel `_saxpy_kernel` (a * 2.0 + b)
// that the JAX package's tests/test_rtc.py launches through rtc.py:66
// `PallasKernel._launch_fn`, with alpha an argument. Compiled without FMA
// contraction, so the product is rounded before the sum as in the plain
// version (two rounded torch ops), and the two agree bit for bit. Bound by
// bytes: two reads and one write of 4 bytes per element, at least 0.584 ms
// for n = 163,037,184 at 3.35 TB/s. Grid-stride loop, scalar loads.
extern "C" __global__ void saxpy(const float *a, const float *b, float *out,
                                 float alpha, int n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = a[i] * alpha + b[i];
  }
}
