// scale: y = x * factor over n floats. Compiled at run time by
// mx.rtc.CudaModule (NVRTC, sm_90a) from ops/rtc_kernels.py.
//
// The CUDA counterpart of the Pallas kernel `_scale_kernel` that the JAX
// package's tests/test_rtc.py launches through rtc.py:66
// `PallasKernel._launch_fn`. Bound by bytes: each element is read once and
// written once (8 bytes), so at 3.35 TB/s n = 163,037,184 takes at least
// 0.389 ms. A grid-stride loop of coalesced scalar loads: the caller sizes
// the grid to fill the card, and any n works.
extern "C" __global__ void scale(const float *x, float *y, float factor,
                                 int n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = x[i] * factor;
  }
}
