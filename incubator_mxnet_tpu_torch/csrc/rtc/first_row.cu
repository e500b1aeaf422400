// first_row: out = x[0, :] of a row-major (rows, cols) matrix. Compiled at
// run time by mx.rtc.CudaModule (NVRTC, sm_90a) from ops/rtc_kernels.py.
//
// The CUDA counterpart of the Pallas kernel `first_row` of the JAX
// package's tests/test_rtc.py (test_pallas_kernel_explicit_out_shape: an
// explicit out_shape smaller than the input), launched there through
// rtc.py:66 `PallasKernel._launch_fn`. It moves one row in and one row out
// (6 KB at cols = 768): its time is the launch's.
extern "C" __global__ void first_row(const float *x, float *out, int cols) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < cols;
       j += gridDim.x * blockDim.x) {
    out[j] = x[j];
  }
}
