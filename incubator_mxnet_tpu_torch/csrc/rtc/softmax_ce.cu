// The softmax cross-entropy pair of upstream MXNet's
// example/numpy-ops/custom_softmax_rtc.py, used by the CustomOp
// "softmax_ce_rtc" (ops/rtc_kernels.py). Compiled at run time by
// mx.rtc.CudaModule (NVRTC, sm_90a); the launcher names the template
// instances "softmax_ce_fwd<float>" and "softmax_ce_bwd<float>" in
// `exports`, so they are found through NVRTC's lowered names.
//
// They are launched through mx.rtc, the port of rtc.py:66
// `PallasKernel._launch_fn`. Both are bound by bytes: the forward reads
// the logits once and writes the probabilities once, the backward reads
// the probabilities once and writes the gradient once (823.4 MB each at
// (2048, 50257) fp32, at least 0.246 ms each at 3.35 TB/s).
//
// One block per row. A row of V = 50257 floats does not start 16-byte
// aligned (V is odd), so the loads stay scalar: consecutive threads read
// consecutive floats, which coalesces whatever the row's alignment. The
// forward reads its row three times (max, sum of exp, write); a row is
// 201 KB and the blocks in flight share the 50 MB L2, so the second and
// third reads mostly hit it. Block reductions go through shared memory
// (one slot per warp), with no atomics: the result does not depend on
// scheduling. req follows MXNet: 1 writes, 2 adds, 0 leaves y alone.

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's reduction of v, broadcast to every thread. blockDim.x is a
// multiple of 32, at most 1024; `slots` holds 32 floats.
template <bool kMax>
__device__ float block_reduce(float v, float *slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                       // slots free from any earlier use
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  v = lane < warps ? slots[lane] : (kMax ? -__int_as_float(0x7f800000) : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

template <class DType>
__global__ void softmax_ce_fwd(const DType *x, DType *y, const int row_size,
                               const int req) {
  __shared__ float slots[32];
  const DType *xr = x + (long long)blockIdx.x * row_size;
  DType *yr = y + (long long)blockIdx.x * row_size;
  float m = -__int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < row_size; i += blockDim.x)
    m = fmaxf(m, (float)xr[i]);
  m = block_reduce<true>(m, slots);
  float s = 0.f;
  for (int i = threadIdx.x; i < row_size; i += blockDim.x)
    s += expf((float)xr[i] - m);
  s = block_reduce<false>(s, slots);
  if (req == 0) return;
  for (int i = threadIdx.x; i < row_size; i += blockDim.x) {
    const float p = expf((float)xr[i] - m) / s;
    if (req == 1) yr[i] = (DType)p;
    else yr[i] += (DType)p;
  }
}

// dx = y - onehot(label): the gradient of the summed cross entropy
// through the softmax. A label outside [0, row_size) subtracts nothing.
template <class DType>
__global__ void softmax_ce_bwd(const int *label, const DType *y, DType *dx,
                               const int row_size, const int req) {
  if (req == 0) return;
  const long long off = (long long)blockIdx.x * row_size;
  const int z = label[blockIdx.x];
  for (int i = threadIdx.x; i < row_size; i += blockDim.x) {
    const DType g = y[off + i] - (i == z ? (DType)1 : (DType)0);
    if (req == 1) dx[off + i] = g;
    else dx[off + i] += g;
  }
}
