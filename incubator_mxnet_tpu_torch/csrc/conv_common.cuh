// Pieces shared by the fused conv+BatchNorm kernels (fused_conv.cu: K1,
// conv_bwd.cu: K2 and K3): element access in fp32 or bf16, the 64x64
// register-blocked product of two shared-memory tiles, the deterministic
// reductions of per-block partial sums, and the elementwise pass that
// emits the joined activation (the bf16 tensor-core kernels,
// conv_bwd_tc.cu and fused_conv_tc.cu, share the arithmetic, the
// reductions and that pass).
//
// Arithmetic that the TPU kernels do in fp32 and then round (the BatchNorm
// prologue, the folding of the statistics cotangents) is written with
// __fmul_rn/__fadd_rn, so nvcc cannot contract it into an fma: the result
// is bit-for-bit the two-rounding result of the plain PyTorch version, and
// a ReLU mask recomputed in the backward agrees with the forward's.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mxconv {

constexpr int kBM = 64;        // tile rows
constexpr int kBN = 64;        // tile columns
constexpr int kBK = 16;        // depth of one tile step
constexpr int kPad = 4;        // row padding (floats) of the tiles
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct Shape {
  int N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// The pre-activation of the prologue, a*x + b [+ ar*r + br], in fp32 with
// the plain version's rounding order: ((x*a) + b), then (+ r*ar), then + br.
__device__ __forceinline__ float prologue_lin(float xv, float av, float bv,
                                              bool has_res, float rv,
                                              float arv, float brv) {
  float t = __fadd_rn(__fmul_rn(xv, av), bv);
  if (has_res) t = __fadd_rn(__fadd_rn(t, __fmul_rn(rv, arv)), brv);
  return t;
}

// dy + ds + 2*y*dss in fp32: the statistics cotangents folded into dy.
__device__ __forceinline__ float fold_cotangent(float dyv, float yv,
                                                float dsv, float dssv) {
  return __fadd_rn(__fadd_rn(dyv, dsv), __fmul_rn(__fmul_rn(2.0f, yv), dssv));
}

// acc[i][j] += sum_k As[k][ty*4+i] * Bs[k][tx*4+j] over one tile step.
__device__ __forceinline__ void tile_product(
    const float (*As)[kBM + kPad], const float (*Bs)[kBN + kPad],
    float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], bc[j], acc[i][j]);
  }
}

// out[c] = sum over r of part[r, c], r in order: block (32, 32), each of
// the 32 thread rows sums every 32nd partial row, then thread row 0 adds
// the 32 (a fixed order: the same result on every run).
__global__ void column_sum_kernel(const float* __restrict__ part, int rows,
                                  int cols, float* __restrict__ out) {
  __shared__ float sm[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float t = 0.0f;
  if (c < cols)
    for (int r = threadIdx.y; r < rows; r += 32)
      t += part[(long long)r * cols + c];
  sm[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float u = 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) u += sm[k][threadIdx.x];
    out[c] = u;
  }
}

inline void column_sum(const float* part, int rows, int cols, float* out,
                       cudaStream_t stream) {
  column_sum_kernel<<<dim3((cols + 31) / 32), dim3(32, 32), 0, stream>>>(
      part, rows, cols, out);
}

// The column sums of up to three consecutive planes of rows x cols
// partials in one launch (plane blockIdx.y into o0, o1, o2; a null output
// skips its plane), for the tensor-core kernels, whose partials run to
// thousands of rows: each thread keeps four running sums over every 128th
// row (four loads in flight, not one), added in a fixed order, so the
// result repeats bit for bit.
__global__ void column_sums_kernel(const float* __restrict__ part, int rows,
                                   int cols, float* o0, float* o1,
                                   float* o2) {
  float* out = blockIdx.y == 0 ? o0 : blockIdx.y == 1 ? o1 : o2;
  if (out == nullptr) return;  // uniform over the block
  __shared__ float sm[32][33];
  const float* plane = part + (long long)blockIdx.y * rows * cols;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f;
  if (c < cols) {
    int r = threadIdx.y;
    for (; r + 96 < rows; r += 128) {
      t0 += plane[(long long)r * cols + c];
      t1 += plane[(long long)(r + 32) * cols + c];
      t2 += plane[(long long)(r + 64) * cols + c];
      t3 += plane[(long long)(r + 96) * cols + c];
    }
    for (; r < rows; r += 32) t0 += plane[(long long)r * cols + c];
  }
  const float t = (t0 + t1) + (t2 + t3);
  sm[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float u = 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) u += sm[k][threadIdx.x];
    out[c] = u;
  }
}

inline void column_sums(const float* part, int planes, int rows, int cols,
                        float* o0, float* o1, float* o2,
                        cudaStream_t stream) {
  column_sums_kernel<<<dim3((cols + 31) / 32, planes), dim3(32, 32), 0,
                       stream>>>(part, rows, cols, o0, o1, o2);
}

// dw[c] = sum over the splits of part[z, c], in order, cast to w's type.
template <typename T>
__global__ void split_sum_kernel(const float* __restrict__ part, int splits,
                                 long long cols, T* __restrict__ dw) {
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < cols; c += (long long)gridDim.x * blockDim.x) {
    float t = 0.0f;
    for (int z = 0; z < splits; ++z) t += part[z * cols + c];
    Elem<T>::st(dw + c, t);
  }
}

// xp = relu(a*x + b [+ ar*r + br]) rounded to x's type, elementwise: the
// emitted activation for shapes whose rows are not x's pixels.
template <typename T>
__global__ void join_emit_kernel(const T* __restrict__ x,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 const T* __restrict__ r,
                                 const float* __restrict__ ar,
                                 const float* __restrict__ br,
                                 T* __restrict__ xp, long long total, int ci_n,
                                 int relu) {
  const bool has_pro = a != nullptr, has_res = r != nullptr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int ci = (int)(i % ci_n);
    float v = prologue_lin(Elem<T>::ld(x + i), has_pro ? a[ci] : 1.0f,
                           has_pro ? b[ci] : 0.0f, has_res,
                           has_res ? Elem<T>::ld(r + i) : 0.0f,
                           has_res ? ar[ci] : 0.0f, has_res ? br[ci] : 0.0f);
    if (relu) v = v > 0.0f ? v : 0.0f;
    Elem<T>::st(xp + i, v);
  }
}

}  // namespace mxconv
