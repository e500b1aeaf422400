// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel`
// (the JAX package's ops/pallas_attention.py, launched by `_flash_fwd`).
// Same contract: (B,H,Tq,D) queries against (B,H,Tk,D) keys/values, online
// softmax with fp32 running max, sum and accumulator; per-batch key
// `lengths`; causal masking aligned bottom-right (col <= row + Tk - Tq) or,
// with `cache_offset`, at the per-batch fill (col <= row + lengths[b] - Tq);
// optional fp32 log-sum-exp per row. A row with no valid key writes 0 and
// lse = -inf. The key loop stops at the causal/length bound, so a decode
// step reads only [0, lengths[b]) of a long cache.
//
// What bounds it: at the serving shapes (D=64, decode Tq=1 against a cache
// prefix, prefill Tq=Tk<=256) the work is a few MFLOP per head against the
// K/V bytes, so the kernel is bound by reading K and V. The design reads
// each K/V tile once per query tile into shared memory (converted to fp32)
// and keeps the running softmax state in registers, so nothing of size
// Tq x Tk touches device memory.
//
// Layout of one block: BQ=32 query rows of one (batch, head), 128 threads,
// four threads per row. A thread owns BK/4 score columns of each key tile
// and D/4 interleaved output dimensions (d = 4*j + part), so the shared
// memory reads of the score and P.V loops are free of bank conflicts
// (rows padded by one float). Row max and row sum are reduced across the
// four threads with warp shuffles. Decode (Tq=1) would use one of the 32
// rows of its tile, so ops/flash_attention.py's `flash_fwd_route` sends
// decode steps (Tq = 1) to the split kernels of flash_fwd_split.cu and bf16
// calls with D 64 or 128 and 16-byte aligned operands to the tensor-core
// kernel of flash_fwd_tc.cu; this kernel takes the rest (fp32 training and
// prefill, D = 32, misaligned views) and any call named `route="simt"`.
//
// Inputs may be strided: each of q, k, v, o has its own batch, head and
// sequence strides (elements); the head dimension must be contiguous. This
// lets the caller pass the head-split views of a fused QKV projection and
// write the output straight into (B, T, H, D) order without copies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;               // query rows per block
constexpr int kTPR = 4;               // threads per query row
constexpr int kThreads = kBQ * kTPR;  // 128

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__half* p, float x) {
  *p = __float2half(x);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ lengths,
                 int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, int causal, int cache_offset) {
  constexpr int kCols = BK / kTPR;   // score columns per thread per tile
  constexpr int kDims = D / kTPR;    // output dims per thread
  __shared__ float qs[kBQ][D + 1];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];
  __shared__ float ps[kBQ][BK + 1];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  const int row = q0 + r;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  const int klen = lengths ? lengths[b] : Tk;
  const int kmax = min(Tk, klen);
  const int diag = cache_offset ? klen - Tq : Tk - Tq;
  // keys past kend are masked for every row of this tile: never loaded
  int kend = kmax;
  if (causal) kend = min(kend, min(q0 + kBQ, Tq) - 1 + diag + 1);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i - (i / D) * D;
    const int gr = q0 + rr;
    qs[rr][d] = gr < Tq ? load_f32(qb + gr * sq.t + d) : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;

  for (int j0 = 0; j0 < kend; j0 += BK) {
    __syncthreads();  // previous tile fully consumed (and qs loaded)
    for (int i = tid; i < BK * D; i += kThreads) {
      const int kr = i / D, d = i - (i / D) * D;
      const int gk = j0 + kr;
      const bool in = gk < kend;
      ks[kr][d] = in ? load_f32(kb + gk * sk.t + d) : 0.f;
      vs[kr][d] = in ? load_f32(vb + gk * sv.t + d) : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r][d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] = fmaf(qv, ks[part * kCols + c][d], s[c]);
    }
    float mloc = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = j0 + part * kCols + c;
      bool valid = col < kmax;
      if (causal) valid = valid && col <= row + diag;
      s[c] = valid ? s[c] * scale : -INFINITY;
      mloc = fmaxf(mloc, s[c]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    // rows with no valid key yet keep m_new == -inf: guard the exps
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float p = s[c] == -INFINITY ? 0.f : expf(s[c] - m_safe);
      ps[r][part * kCols + c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[j] *= alpha;
    __syncwarp();  // a row's four threads (one warp) see each other's p

    const int ncols = min(BK, kend - j0);
    for (int c = 0; c < ncols; ++c) {
      const float p = ps[r][c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[j] = fmaf(p, vs[c][j * kTPR + part], acc[j]);
    }
  }

  if (row < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-37f);
    T* ob = o + b * so.b + h * so.h + row * so.t;
#pragma unroll
    for (int j = 0; j < kDims; ++j) store_f32(ob + j * kTPR + part, acc[j] * inv);
    if (lse != nullptr && part == 0) {
      const float m_safe = m == -INFINITY ? 0.f : m;
      lse[(long long)bh * Tq + row] = l > 0.f ? m_safe + logf(fmaxf(l, 1e-37f)) : -INFINITY;
    }
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* lengths, int B, int H, int Tq, int Tk, Strides sq,
           Strides sk, Strides sv, Strides so, float scale, int causal,
           int cache_offset, cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lengths, H, Tq, Tk,
      sq, sk, sv, so, scale, causal, cache_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, const int* lengths, int B, int H, int Tq, int Tk,
               Strides sq, Strides sk, Strides sv, Strides so, float scale,
               int causal, int cache_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, 32>(q, k, v, o, lse, lengths, B, H, Tq, Tk, sq, sk,
                               sv, so, scale, causal, cache_offset, stream);
    case 64:
      return launch<T, 64, 32>(q, k, v, o, lse, lengths, B, H, Tq, Tk, sq, sk,
                               sv, so, scale, causal, cache_offset, stream);
    case 128:
      return launch<T, 128, 16>(q, k, v, o, lse, lengths, B, H, Tq, Tk, sq,
                                sk, sv, so, scale, causal, cache_offset,
                                stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 12 values, (b, h, t) for each
// of q, k, v, o, in elements. lse and lengths may be null. Returns the
// cudaError_t of the launch (0 on success), or -1 for an unsupported D or
// dtype (the Python wrapper checks both before calling).
int mxtpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, const int* lengths, int B, int H, int Tq,
                    int Tk, int D, const long long* strides, float scale,
                    int causal, int cache_offset, int dtype, void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, lengths, B, H, Tq, Tk, sq,
                             sk, sv, so, scale, causal, cache_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, lengths, B, H, Tq,
                                     Tk, sq, sk, sv, so, scale, causal,
                                     cache_offset, s);
  if (dtype == 2)
    return dispatch_d<__half>(D, q, k, v, o, lse, lengths, B, H, Tq, Tk, sq,
                              sk, sv, so, scale, causal, cache_offset, s);
  return -1;
}

}  // extern "C"
