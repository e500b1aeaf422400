// Flash-attention forward for a decode step on Hopper (sm_90a), split over
// keys: fp32, bf16 and fp16. Plain C interface for ctypes.
//
// It computes what csrc/flash_fwd.cu computes (see its header: the TPU
// kernel `_flash_fwd_kernel` of the JAX package's ops/pallas_attention.py)
// for calls with one query row, a decode step (Tq = 1 against a slot's
// cache prefix, `cache_offset`), which ops/flash_attention.py's
// `flash_fwd_route` sends here. Same contract: per-batch `lengths`, an
// optional fp32 natural-log lse, 0 and lse = -inf for a row with no
// attended key. At Tq = 1 the causal bound, bottom-right (key <= Tk - 1)
// or at the fill (key <= lengths[b] - 1), cuts no key the lengths leave:
// the row attends [0, min(Tk, lengths[b])), so the kernels take no causal
// flags.
//
// What bounds it: the work is one read of each (slot, head)'s K/V prefix,
// 4*D FLOPs a key: bytes, by far. One block per (slot, head), as
// flash_fwd.cu runs it, puts 96 blocks on 132 SMs at 8 slots x 12 heads,
// each walking up to 512 keys alone. So the keys are split:
// * flash_fwd_split_kernel: one block per (b*h, chunk of `chunk` keys),
//   128 threads. A group of G = D / VEC lanes reads one key row in
//   16-byte loads (VEC = 4 fp32 or 8 bf16 elements a lane, the cache rows
//   contiguous), the 128 / G groups of the block take keys group by group,
//   U keys at a time, so neighbouring lanes read neighbouring bytes and
//   each thread keeps 2U loads in flight. Each group runs its own online
//   softmax over its keys (q pre-scaled by scale * log2e, exp2, the dot
//   products reduced over the group's lanes by shfl_xor), then the groups
//   merge in shared memory in a fixed order, and the block writes the
//   chunk's partial (m, l, acc) to the workspace. A block whose keys lie
//   past the row's bound returns.
// * flash_fwd_merge_kernel: one block per b*h, D threads, merges the
//   chunks that hold the row's keys in chunk order and writes o (any
//   strides) and the lse.
// No atomics: a run repeats bit for bit. The workspace (fp32, b*h x
// nchunks x (D + 2)) comes from the wrapper. A chunk holds at least one of
// the row's keys whenever the merge reads it (the keys are the prefix
// [0, kend)), so no merged chunk is empty; a row with kend <= 0 reads none
// and writes 0 and -inf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, t;
};

// one past the last key batch entry b's row attends (may be <= 0)
__device__ __forceinline__ int key_end(const int* lengths, int b, int Tk) {
  return lengths ? min(Tk, lengths[b]) : Tk;
}

// 2^x in one MUFU op (2^-inf = 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of a row as fp32: 4 floats, 8 bf16 or 8 fp16
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ __forceinline__ static float from_f32(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p,
                                              float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __half from_f32(float x) {
    return __float2half(x);
  }
};

// One block: keys [c0, c0 + chunk) of (batch, head) blockIdx.x, c0 from
// blockIdx.y. Writes the chunk's partial (m in log2 units with the scale
// folded in, l, acc = sum p v, both relative to m).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths,
                       float* __restrict__ part, int H, int Tk, Strides sq,
                       Strides sk, Strides sv, float scale, int chunk) {
  constexpr int VEC = Vec<T>::N;
  constexpr int G = D / VEC;         // lanes a key row
  constexpr int NG = kThreads / G;   // key groups a block
  constexpr int U = 4;               // keys a group takes at a time
  static_assert(G <= 32 && 32 % G == 0, "a key's lanes lie in one warp");
  __shared__ float s_acc[NG][D];
  __shared__ float s_m[NG], s_l[NG];

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int c0 = blockIdx.y * chunk;
  const int nchunks = gridDim.y;
  const int c1 = min(c0 + chunk, key_end(lengths, b, Tk));
  if (c0 >= c1) return;  // past the row's keys: the merge reads nothing

  const int tid = threadIdx.x, g = tid / G, part_lane = tid % G;
  const int d0 = part_lane * VEC;
  const T* kb = k + b * sk.b + h * sk.h + d0;
  const T* vb = v + b * sv.b + h * sv.h + d0;

  // this lane's VEC dims of q, times scale * log2(e)
  float qv[VEC];
  Vec<T>::load(q + b * sq.b + h * sq.h + d0, qv);
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv[e] *= sl2;

  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // every thread runs the same iterations (the shuffles need all lanes)
  for (int jb = c0; jb < c1; jb += NG * U) {
    float kf[U][VEC], vf[U][VEC];
    int key[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = jb + u * NG + g;
      if (key[u] < c1) {
        Vec<T>::load(kb + key[u] * sk.t, kf[u]);
        Vec<T>::load(vb + key[u] * sv.t, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[U];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) x = fmaf(qv[e], kf[u][e], x);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      s[u] = key[u] < c1 ? x : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    const float mnew = fmaxf(m, mx);
    const float muse = mnew == -INFINITY ? 0.f : mnew;
    const float alpha = exp2_fast(m - muse);
    m = mnew;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = exp2_fast(s[u] - muse);
      l += p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vf[u][e], acc[e]);
    }
  }

  // merge the groups in order
#pragma unroll
  for (int e = 0; e < VEC; ++e) s_acc[g][d0 + e] = acc[e];
  if (part_lane == 0) {
    s_m[g] = m;
    s_l[g] = l;
  }
  __syncthreads();
  const long long at = (long long)bh * nchunks + blockIdx.y;
  float* pacc = part;                                     // [.][D]
  float* pml = part + (long long)gridDim.x * nchunks * D;  // [.][2]
  for (int d = tid; d < D; d += kThreads) {
    float mm = -INFINITY;
    for (int gg = 0; gg < NG; ++gg) mm = fmaxf(mm, s_m[gg]);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, aa = 0.f;
    for (int gg = 0; gg < NG; ++gg) {
      const float w = exp2f(s_m[gg] - mu);
      ll = fmaf(s_l[gg], w, ll);
      aa = fmaf(s_acc[gg][d], w, aa);
    }
    pacc[at * D + d] = aa;
    if (d == 0) {
      pml[at * 2] = mm;
      pml[at * 2 + 1] = ll;
    }
  }
}

// One block: (batch, head) blockIdx.x; thread d merges output dim d over
// the chunks that hold the row's keys.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_fwd_merge_kernel(const float* __restrict__ part,
                       const int* __restrict__ lengths, T* __restrict__ o,
                       float* __restrict__ lse, int H, int Tk, Strides so,
                       int chunk, int nchunks) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int d = threadIdx.x;
  const int kend = key_end(lengths, b, Tk);
  const int n = kend > 0 ? min(nchunks, (kend + chunk - 1) / chunk) : 0;
  const float* pacc = part + (long long)bh * nchunks * D + d;
  const float* pml = part + (long long)gridDim.x * nchunks * D +
                     (long long)bh * nchunks * 2;
  float mm = -INFINITY;
  for (int c = 0; c < n; ++c) mm = fmaxf(mm, pml[2 * c]);
  const float mu = mm == -INFINITY ? 0.f : mm;
  float ll = 0.f, aa = 0.f;
  for (int c = 0; c < n; ++c) {
    const float w = exp2f(pml[2 * c] - mu);
    ll = fmaf(pml[2 * c + 1], w, ll);
    aa = fmaf(pacc[c * D], w, aa);
  }
  o[b * so.b + h * so.h + d] = Vec<T>::from_f32(ll > 0.f ? aa / ll : 0.f);
  if (lse != nullptr && d == 0)
    lse[bh] = ll > 0.f ? (mm + log2f(ll)) * kLn2 : -INFINITY;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* lengths, float* part, int B, int H, int Tk, Strides sq,
           Strides sk, Strides sv, Strides so, float scale, int chunk,
           int nchunks, cudaStream_t stream) {
  flash_fwd_split_kernel<T, D><<<dim3(B * H, nchunks), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part, H, Tk, sq, sk, sv, scale,
      chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_fwd_merge_kernel<T, D><<<B * H, D, 0, stream>>>(
      part, lengths, static_cast<T*>(o), lse, H, Tk, so, chunk, nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, const int* lengths, float* part, int B, int H,
             int Tk, Strides sq, Strides sk, Strides sv, Strides so,
             float scale, int chunk, int nchunks, cudaStream_t s) {
#define MXTPU_SPLIT(DD)                                                      \
  if (D == DD)                                                               \
    return launch<T, DD>(q, k, v, o, lse, lengths, part, B, H, Tk, sq, sk,   \
                         sv, so, scale, chunk, nchunks, s);
  MXTPU_SPLIT(32)
  MXTPU_SPLIT(64)
  MXTPU_SPLIT(128)
#undef MXTPU_SPLIT
  return -1;
}

}  // namespace

extern "C" {

// One query row (Tq = 1) a (batch, head). dtype: 0 = float32, 1 =
// bfloat16, 2 = float16. strides: 12 values, (b, h, t) of q, k, v, o, in elements; q,
// k and v rows 16-byte aligned (the wrapper checks). chunk: keys a block;
// nchunks = ceil(Tk / chunk). part: fp32 workspace of B*H*nchunks*(D + 2)
// values. lse and lengths may be null. Returns the cudaError_t of the
// launches (0 on success), or -1 for an unsupported D or dtype.
int mxtpu_flash_fwd_split(const void* q, const void* k, const void* v,
                          void* o, float* lse, const int* lengths,
                          float* part, int B, int H, int Tk, int D,
                          const long long* strides, float scale, int dtype,
                          int chunk, int nchunks, void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, lse, lengths, part, B, H, Tk, sq,
                           sk, sv, so, scale, chunk, nchunks, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, lse, lengths, part, B, H,
                                   Tk, sq, sk, sv, so, scale, chunk, nchunks,
                                   s);
  if (dtype == 2)
    return dispatch<__half>(D, q, k, v, o, lse, lengths, part, B, H, Tk, sq,
                            sk, sv, so, scale, chunk, nchunks, s);
  return -1;
}

}  // extern "C"
