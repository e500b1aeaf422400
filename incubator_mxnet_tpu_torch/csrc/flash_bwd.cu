// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, each replacing one TPU kernel of the JAX package's
// ops/pallas_attention.py (launched there by `_flash_bwd`):
//
// * flash_bwd_dq_kernel  replaces `_flash_bwd_dq_kernel`:
//     dQ = sum_j dS_j K_j over key tiles;
// * flash_bwd_dkv_kernel replaces `_flash_bwd_dkv_kernel`:
//     dK = sum_i dS_i^T Q_i and dV = sum_i P_i^T dO_i over query tiles.
//
// Both recompute the probabilities from the forward's fp32 row log-sum-exp,
// p = exp(s - lse) with s = scale * q.k, and take dS = p * (dO.v - delta) *
// scale with the fp32 row statistic delta = sum_d dO * O computed outside.
// Masking is the forward kernel's (csrc/flash_fwd.cu): per-batch key
// `lengths`, causal aligned bottom-right (col <= row + Tk - Tq) or, with
// `cache_offset`, at the per-batch fill (col <= row + lengths[b] - Tq). A
// row whose lse is not finite (no valid key; the forward wrote -inf)
// contributes nothing: its dq is 0 and it adds nothing to dk or dv. Rows
// past Tq and keys past Tk are masked here, not padded by the caller.
//
// Each kernel owns its output tile and loops over the other sequence, so
// there are no atomics and a run repeats bit for bit. For bf16 inputs p and
// dS are rounded to bf16 before their products, where the TPU kernels cast
// them to the input type; every sum runs in fp32 and each output is rounded
// once at the end.
//
// What bounds them: at the training shape (B=8, H=12, T=256, D=64, causal)
// the work is 6*D (dq) and 8*D (dk, dv) FLOPs per attended pair against
// ~16-19 MB of bf16 inputs and outputs: fp32 runs are bound by operations,
// bf16 by bytes. This first design does its products as scalar fp32 FMAs
// from shared memory (no tensor cores), so both run far above either
// bound; wgmma/TMA tiles are later work.
//
// Layout: 128 threads, four per tile row (as in the forward kernel).
// * dq: one block per (batch*head, 32-query tile). Q and dO of the tile and
//   each 32-key tile of K and V sit in shared memory in fp32 (rows padded by
//   one float); a thread scores 8 keys of its row, writes dS to shared
//   memory, and accumulates D/4 interleaved dims of its dq row in registers.
//   The key loop stops at the causal/length bound.
// * dkv: one block per (batch*head, 32-key tile). K and V of the tile stay
//   in shared memory; the loop runs over the 32-query tiles that can reach
//   the tile (causal: from the first row with row + diag >= first key).
//   A thread scores 8 queries against its key, writes p and dS transposed
//   to shared memory, and accumulates D/4 interleaved dims of its dk and dv
//   rows in registers.
// Shared memory is dynamic (up to 75 KB at D=128), so the launch raises the
// kernel's limit above the static 48 KB first.
//
// Inputs may be strided: q, k, v, dO and every output have their own
// batch, head and sequence strides (elements); the head dim is contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;               // query rows per tile
constexpr int kBK = 32;               // keys per tile
constexpr int kTPR = 4;               // threads per tile row
constexpr int kThreads = 128;

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
// round x to the input type (identity for fp32)
__device__ __forceinline__ float round_to(float x, const __half*) {
  return __half2float(__float2half(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// which (query row, key col) pairs of one batch entry are attended
struct Mask {
  int kmax, diag, tq, causal;
  __device__ __forceinline__ bool ok(int row, int col) const {
    return row < tq && col < kmax && (!causal || col <= row + diag);
  }
};

__device__ __forceinline__ Mask make_mask(const int* lengths, int b, int Tq,
                                          int Tk, int causal,
                                          int cache_offset) {
  const int klen = lengths ? lengths[b] : Tk;
  return Mask{min(Tk, klen), cache_offset ? klen - Tq : Tk - Tq, Tq, causal};
}

// tile rows [r0, r0 + n) of a strided (seq, D) plane into fp32 smem rows of
// pitch D + 1; rows at or past `limit` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int n,
                                          int limit) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int rr = i / D, d = i - (i / D) * D;
    const int gr = r0 + rr;
    dst[rr * (D + 1) + d] = gr < limit ? load_f32(src + gr * st + d) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ lengths, T* __restrict__ dq,
                    int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                    Strides sg, Strides sdq, float scale, int causal,
                    int cache_offset) {
  constexpr int P = D + 1;
  constexpr int kCols = kBK / kTPR;  // keys scored per thread per tile
  constexpr int kDims = D / kTPR;    // dq dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][P]
  float* gs = qs + kBQ * P;          // [kBQ][P]
  float* ks = gs + kBQ * P;          // [kBK][P]
  float* vs = ks + kBK * P;          // [kBK][P]
  float* dss = vs + kBK * P;         // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int r = threadIdx.x / kTPR;
  const int part = threadIdx.x % kTPR;
  const int row = q0 + r;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // keys past kend are masked for every row of this tile: never loaded
  int kend = m.kmax;
  if (causal) kend = min(kend, min(q0 + kBQ, Tq) - 1 + m.diag + 1);

  load_tile<T, D>(qs, q + b * sq.b + h * sq.h, sq.t, q0, kBQ, Tq);
  load_tile<T, D>(gs, g + b * sg.b + h * sg.h, sg.t, q0, kBQ, Tq);
  bool live = false;
  float lse_r = 0.f, delta_r = 0.f;
  if (row < Tq) {
    const float l = lse[(long long)bh * Tq + row];
    live = isfinite(l);
    lse_r = live ? l : 0.f;
    delta_r = delta[(long long)bh * Tq + row];
  }

  float acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) acc[j] = 0.f;

  for (int j0 = 0; j0 < kend; j0 += kBK) {
    __syncthreads();  // previous tile consumed (and q, dO loaded)
    load_tile<T, D>(ks, kb, sk.t, j0, kBK, kend);
    load_tile<T, D>(vs, vb, sv.t, j0, kBK, kend);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * P + d];
      const float gv = gs[r * P + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[c] = fmaf(qv, ks[(part * kCols + c) * P + d], s[c]);
        dp[c] = fmaf(gv, vs[(part * kCols + c) * P + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = j0 + part * kCols + c;
      const float p = live && m.ok(row, col) ? expf(s[c] * scale - lse_r)
                                             : 0.f;
      dss[r * (kBK + 1) + part * kCols + c] =
          round_to(p * (dp[c] - delta_r) * scale, q);
    }
    __syncwarp();  // a row's four threads (one warp) see each other's dS

    const int ncols = min(kBK, kend - j0);
    for (int c = 0; c < ncols; ++c) {
      const float ds = dss[r * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j)
        acc[j] = fmaf(ds, ks[c * P + j * kTPR + part], acc[j]);
    }
  }

  if (row < Tq) {
    T* out = dq + b * sdq.b + h * sdq.h + row * sdq.t;
#pragma unroll
    for (int j = 0; j < kDims; ++j) store_f32(out + j * kTPR + part, acc[j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lengths, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, Strides sq,
                     Strides sk, Strides sv, Strides sg, Strides sdk,
                     Strides sdv, float scale, int causal, int cache_offset) {
  constexpr int P = D + 1;
  constexpr int PQ = kBQ + 1;
  constexpr int kRows = kBQ / kTPR;  // queries scored per thread per tile
  constexpr int kDims = D / kTPR;    // dk/dv dims per thread
  extern __shared__ float smem[];
  float* ks = smem;                  // [kBK][P]
  float* vs = ks + kBK * P;          // [kBK][P]
  float* qs = vs + kBK * P;          // [kBQ][P]
  float* gs = qs + kBQ * P;          // [kBQ][P]
  float* ls = gs + kBQ * P;          // [kBQ] lse (+inf past Tq)
  float* dl = ls + kBQ;              // [kBQ] delta
  float* pt = dl + kBQ;              // [kBK][PQ] p, transposed
  float* dst = pt + kBK * PQ;        // [kBK][PQ] dS, transposed

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.x * kBK;
  const int c = threadIdx.x / kTPR;
  const int part = threadIdx.x % kTPR;
  const int col = j0 + c;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;

  load_tile<T, D>(ks, k + b * sk.b + h * sk.h, sk.t, j0, kBK, Tk);
  load_tile<T, D>(vs, v + b * sv.b + h * sv.h, sv.t, j0, kBK, Tk);

  // query tiles that can reach this key tile: causal rows below
  // j0 - diag see none of its keys; a tile past the valid keys gets none
  int i_begin = 0;
  if (causal) {
    const int first = j0 - m.diag;
    i_begin = first > 0 ? (first / kBQ) * kBQ : 0;
  }
  const int i_end = j0 < m.kmax ? Tq : 0;

  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int j = 0; j < kDims; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int i0 = i_begin; i0 < i_end; i0 += kBQ) {
    __syncthreads();  // previous tile consumed (and k, v loaded)
    load_tile<T, D>(qs, qb, sq.t, i0, kBQ, Tq);
    load_tile<T, D>(gs, gb, sg.t, i0, kBQ, Tq);
    for (int t = threadIdx.x; t < kBQ; t += kThreads) {
      const int gr = i0 + t;
      ls[t] = gr < Tq ? lse[(long long)bh * Tq + gr] : INFINITY;
      dl[t] = gr < Tq ? delta[(long long)bh * Tq + gr] : 0.f;
    }
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = ks[c * P + d];
      const float vv = vs[c * P + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i] = fmaf(qs[(part * kRows + i) * P + d], kv, s[i]);
        dp[i] = fmaf(gs[(part * kRows + i) * P + d], vv, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rr = part * kRows + i;
      const float l = ls[rr];
      const float p = isfinite(l) && m.ok(i0 + rr, col)
                          ? expf(s[i] * scale - l) : 0.f;
      pt[c * PQ + rr] = round_to(p, q);
      dst[c * PQ + rr] = round_to(p * (dp[i] - dl[rr]) * scale, q);
    }
    __syncwarp();  // a key's four threads (one warp) see each other's p, dS

    const int nrows = min(kBQ, Tq - i0);
    for (int rr = 0; rr < nrows; ++rr) {
      const float p = pt[c * PQ + rr];
      const float ds = dst[c * PQ + rr];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        dv_acc[j] = fmaf(p, gs[rr * P + j * kTPR + part], dv_acc[j]);
        dk_acc[j] = fmaf(ds, qs[rr * P + j * kTPR + part], dk_acc[j]);
      }
    }
  }

  if (col < Tk) {
    T* outk = dk + b * sdk.b + h * sdk.h + col * sdk.t;
    T* outv = dv + b * sdv.b + h * sdv.h + col * sdv.t;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      store_f32(outk + j * kTPR + part, dk_acc[j]);
      store_f32(outv + j * kTPR + part, dv_acc[j]);
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1)) * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ
          + 2 * kBK * (kBQ + 1)) * 4;
}

// raise a kernel's dynamic shared memory limit past the static 48 KB, once
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int* lengths;
  void *o1, *o2;
  int B, H, Tq, Tk;
  Strides sq, sk, sv, sg, so1, so2;
  float scale;
  int causal, cache_offset;
};

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  static bool done = false;
  constexpr int smem = dq_smem<D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.lengths, static_cast<T*>(a.o1), a.H, a.Tq, a.Tk, a.sq, a.sk, a.sv,
      a.sg, a.so1, a.scale, a.causal, a.cache_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a, cudaStream_t stream) {
  static bool done = false;
  constexpr int smem = dkv_smem<D>();
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Tk + kBK - 1) / kBK, a.B * a.H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.lengths, static_cast<T*>(a.o1), static_cast<T*>(a.o2), a.H, a.Tq,
      a.Tk, a.sq, a.sk, a.sv, a.sg, a.so1, a.so2, a.scale, a.causal,
      a.cache_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool dkv, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32:
      return dkv ? launch_dkv<T, 32>(a, s) : launch_dq<T, 32>(a, s);
    case 64:
      return dkv ? launch_dkv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
    case 128:
      return dkv ? launch_dkv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
    default:
      return -1;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* g,
        const float* lse, const float* delta, const int* lengths, void* o1,
        void* o2, int B, int H, int Tq, int Tk, int D,
        const long long* strides, float scale, int causal, int cache_offset,
        int dtype, void* stream) {
  const long long* s = strides;
  Args a{q, k, v, g, lse, delta, lengths, o1, o2, B, H, Tq, Tk,
         {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
         {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
         {s[15], s[16], s[17]}, scale, causal, cache_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(dkv, D, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dkv, D, a, st);
  if (dtype == 2) return dispatch<__half>(dkv, D, a, st);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 18 values, (b, h, t) for each
// of q, k, v, g and the two outputs, in elements (dq uses the first output
// only; its last three values are ignored). lse and delta are contiguous
// fp32 (B*H, Tq); lengths may be null. Returns the cudaError_t of the launch
// (0 on success), or -1 for an unsupported D or dtype (the Python wrapper
// checks both before calling).
int mxtpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       const int* lengths, void* dq, int B, int H, int Tq,
                       int Tk, int D, const long long* strides, float scale,
                       int causal, int cache_offset, int dtype,
                       void* stream) {
  return run(false, q, k, v, g, lse, delta, lengths, dq, nullptr, B, H, Tq,
             Tk, D, strides, scale, causal, cache_offset, dtype, stream);
}

int mxtpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* delta,
                        const int* lengths, void* dk, void* dv, int B, int H,
                        int Tq, int Tk, int D, const long long* strides,
                        float scale, int causal, int cache_offset, int dtype,
                        void* stream) {
  return run(true, q, k, v, g, lse, delta, lengths, dk, dv, B, H, Tq, Tk, D,
             strides, scale, causal, cache_offset, dtype, stream);
}

}  // extern "C"
