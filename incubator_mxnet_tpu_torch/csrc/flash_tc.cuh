// What the tensor-core flash-attention kernels share: the forward of
// flash_fwd_tc.cu (K4) and the backward of flash_bwd_tc.cu (K5, K6). The
// mask of one batch entry, the tile walks, the exponentials in base 2, the
// shared-memory descriptors of a 64-row tile, the epilogue that writes an
// m64 x D accumulator through swizzled shared memory in 16-byte chunks,
// and the TMA map of a strided (B, H, T, D) bf16 or fp16 operand (the
// kernels are templates over the element type T, which changes only the
// wgmma operand type, the TMA element type and the conversions). The fp32
// backward of flash_bwd_f32.cu takes the mask, the tile walks and the
// exponentials from here too.
//
// Every tile is 64 rows (queries or keys) of 64 bf16 or fp16 (128 bytes)
// under the 128-byte swizzle (hopper.cuh), so a (64 x D) tile is D/64 boxes.
// The m64
// accumulator's element d[4j + 2h + c] is row 16*warp + lane/4 + 8h,
// column 8j + 2*(lane%4) + c, warp counted inside its warpgroup.

#pragma once

#include "hopper.cuh"

namespace mxflash {

using namespace mxhop;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // rows of a tile (queries/keys)
constexpr int kBox = kTile * 64 * 2;    // one 64 x 64 box of 2-byte values
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// which (query, key) pairs of one batch entry are attended
struct Mask {
  int kmax, diag, tq, causal;
  // (no short-circuit: no branch per element)
  __device__ __forceinline__ bool ok(int query, int key) const {
    return (query < tq) & (key < kmax) & (!causal | (key <= query + diag));
  }
  // every pair of the tile [q0, q0 + 64) x [k0, k0 + 64) is attended
  __device__ __forceinline__ bool full(int q0, int k0) const {
    return q0 + kTile <= tq && k0 + kTile <= kmax &&
           (!causal || k0 + kTile - 1 <= q0 + diag);
  }
  // one past the last key any query of [q0, q0 + 64) attends (may be <= 0)
  __device__ __forceinline__ int kend(int q0) const {
    return causal ? min(kmax, min(q0 + kTile, tq) - 1 + diag + 1) : kmax;
  }
};

__device__ __forceinline__ Mask make_mask(const int* lengths, int b, int Tq,
                                          int Tk, int causal,
                                          int cache_offset) {
  const int klen = lengths ? lengths[b] : Tk;
  return Mask{min(Tk, klen), cache_offset ? klen - Tq : Tk - Tq, Tq, causal};
}

// 2^x in one MUFU op (relative error about 2^-22; results below 2^-126
// flush to 0, and 2^-inf = 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 64-key tiles [0, kend) that the rows [q0, q0 + 64) walk
__device__ __forceinline__ int key_tiles(const Mask& m, int q0) {
  const int kend = m.kend(q0);
  return kend > 0 ? (kend + kTile - 1) / kTile : 0;
}

// the query tiles [i_begin, i_begin + 64 * n) a dk/dv block walks
__device__ __forceinline__ int dkv_tiles(const Mask& m, int j0,
                                         int* i_begin) {
  int ib = 0;
  if (m.causal) {
    const int first = j0 - m.diag;  // the first query that sees key j0
    ib = first > 0 ? (first / kTile) * kTile : 0;
  }
  *i_begin = ib;
  const int i_end = j0 < m.kmax ? m.tq : 0;
  return i_end > ib ? (i_end - ib + kTile - 1) / kTile : 0;
}

// lse * log2(e) for exp2; a non-finite lse (a row with no valid key) reads
// as +inf, so its p = exp2(-inf) = 0 with no test per element
__device__ __forceinline__ float lse_log2(float l) {
  return isfinite(l) ? l * kLog2e : INFINITY;
}

// K-major operand of k-step kk: D/64 boxes of 64 rows, 16 columns a step
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk) {
  return smem_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 0, 1024);
}

// MN-major operand of k-step kk: 16 rows (the depth) a step, its D/64
// column boxes kBox apart
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kk) {
  return smem_desc(tile + kk * 2048, kBox, 1024);
}

// Round the m64 x D accumulator of the consumer warpgroup (threads
// 0..127) to T (bf16 or fp16) and store its rows < `rows` to `out` (row
// stride `st` elements), through shared memory `stage` (D/64 swizzled boxes) so
// that
// each thread writes whole 16-byte chunks.
template <int D, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2],
                                           uint8_t* stage, T* out,
                                           long long st, int rows) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  sync_consumers();  // every product that read `stage` is done
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    const int box = col >> 6, chunk = (col & 63) >> 3;
    *reinterpret_cast<uint32_t*>(stage + box * kBox + r * 128 +
                                 ((chunk ^ (r & 7)) << 4) + (col & 7) * 2) =
        pack2<T>(acc[i], acc[i + 1]);
  }
  sync_consumers();
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < kTile * kChunks; idx += 128) {
    const int r = idx / kChunks, cc = idx % kChunks;
    if (r >= rows) break;  // rows grow with idx
    const int box = cc >> 3, chunk = cc & 7;
    *reinterpret_cast<uint4*>(out + r * st + cc * 8) =
        *reinterpret_cast<const uint4*>(stage + box * kBox + r * 128 +
                                        ((chunk ^ (r & 7)) << 4));
  }
}

// The map of a (B, H, T, D) bf16 or fp16 (`dtype`) operand with element
// strides (b, h, t)
// and a contiguous head dim, in boxes of 64 rows x 64 columns. A dim of
// size 1 has no stride to speak of: it gets the packed one (the dims
// below it end to end).
inline int encode_bhtd(CUtensorMap* map, const void* base, int B, int H,
                       int T, int D, const long long* s,
                       CUtensorMapDataType dtype) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)T, (uint64_t)H,
                            (uint64_t)B};
  const long long e[3] = {s[2], s[1], s[0]};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const uint64_t packed = i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i];
    strides[i] = dims[i + 1] == 1 ? packed : (uint64_t)e[i] * 2;
    if (strides[i] % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const uint32_t box[4] = {64, (uint32_t)kTile, 1, 1};
  const uint32_t es[4] = {1, 1, 1, 1};
  return encode(map, base, 4, dims, strides, box, es, dtype);
}

}  // namespace mxflash
