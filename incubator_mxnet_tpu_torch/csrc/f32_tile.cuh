// The fp32 register micro-tiles of the kernels on Hopper's FP32 pipes: the
// flash-attention backward of flash_bwd_f32.cu (K5, K6), the forward of
// flash_fwd_f32.cu (K4), the conv input and weight gradients of
// conv_bwd_f32.cu (K2, K3) and the conv forward of fused_conv_f32.cu (K1).
// What they share: the layout of a 64-row fp32 tile under TMA's 128-byte
// swizzle, the per-thread offset tables that make every shared load an
// immediate, the 16-byte loads and the 4-deep dot product, and the
// mbarrier ring's set-up; and for the flash kernels, the TMA tiles of a
// strided (B, H, T, D) fp32 operand (conv_f32.cuh adds the conv kernels'
// pixel boxes).
//
// Every tile is 64 rows of 32-float (128-byte) boxes under the 128-byte
// swizzle: the 16-byte chunk c of row r of a box lies at r * 128 + ((c ^
// r % 8) << 4), and a row wider than 32 floats continues in the next box,
// kBoxBytes on. The rows that one warp's load reads lie in distinct 16-byte
// bank quads when their r % 8 differ, so such a load is one shared-memory
// wavefront (tools/torch_lds_wavefronts.py measures it; the CPU mirrors in
// tests/test_torch_flash_bwd_route.py, tests/test_torch_flash_fwd_route.py
// and tests/test_torch_conv_bwd_route.py check the quads).

#pragma once

#include "hopper.cuh"

namespace mxf32 {

using namespace mxhop;

constexpr int kTileRows = 64;              // rows of a tile
constexpr int kBoxBytes = kTileRows * 128;     // 64 rows of 32 floats
// tiles start 1024-byte aligned, as TMA's 128-byte swizzle needs
constexpr int kAlign = 1024;

// The swizzle key of row r: its byte offset in a box with the row's XOR in
// bits 4-6, so chunk c of the row lies at (key ^ (c % 8) << 4) + (c / 8)
// boxes (tiles start 1024-byte aligned).
__device__ __forceinline__ uint32_t row_key(int r) {
  return r * 128 + ((r & 7) << 4);
}

__device__ __forceinline__ uint32_t chunk_off(uint32_t key, int c) {
  return (key ^ ((c & 7) << 4)) + (c >> 3) * kBoxBytes;
}

// A thread's rows r0 + 4i (r0 % 8 < 4) or r0 + 8j of a swizzled tile, as
// the byte offsets of row r0's chunks c % 8: x[cc] = r0 * 128 + ((r0 % 8 ^
// cc) << 4). Every other row and box lies an immediate away (rows r0 + 4i
// and r0 differ in bit 2 of r % 8 for odd i, which flips bit 6 of the
// offset: +64 or -64 as bit 2 of c), so once the loops are unrolled a load
// takes no address arithmetic.
struct RowOffs {
  uint32_t x[8];
  __device__ __forceinline__ explicit RowOffs(int r0) {
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) x[cc] = r0 * 128 + (((r0 & 7) ^ cc) << 4);
  }
  // chunk c of row r0 + 4i
  __device__ __forceinline__ uint32_t step4(int i, int c) const {
    const int flip = (i & 1) ? ((c & 4) ? -64 : 64) : 0;
    return x[c & 7] + (512 * i + flip + (c >> 3) * kBoxBytes);
  }
  // chunk c of row r0 + 8j
  __device__ __forceinline__ uint32_t step8(int j, int c) const {
    return x[c & 7] + (1024 * j + (c >> 3) * kBoxBytes);
  }
};

__device__ __forceinline__ float4 ld4(const uint8_t* base, uint32_t off) {
  return *reinterpret_cast<const float4*>(base + off);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane_of(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// one fp32 element (row key `key`, column col) of a swizzled tile
__device__ __forceinline__ void st1(uint8_t* tile, uint32_t key, int col,
                                    float x) {
  *reinterpret_cast<float*>(tile + chunk_off(key, col >> 2) +
                            (col & 3) * 4) = x;
}

// S mbarriers of one arrival each (thread 0 expects the bytes), made
// visible to the whole block
template <int S>
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + kAlign - 1) & ~(kAlign - 1u)) - a);
}

// ---------------------------------------------------------------------------
// (B, H, T, D) fp32 operands with their own element strides and a
// contiguous head dim (the flash kernels)
// ---------------------------------------------------------------------------
struct Strides {
  long long b, h, t;
};

// the D/32 boxes of rows [r0, r0 + 64) of (batch b, head h) by TMA onto
// `bar`, started by one thread; rows past T are zero-filled
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* tile,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int r0, int h,
                                         int b) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    tma_load_4d(tile + c * kBoxBytes, map, bar, 32 * c, r0, h, b);
}

// The TMA map of such an operand in boxes of 32 floats x 64 rows. A dim of
// size 1 gets the packed stride (the dims below it end to end).
inline int encode_f32(CUtensorMap* map, const void* base, int B, int H,
                      int T, int D, const Strides& s) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)T, (uint64_t)H,
                            (uint64_t)B};
  const long long e[3] = {s.t, s.h, s.b};
  uint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const uint64_t packed = i == 0 ? dims[0] * 4 : strides[i - 1] * dims[i];
    strides[i] = dims[i + 1] == 1 ? packed : (uint64_t)e[i] * 4;
    if (strides[i] % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  const uint32_t box[4] = {32, (uint32_t)kTileRows, 1, 1};
  const uint32_t es[4] = {1, 1, 1, 1};
  return encode(map, base, 4, dims, strides, box, es,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// every operand is read and written in 16-byte chunks: bases and the
// strides of dims larger than 1 in multiples of 4 floats
inline bool aligned(const void* p, const Strides& s, int B, int H, int T) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || s.b % 4 == 0) && (H == 1 || s.h % 4 == 0) &&
         (T == 1 || s.t % 4 == 0);
}

}  // namespace mxf32
