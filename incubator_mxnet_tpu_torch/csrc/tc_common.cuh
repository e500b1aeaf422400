// Pieces shared by the bf16 tensor-core conv kernels on Hopper (sm_90a):
// conv_bwd_tc.cu (K2, K3) and fused_conv_tc.cu (K1). The 16-byte chunk
// helpers of the in-place tile rewrites (the BatchNorm prologue of x); the
// pixel boxes; and, on the host, the TMA tensor maps of packed NHWC
// tensors. The generic Hopper pieces (mbarriers, TMA, wgmma, descriptors,
// the tensor-map encoder) are in hopper.cuh.
//
// Every tile is 64 rows of 64 bf16 (128 bytes) under TMA's 128-byte
// swizzle: one offset is one (row, channel) in every tile, and the 16-byte
// chunk q of row r holds the channels (q ^ r % 8) * 8.

#pragma once

#include "conv_common.cuh"
#include "hopper.cuh"

namespace mxconv {

using namespace mxhop;

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;        // rows of a block: one m64 wgmma
constexpr int kDepth = 64;       // depth of a stage: one 128-byte row
constexpr int kStages = 3;       // ring of shared-memory stages
constexpr int kTcThreads = 160;  // consumer warpgroup + producer warp
constexpr int kTileBytes = kRows * kDepth * 2;  // one 64x64 bf16 tile

// A box of pixels: bw x bh x bn of (width, height, image), tw x th x tn
// boxes over the extent, `rows` = bw*bh*bn <= 64 of them real.
struct Geo {
  int bw, bh, bn, tw, th, tn, rows;
};

// ---------------------------------------------------------------------------
// the elementwise rewrites of a 16-byte chunk (8 channels)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}


// The per-channel operands of the x prologue (K1, K3), 8 channels.
struct Pro8 {
  float a[8], b[8], ar[8], br[8];
};

// x_pro of 8 channels: relu(a*x + b [+ ar*r + br]) in fp32, rounded to
// bf16 (x itself with no prologue).
__device__ __forceinline__ uint4 prologue8(uint4 xv, uint4 rv, const Pro8& p,
                                           bool has_res, bool relu) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 x = __bfloat1622float2(x2[q]);
    const float2 r = __bfloat1622float2(r2[q]);
    float v0 = prologue_lin(x.x, p.a[2 * q], p.b[2 * q], has_res, r.x,
                            p.ar[2 * q], p.br[2 * q]);
    float v1 = prologue_lin(x.y, p.a[2 * q + 1], p.b[2 * q + 1], has_res,
                            r.y, p.ar[2 * q + 1], p.br[2 * q + 1]);
    if (relu) {
      v0 = v0 > 0.0f ? v0 : 0.0f;
      v1 = v1 > 0.0f ? v1 : 0.0f;
    }
    o2[q] = __floats2bfloat162_rn(v0, v1);
  }
  return out;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}

__device__ __forceinline__ void st16(bf16* p, const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Row r of a box: its (width, height, image) offsets inside the box.
__device__ __forceinline__ void box_pos(const Geo& g, int r, int& jj, int& ii,
                                        int& nn) {
  jj = r % g.bw;
  ii = (r / g.bw) % g.bh;
  nn = r / (g.bw * g.bh);
}


// A packed bf16 tensor of `rank` dims (innermost first, dims[0]
// contiguous): hopper.cuh's encode with the strides of its dims.
inline int encode_packed(CUtensorMap* map, const void* base, int rank,
                         const uint64_t* dims, const uint32_t* box,
                         const uint32_t* estride) {
  uint64_t strides[4], bytes = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  return encode(map, base, rank, dims, strides, box, estride);
}

// The map of an NHWC activation (n, h, w, c) in boxes of 64 channels by
// bw x bh x bn pixels, every `step`-th pixel along H and W.
inline int encode_act(CUtensorMap* map, const void* base, int n, int h,
                      int w, int c, const Geo& geo, int step) {
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h,
                            (uint64_t)n};
  const uint32_t box[4] = {(uint32_t)kDepth, (uint32_t)(geo.bw * step),
                           (uint32_t)(geo.bh * step), (uint32_t)geo.bn};
  const uint32_t es[4] = {1, (uint32_t)step, (uint32_t)step, 1};
  return encode_packed(map, base, 4, dims, box, es);
}

// The box geometry over (ew, eh, en) pixels from its box (bw, bh, bn).
inline int make_geo(int bw, int bh, int bn, int ew, int eh, int en,
                    Geo* geo) {
  if (bw < 1 || bh < 1 || bn < 1 || bw * bh * bn > kRows)
    return (int)cudaErrorInvalidValue;
  *geo = Geo{bw, bh, bn, (ew + bw - 1) / bw, (eh + bh - 1) / bh,
             (en + bn - 1) / bn, bw * bh * bn};
  return 0;
}

}  // namespace mxconv
