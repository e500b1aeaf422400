// What the fp32 conv kernels on the FP32 pipes share (K1 in
// fused_conv_f32.cu, K2 and K3 in conv_bwd_f32.cu), over f32_tile.cuh's
// micro-tiles: the boxes of pixels of an NHWC activation that one 4-D TMA
// load brings (ops/fused_conv.py's `tc_box`: whole rows of the width, then
// whole images, at most 64), their tensor maps (every second pixel for a
// stride-2 tap), the 16-byte global loads, and the BatchNorm prologue of 4
// channels with the plain version's roundings.

#pragma once

#include "conv_common.cuh"
#include "f32_tile.cuh"

namespace mxf32 {

using namespace mxconv;

// ---------------------------------------------------------------------------
// NHWC fp32 activations in pixel boxes (the conv kernels)
// ---------------------------------------------------------------------------
// A box of pixels: bw x bh x bn of (width, height, image), tw x th x tn
// boxes over the extent, `rows` = bw*bh*bn <= 64. Row r of a box is pixel
// (r % bw, (r / bw) % bh, r / (bw * bh)) of it.
struct Box {
  int bw, bh, bn, tw, th, tn, rows;
};

// The boxes of bw x bh x bn over an (ew, eh, en) extent; false for a box
// of no pixels or more than a tile's rows.
inline bool make_box(int bw, int bh, int bn, int ew, int eh, int en,
                     Box* box) {
  if (bw < 1 || bh < 1 || bn < 1 || bw * bh * bn > kTileRows) return false;
  *box = Box{bw, bh, bn, (ew + bw - 1) / bw, (eh + bh - 1) / bh,
             (en + bn - 1) / bn, bw * bh * bn};
  return true;
}

// Box number c of the extent: its first pixel (w0, h0, n0).
__device__ __forceinline__ void box_origin(const Box& box, int c, int& w0,
                                           int& h0, int& n0) {
  w0 = (c % box.tw) * box.bw;
  h0 = ((c / box.tw) % box.th) * box.bh;
  n0 = (c / (box.tw * box.th)) * box.bn;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The prologue's per-channel operands of 4 channels: a, b (1 and 0 with no
// BatchNorm), ar, br (0 with no residual).
struct Pro4 {
  float4 a, b, ar, br;
};

// channels ci .. ci + 3 (all inside Ci or all past it: Ci % 4 == 0); past
// Ci, or with no prologue, nothing is read
__device__ __forceinline__ Pro4 load_pro4(const float* a, const float* b,
                                          const float* ar, const float* br,
                                          int ci, bool inside) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  Pro4 p{make_float4(1.f, 1.f, 1.f, 1.f), zero, zero, zero};
  if (inside && a != nullptr) {
    p.a = ldg4(a + ci);
    p.b = ldg4(b + ci);
  }
  if (inside && ar != nullptr) {
    p.ar = ldg4(ar + ci);
    p.br = ldg4(br + ci);
  }
  return p;
}

// x_pro of 4 channels: relu(a*x + b [+ ar*r + br]) with the plain
// version's roundings (prologue_lin)
__device__ __forceinline__ float4 prologue4(float4 x, float4 r,
                                            const Pro4& p, bool has_res,
                                            bool relu) {
  float v[4] = {
      prologue_lin(x.x, p.a.x, p.b.x, has_res, r.x, p.ar.x, p.br.x),
      prologue_lin(x.y, p.a.y, p.b.y, has_res, r.y, p.ar.y, p.br.y),
      prologue_lin(x.z, p.a.z, p.b.z, has_res, r.z, p.ar.z, p.br.z),
      prologue_lin(x.w, p.a.w, p.b.w, has_res, r.w, p.ar.w, p.br.w)};
  if (relu)
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = v[q] > 0.f ? v[q] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A packed fp32 tensor of `rank` dims (innermost first, dims[0]
// contiguous) in boxes of `box`, every es[i]-th element along dim i (null:
// every one), under the 128-byte swizzle.
inline int encode_packed_f32(CUtensorMap* map, const void* base, int rank,
                             const uint64_t* dims, const uint32_t* box,
                             const uint32_t* es = nullptr) {
  uint64_t strides[4], bytes = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  const uint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, base, rank, dims, strides, box, es ? es : ones,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The map of an NHWC fp32 activation (n, h, w, c) in boxes of 32 channels
// by bw x bh x bn pixels, every `step`-th pixel along H and W (a
// stride-2 conv's taps).
inline int encode_act_f32(CUtensorMap* map, const void* base, int n, int h,
                          int w, int c, const Box& box, int step) {
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h,
                            (uint64_t)n};
  const uint32_t bx[4] = {32u, (uint32_t)(box.bw * step),
                          (uint32_t)(box.bh * step), (uint32_t)box.bn};
  const uint32_t es[4] = {1, (uint32_t)step, (uint32_t)step, 1};
  return encode_packed_f32(map, base, 4, dims, bx, es);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mxf32
