// Fused conv + BatchNorm input gradient in fp32 on Hopper's FP32 pipes
// (sm_90a): K2 as register micro-tiles fed by TMA. Plain C interface for
// ctypes.
//
// It computes what conv_bwd_dx_kernel of csrc/conv_bwd.cu computes (see
// its header: the TPU kernel `_conv_bwd_dx_kernel` of the JAX package's
// ops/pallas_conv.py), for fp32 with Ci and Co multiples of 4 (rows of
// whole 16-byte chunks, as TMA and the vector loads need) and 16-byte
// aligned operands; ops/fused_conv.py's `conv_route` sends those
// calls here ("f32"):
//   dy_t = dy + ds + 2*y*dss             fp32 (fold_cotangent, no fma)
//   dxp  = transpose-conv(dy_t, w) + g   fp32
//   lin  = a*x + b [+ ar*r + br];  dxf = relu ? (lin > 0 ? dxp : 0) : dxp
//   dx = dxf*a, dr = dxf*ar;  da = sum dxf*x, db = sum dxf, dar = sum dxf*r
// With no prologue (a and r absent) dx = dxp, unmasked, and no sums. The
// per-channel partials of a block go to `part` and the ordered
// column_sums of conv_common.cuh adds them: no atomics, and a run repeats
// bit for bit.
//
// Design: an implicit GEMM per stride phase, as in conv_bwd.cu: M = the
// phase's input pixels, N = Ci, K = the phase's taps x Co. In NHWC/HWIO
// both operands have the depth (co) contiguous, so C[pixel, ci] =
// sum_co dy_t[pixel + tap shift, co] . w[tap, ci, co] is the A . B^T form
// of flash_bwd_f32.cu's scores: a block of 256 threads owns 64 pixels x
// 64 input channels, a thread a 4 x 4 micro-tile (pixels 16*wr + lane/8 +
// 4i, channels 32*wc + lane%8 + 8j), and per 4 depths it reads one float4
// of each of its 4 A rows and 4 B rows from tiles under TMA's 128-byte
// swizzle: 8 loads of one wavefront for 64 FMAs (f32_tile.cuh). A block's
// 64 rows are a box of the phase's pixels (whole rows of its width, then
// whole images: ops/fused_conv.py's `tc_box`), so A for one tap is that
// box of dy (and of y) shifted by the tap, one 4-D TMA box of 32 channels
// (128 bytes) each; B is the box w[tap, ci0:+64, co0:+32], co contiguous.
// A step is one tap and 64 channels of Co (two such boxes of each), in a
// ring of two stages with one mbarrier each: thread 0 starts a step's
// loads while the step before it is computed.
//
// The fold: once a stage has landed each thread rewrites four 16-byte
// chunks of the dy tiles in place with the folded cotangent (4 operations
// an element, against the 64 FMAs each element feeds), then one block barrier
// makes the tile whole. TMA's zero fill is wrong after the fold (the fold
// of a zero is ds), so rows outside the tensor, rows past the box's pixels
// and channels past Co are written as 0. A thread keeps one chunk position
// in rows of one r % 8, so its 4 channels of each box, and the ds and dss
// it reads for them, are the same in both rows. That barrier is the step's
// only one: it also tells thread 0 that every thread is done with the
// stage it refills next.
//
// The epilogue goes through shared memory (the stages are free by then),
// so that a thread owns whole 16-byte chunks of 4 channels, with the loads
// of its four rows in flight together: + g, the
// prologue's mask recomputed with prologue_lin (bit for bit the
// forward's), dx and dr, and the partial da/db/dar of its channels,
// reduced over the block in a fixed order.
//
// What bounds it: 2*N*H*W*Ci*Co*taps/stride^2 FLOPs (7.40 GFLOP at 3x3
// 64->64 56^2, B=32) against about 2 bytes read per 100 FLOPs: the card's
// FP32 rate (no tensor-core path keeps fp32 off TF32). The SIMT kernel of
// conv_bwd.cu fed 256 FMAs a 16-deep step with eight gathered 4-byte loads
// of dy and y, four of w, the fold and eight transposing stores per
// thread, between two barriers; here TMA brings the tiles and a step is
// 1024 FMAs a thread behind one barrier. On an H100 the products take
// about half of a block's cycles and the fold, the waits and the barrier
// about a third (tools/torch_conv_f32_phases.py; PERF.md); two blocks an
// SM (128 registers a thread) overlap one's products with the other's.

#include "conv_common.cuh"
#include "f32_tile.cuh"

namespace {

using namespace mxconv;
using namespace mxf32;

constexpr int kBlockThreads = 256;
constexpr int kCols = 64;        // input channels of a block
constexpr int kDepthF = 32;      // output channels of a box: one 128-byte row
// boxes of Co a step, and the ring's stages: two and two measured a little
// faster than one and three at most of chip_smoke's conv shapes on an H100
// (PERF.md)
constexpr int kNB = 2;
constexpr int kStagesF = 2;
constexpr int kBoxF = kTileRows * kDepthF * 4;   // one 64 x 32 fp32 tile
constexpr int kStageBytes = 3 * kNB * kBoxF;     // dy, y, w
// floats per row of the staged output: the 4 x 8 lanes of a warp store
// to 32 distinct banks
constexpr int kStageLd = kCols + 8;

constexpr int dx_f32_smem_bytes() {
  return kAlign + kStagesF * kStageBytes + 3 * 8 * kCols * 4;
}

// A box of pixels of a stride phase: bw x bh x bn of (width, height,
// image), tw x th x tn boxes over the phase, `rows` = bw*bh*bn <= 64.
struct Box {
  int bw, bh, bn, tw, th, tn, rows;
};

// The steps of a block in order: each tap of its phase (column tx, row
// ty), and within a tap each 32-channel chunk c of Co.
struct Walk {
  int c = 0, tx = 0, ty = 0;
  __device__ __forceinline__ void next(int chunks, int nkx) {
    if (++c == chunks) {
      c = 0;
      if (++tx == nkx) {
        tx = 0;
        ++ty;
      }
    }
  }
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// One block: pixel box blockIdx.x of stride phase blockIdx.z, input
// channels blockIdx.y * 64 (+64).
__global__ void __launch_bounds__(kBlockThreads, 2)
conv_bwd_dx_f32_kernel(const __grid_constant__ CUtensorMap map_dy,
                       const __grid_constant__ CUtensorMap map_y,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ x,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ ds,
                       const float* __restrict__ dss,
                       const float* __restrict__ r,
                       const float* __restrict__ ar,
                       const float* __restrict__ br,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ dr, float* __restrict__ part,
                       long long part_rows, Shape sh, Box box, int relu) {
  constexpr int S = kStagesF;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[S];  // the stages' TMA barriers
  uint8_t* smem = aligned_smem(smem_raw);
  // the block's partial sums, [3][8 warps][64 channels]
  float* red = reinterpret_cast<float*>(smem + S * kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = sh.stride;
  const int ry = blockIdx.z / s, rx = blockIdx.z % s;
  // the taps of this phase: ky = ky0 + s*t, t < nky (same for kx)
  const int ky0 = (ry + sh.pad) % s, kx0 = (rx + sh.pad) % s;
  const int nky = ky0 < sh.KH ? (sh.KH - 1 - ky0) / s + 1 : 0;
  const int nkx = kx0 < sh.KW ? (sh.KW - 1 - kx0) / s + 1 : 0;
  const int chunks = (sh.Co + kNB * kDepthF - 1) / (kNB * kDepthF);
  const int nsteps = nky * nkx * chunks;
  const int wb = blockIdx.x % box.tw;
  const int hb = (blockIdx.x / box.tw) % box.th;
  const int nb = blockIdx.x / (box.tw * box.th);
  const int i0 = hb * box.bh, j0 = wb * box.bw, n0 = nb * box.bn;
  const int ci0 = blockIdx.y * kCols;
  const int hq = ry < sh.H ? (sh.H - ry + s - 1) / s : 0;
  const int wq = rx < sh.W ? (sh.W - rx + s - 1) / s : 0;

  // a step's chunk of Co, its tap (ky, kx) and the shift of dy against
  // the phase: exact divisions by s (1 or 2) of multiples of s
  auto tap_of = [&](const Walk& t, int& c0, int& tap, int& oy, int& ox) {
    c0 = t.c * kNB * kDepthF;
    const int ky = ky0 + s * t.ty, kx = kx0 + s * t.tx;
    tap = ky * sh.KW + kx;
    oy = (ry + sh.pad - ky) >> (s - 1);
    ox = (rx + sh.pad - kx) >> (s - 1);
  };
  // thread 0 starts step t's boxes (dy, y and w, kNB each) into stage t % S
  Walk ahead;
  auto fetch = [&](int t) {
    int c0, tap, oy, ox;
    tap_of(ahead, c0, tap, oy, ox);
    ahead.next(chunks, nkx);
    uint8_t* st = smem + (t % S) * kStageBytes;
    uint64_t* bar = &bars[t % S];
    fence_proxy_async();  // the stage's last reads and writes come first
    mbar_expect_tx(bar, kNB * (2 * box.rows * 128 + kTileRows * 128));
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      const int cb = c0 + b * kDepthF;
      tma_load_4d(st + b * kBoxF, &map_dy, bar, cb, j0 + ox, i0 + oy, n0);
      tma_load_4d(st + (kNB + b) * kBoxF, &map_y, bar, cb, j0 + ox, i0 + oy,
                  n0);
      tma_load_2d(st + (2 * kNB + b) * kBoxF, &map_w, bar, cb,
                  tap * sh.Ci + ci0);
    }
  };

  init_bars<S>(bars);
  if (tid == 0)
    for (int t = 0; t < S - 1 && t < nsteps; ++t) fetch(t);

  // the fold: thread tid rewrites chunk position fp = tid % 8 of rows
  // fr + 32k, k < 2, of each box (fr = tid / 8: one r % 8, so one logical
  // chunk)
  const int fr = tid >> 3, fp = tid & 7;
  const int fchunk = fp ^ (fr & 7);  // its channels 4 * fchunk of a box
  int fi[2], fj[2];
  bool fok[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = fr + 32 * k;
    const int jj = row % box.bw, ii = (row / box.bw) % box.bh;
    const int nn = row / (box.bw * box.bh);
    fok[k] = row < box.rows && n0 + nn < sh.N;
    fi[k] = i0 + ii;
    fj[k] = j0 + jj;
  }

  // the product: pixels ra + 4i, channels rb + 8j of the block
  const int wr = warp >> 1, wc = warp & 1, ly = lane >> 3, lx = lane & 7;
  const int ra = 16 * wr + ly, rb = 32 * wc + lx;
  const RowOffs oa(ra), ob(rb);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Walk walk;
  for (int step = 0; step < nsteps; ++step, walk.next(chunks, nkx)) {
    uint8_t* st = smem + (step % S) * kStageBytes;
    int c0, tap, oy, ox;
    tap_of(walk, c0, tap, oy, ox);
    float4 dsv[kNB], dssv[kNB];
    bool cok[kNB];
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      const int co = c0 + b * kDepthF + 4 * fchunk;
      cok[b] = co < sh.Co;  // Co % 4 == 0: the whole chunk
      dsv[b] = dssv[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cok[b]) {
        dsv[b] = ldg4(ds + co);
        dssv[b] = ldg4(dss + co);
      }
    }
    mbar_wait(&bars[step % S], (step / S) & 1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t off = (fr + 32 * k) * 128 + fp * 16;
      const int ho = fi[k] + oy, wo = fj[k] + ox;
      const bool pix =
          fok[k] && ho >= 0 && ho < sh.Ho && wo >= 0 && wo < sh.Wo;
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
        uint8_t* dt = st + b * kBoxF;
        float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
        if (pix && cok[b]) {
          const float4 d = ld4(dt, off), yv = ld4(dt + kNB * kBoxF, off);
          out = make_float4(fold_cotangent(d.x, yv.x, dsv[b].x, dssv[b].x),
                            fold_cotangent(d.y, yv.y, dsv[b].y, dssv[b].y),
                            fold_cotangent(d.z, yv.z, dsv[b].z, dssv[b].z),
                            fold_cotangent(d.w, yv.w, dsv[b].w, dssv[b].w));
        }
        *reinterpret_cast<float4*>(dt + off) = out;
      }
    }
    // the folded tile whole, and every thread done with the stage that
    // step + S - 1 refills (last read at step - 1)
    __syncthreads();
    if (tid == 0 && step + S - 1 < nsteps) fetch(step + S - 1);

#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      const uint8_t* at = st + b * kBoxF;
      const uint8_t* bt = st + (2 * kNB + b) * kBoxF;
#pragma unroll
      for (int c = 0; c < kDepthF / 4; ++c) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(at, oa.step4(i, c));
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(bt, ob.step8(j, c));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every product has read its stage

  // epilogue: the accumulator through shared memory, then thread tid owns
  // the 4-channel chunk cc = tid % 16 of rows tid / 16 + 16k, k < 4
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stage[(ra + 4 * i) * kStageLd + rb + 8 * j] = acc[i][j];
  __syncthreads();

  const bool has_pro = a != nullptr, has_res = r != nullptr;
  const bool pro = has_pro || has_res;
  const int cc = tid & 15;
  const int ci = ci0 + 4 * cc;
  const bool chok = ci < sh.Ci;  // Ci % 4 == 0: the whole chunk
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 av = make_float4(1.f, 1.f, 1.f, 1.f), bv = zero, arv = zero,
         brv = zero;
  if (chok && has_pro) {
    av = ldg4(a + ci);
    bv = ldg4(b + ci);
  }
  if (chok && has_res) {
    arv = ldg4(ar + ci);
    brv = ldg4(br + ci);
  }
  const float pa[4] = {av.x, av.y, av.z, av.w};
  const float pb[4] = {bv.x, bv.y, bv.z, bv.w};
  const float par[4] = {arv.x, arv.y, arv.z, arv.w};
  const float pbr[4] = {brv.x, brv.y, brv.z, brv.w};
  float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
  float sr[4] = {0.f, 0.f, 0.f, 0.f};
  // the four rows' offsets, then all their loads in flight together
  long long off[4];
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = (tid >> 4) + 16 * k;
    const int jj = row % box.bw, ii = (row / box.bw) % box.bh;
    const int n = n0 + row / (box.bw * box.bh), i = i0 + ii, j = j0 + jj;
    ok[k] = chok && row < box.rows && n < sh.N && i < hq && j < wq;
    off[k] = ok[k] ? (((long long)n * sh.H + ry + s * i) * sh.W + rx +
                      s * j) * sh.Ci + ci
                   : 0;
  }
  float4 gv[4], xv[4], rv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gv[k] = ok[k] && g != nullptr ? ldg4(g + off[k]) : zero;
    xv[k] = ok[k] && pro ? ldg4(x + off[k]) : zero;
    rv[k] = ok[k] && has_res ? ldg4(r + off[k]) : zero;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!ok[k]) continue;
    const int row = (tid >> 4) + 16 * k;
    const float4 sv =
        *reinterpret_cast<const float4*>(stage + row * kStageLd + 4 * cc);
    float v[4] = {sv.x, sv.y, sv.z, sv.w};
    if (g != nullptr) {
      v[0] = __fadd_rn(v[0], gv[k].x);
      v[1] = __fadd_rn(v[1], gv[k].y);
      v[2] = __fadd_rn(v[2], gv[k].z);
      v[3] = __fadd_rn(v[3], gv[k].w);
    }
    if (!pro) {
      st4(dx + off[k], v[0], v[1], v[2], v[3]);
      continue;
    }
    const float xf[4] = {xv[k].x, xv[k].y, xv[k].z, xv[k].w};
    const float rf[4] = {rv[k].x, rv[k].y, rv[k].z, rv[k].w};
    float o[4], orr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float lin = prologue_lin(xf[q], pa[q], pb[q], has_res, rf[q],
                                     par[q], pbr[q]);
      const float d = (relu && !(lin > 0.0f)) ? 0.0f : v[q];
      sa[q] += d * xf[q];
      sb[q] += d;
      sr[q] += d * rf[q];
      o[q] = __fmul_rn(d, pa[q]);
      orr[q] = __fmul_rn(d, par[q]);
    }
    st4(dx + off[k], o[0], o[1], o[2], o[3]);
    if (has_res) st4(dr + off[k], orr[0], orr[1], orr[2], orr[3]);
  }
  if (!pro) return;  // uniform over the block: no sums to take
  // a channel's partials: lanes 16 apart, then the 8 warps in order
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sa[q] += __shfl_xor_sync(0xffffffffu, sa[q], 16);
    sb[q] += __shfl_xor_sync(0xffffffffu, sb[q], 16);
    sr[q] += __shfl_xor_sync(0xffffffffu, sr[q], 16);
  }
  if (lane < 16)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[(0 * 8 + warp) * kCols + 4 * cc + q] = sa[q];
      red[(1 * 8 + warp) * kCols + 4 * cc + q] = sb[q];
      red[(2 * 8 + warp) * kCols + 4 * cc + q] = sr[q];
    }
  __syncthreads();
  const long long prow = (long long)blockIdx.z * gridDim.x + blockIdx.x;
  if (tid < 3 * kCols) {
    const int which = tid / kCols, c = tid % kCols;
    const float* q = red + which * 8 * kCols + c;
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) tot += q[w * kCols];
    if (ci0 + c < sh.Ci)
      part[((long long)which * part_rows + prow) * sh.Ci + ci0 + c] = tot;
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch
// ---------------------------------------------------------------------------
// A packed fp32 tensor of `rank` dims (innermost first, dims[0]
// contiguous) in boxes of `box`, under the 128-byte swizzle.
int encode_packed_f32(CUtensorMap* map, const void* base, int rank,
                      const uint64_t* dims, const uint32_t* box) {
  uint64_t strides[4], bytes = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  const uint32_t es[4] = {1, 1, 1, 1};
  return encode(map, base, rank, dims, strides, box, es,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

int launch_dx(const float* dy, const float* y, const float* x,
              const float* w, const float* a, const float* b,
              const float* ds, const float* dss, const float* r,
              const float* ar, const float* br, const float* g, float* dx,
              float* da, float* db, float* dr, float* dar, float* part,
              const Shape& sh, int relu, int bw, int bh, int bn,
              cudaStream_t stream) {
  const int s = sh.stride;
  const int ew = (sh.W + s - 1) / s, eh = (sh.H + s - 1) / s;
  if (bw < 1 || bh < 1 || bn < 1 || bw * bh * bn > kTileRows)
    return (int)cudaErrorInvalidValue;
  const Box box{bw, bh, bn, (ew + bw - 1) / bw, (eh + bh - 1) / bh,
                (sh.N + bn - 1) / bn, bw * bh * bn};
  CUtensorMap map_dy, map_y, map_w;
  const uint64_t adims[4] = {(uint64_t)sh.Co, (uint64_t)sh.Wo,
                             (uint64_t)sh.Ho, (uint64_t)sh.N};
  const uint32_t abox[4] = {(uint32_t)kDepthF, (uint32_t)bw, (uint32_t)bh,
                            (uint32_t)bn};
  const uint64_t wdims[2] = {(uint64_t)sh.Co,
                             (uint64_t)sh.KH * sh.KW * sh.Ci};
  const uint32_t wbox[2] = {(uint32_t)kDepthF, (uint32_t)kTileRows};
  int err;
  if ((err = encode_packed_f32(&map_dy, dy, 4, adims, abox)) ||
      (err = encode_packed_f32(&map_y, y, 4, adims, abox)) ||
      (err = encode_packed_f32(&map_w, w, 2, wdims, wbox)))
    return err;
  constexpr int smem = dx_f32_smem_bytes();
  static bool opted = false;
  if ((err = allow_smem((const void*)conv_bwd_dx_f32_kernel, smem, &opted)))
    return err;
  const int tiles = box.tw * box.th * box.tn;
  const long long part_rows = (long long)s * s * tiles;
  conv_bwd_dx_f32_kernel<<<dim3(tiles, (sh.Ci + kCols - 1) / kCols, s * s),
                           kBlockThreads, smem, stream>>>(
      map_dy, map_y, map_w, x, a, b, ds, dss, r, ar, br, g, dx, dr, part,
      part_rows, sh, box, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a != nullptr || r != nullptr)  // da, db, dar: one launch
    column_sums(part, 3, (int)part_rows, sh.Ci, da, db, dar, stream);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The fp32 input gradient on the FP32 pipes: mxtpu_conv_bwd_dx's contract
// (conv_bwd.cu) for fp32 with Ci % 4 == 0, Co % 4 == 0 and every operand
// 16-byte aligned. A block takes a box of bw x bh x bn (<= 64) pixels of
// one stride phase (the phase's width ceil(W/s), height ceil(H/s)) and 64
// channels of Ci. part: scratch of 3 * stride^2 * (boxes per phase) * Ci
// floats. Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for widths or operands it does not take, or
// kMapError + a CUresult when the tensor-map encoder refuses one.
extern "C" int mxtpu_conv_bwd_dx_f32(
    const void* dy, const void* y, const void* x, const void* w,
    const float* a, const float* b, const float* ds, const float* dss,
    const void* r, const float* ar, const float* br, const void* g, void* dx,
    float* da, float* db, void* dr, float* dar, float* part, int N, int H,
    int W, int Ci, int Co, int KH, int KW, int stride, int pad, int Ho, int Wo,
    int relu, int bw, int bh, int bn, void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  if (Ci % 4 != 0 || Co % 4 != 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {dy, y, x, w, a, b, ds, dss, r, ar, br, g, dx, dr};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  return launch_dx(static_cast<const float*>(dy),
                   static_cast<const float*>(y),
                   static_cast<const float*>(x),
                   static_cast<const float*>(w), a, b, ds, dss,
                   static_cast<const float*>(r), ar, br,
                   static_cast<const float*>(g), static_cast<float*>(dx), da,
                   db, static_cast<float*>(dr), dar, part, sh, relu, bw, bh,
                   bn, static_cast<cudaStream_t>(stream));
}
