// Fused conv + BatchNorm input and weight gradients in fp32 on Hopper's
// FP32 pipes (sm_90a): K2 and K3 as register micro-tiles fed by TMA. Plain
// C interface for ctypes. K2 first; K3 (below, "K3: dW") after it.
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
//
// K3 computes what conv_bwd_dw_kernel of csrc/conv_bwd.cu computes (the
// TPU kernel `_conv_bwd_dw_kernel`), for the same widths and operands:
//   dW[ky,kx] = sum over output pixels of x_pro(tap ky,kx)^T . dy_t
// with x_pro = relu(a*x + b [+ ar*r + br]) and dy_t folded as in K2, in
// fp32; the fp32 planes of the pixel ranges are added in order by
// conv_common.cuh's split_sum_kernel (one range writes dW itself): no
// atomics, a run repeats bit for bit. Per tap, C[ci, co] = sum_p x_pro[p,
// ci] . dy_t[p, co] has its depth (the pixels) on both operands' rows, so
// a thread's 4 x 4 micro-tile (4 input channels of one 16-byte chunk of
// x's row, 4 output channels of one chunk of dy's) reads, per pixel, one
// float4 of each: 8 loads of one wavefront for 64 FMAs, as in K2, with the
// lanes laid out so a warp's x chunks are the 8 of one row of a box and
// its dy chunks 4 of another. A block of 256 threads owns one tap (or, at
// a 3x3 stride-1 conv without a residual, the row of 3 taps: one x row
// and 3 dy rows a pixel, 4 loads for 48 FMAs, the x box rewritten once for
// the three), 64 input and 64 output channels, and walks its range of
// output-pixel boxes (ops/fused_conv.py's `dw_tc_box`, ranges by
// `dw_splits(..., "f32", taps)`): per box TMA brings dy, and x shifted by
// the tap (every second pixel at stride 2: the map's elementStrides), two
// 32-channel boxes each, into a ring of two stages, and y and r, which
// only the rewrite reads, into one buffer each, refilled with the next
// stage after the step's barrier.
// Once a stage lands each thread rewrites x_pro and dy_t in place, chunk by
// chunk, writing 0 for rows past the box, pixels outside the output, taps
// outside x and channels past Ci or Co (TMA's zero fill folds to ds and
// has a prologue of relu(b)); a plain conv only zeroes the rows past the
// box. The block's per-channel operands stay in shared memory. What bounds
// it: the same FLOPs as K2 against a few bytes per 100: the FP32 rate.

#include "conv_f32.cuh"

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
  int j0, i0, n0;
  box_origin(box, blockIdx.x, j0, i0, n0);
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
// K3: dW
// ---------------------------------------------------------------------------
// A block takes T taps of one kernel row: T = 1 in general; T = KW (3) at
// stride 1 without a residual, where its boxes are whole output rows
// widened by the KW - 1 columns the row's taps reach past them (no output
// pixels there: ops/fused_conv.py's `dw_tc_box`), so that one box of x,
// rewritten once, serves the three taps: tap kx pairs x's row p with dy's
// row p - kx. A widened column of dy is past Wo, so the fold writes it as
// 0, and the rows before a box's first (p - kx < 0) lie in 8 rows of
// zeros kept before each dy box.
template <int T>
__host__ __device__ constexpr int dw_dy_box() {  // a dy box and its zeros
  return T == 1 ? kBoxF : kBoxF + 1024;
}

// A stage holds one box of pixels: x (shifted by the block's first tap)
// and dy, two 32-channel boxes each; y and r, which only the rewrite
// reads, have one buffer each (refilled after the rewrite's barrier, with
// the stage).
template <int T>
__host__ __device__ constexpr int dw_stage() {
  return 2 * kBoxF + 2 * dw_dy_box<T>();
}
constexpr int kDwOne = 2 * kBoxF;  // y, or r

template <int T>
constexpr int dw_f32_smem_bytes(bool res) {
  return kAlign + kStagesF * dw_stage<T>() + (res ? 2 : 1) * kDwOne;
}

// One block: taps ky, kx0 .. kx0 + T - 1 (group blockIdx.x / ceil(Ci/64))
// and their 64 input channels, output channels blockIdx.y * 64 (+64), over
// the output-pixel boxes [blockIdx.z * per_split, + per_split) in order.
// Writes its T tiles of 64 x 64 fp32 of dW to `out` (a split's plane, or
// dw itself with one split).
template <int T>
__global__ void __launch_bounds__(kBlockThreads, 2)
conv_bwd_dw_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_r,
                       const __grid_constant__ CUtensorMap map_dy,
                       const __grid_constant__ CUtensorMap map_y,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ ds,
                       const float* __restrict__ dss, int has_res,
                       const float* __restrict__ ar,
                       const float* __restrict__ br, float* __restrict__ out,
                       Shape sh, Box box, int relu, int per_split) {
  constexpr int S = kStagesF, SB = dw_stage<T>(), DB = dw_dy_box<T>();
  constexpr int DY0 = DB - kBoxF;  // the zero rows before a dy box
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[S];  // the stages' TMA barriers
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ys = smem + S * SB;  // y of the step being rewritten
  uint8_t* rs = ys + kDwOne;    // r of the same step
  // the block's per-channel operands: a, b, ar, br of its input channels,
  // ds, dss of its output channels (the prologue's identity and 0 where an
  // operand is absent or past the width)
  __shared__ float4 par[6][kCols / 4];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = sh.stride;
  const int cib = (sh.Ci + kCols - 1) / kCols;
  const int group = blockIdx.x / cib;
  const int ci0 = (blockIdx.x - group * cib) * kCols;
  const int ky = T == 1 ? group / sh.KW : group;
  const int kx0 = T == 1 ? group - ky * sh.KW : 0;
  const int co0 = blockIdx.y * kCols;
  const int c_begin = blockIdx.z * per_split;
  const int total = box.tw * box.th * box.tn;
  const int nsteps = max(0, min(c_begin + per_split, total) - c_begin);
  const bool pro = a != nullptr || has_res;

  // thread 0 starts box c_begin + t's loads: x and dy into stage t % S, y
  // and r into their buffers
  auto fetch = [&](int t) {
    int wo0, ho0, n0;
    box_origin(box, c_begin + t, wo0, ho0, n0);
    const int wi0 = wo0 * s - sh.pad + kx0, hi0 = ho0 * s - sh.pad + ky;
    uint8_t* st = smem + (t % S) * SB;
    uint64_t* bar = &bars[t % S];
    fence_proxy_async();  // the stage's last reads and writes come first
    mbar_expect_tx(bar, (6 + 2 * has_res) * box.rows * 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tma_load_4d(st + h * kBoxF, &map_x, bar, ci0 + h * kDepthF, wi0, hi0,
                  n0);
      tma_load_4d(st + 2 * kBoxF + h * DB + DY0, &map_dy, bar,
                  co0 + h * kDepthF, wo0, ho0, n0);
      tma_load_4d(ys + h * kBoxF, &map_y, bar, co0 + h * kDepthF, wo0, ho0,
                  n0);
      if (has_res)
        tma_load_4d(rs + h * kBoxF, &map_r, bar, ci0 + h * kDepthF, wi0, hi0,
                    n0);
    }
  };

  if (tid < kCols / 4) {
    const int ci = ci0 + 4 * tid, co = co0 + 4 * tid;
    const Pro4 p = load_pro4(a, b, ar, br, ci, ci < sh.Ci);
    par[0][tid] = p.a;
    par[1][tid] = p.b;
    par[2][tid] = p.ar;
    par[3][tid] = p.br;
    const bool cok = co < sh.Co;
    par[4][tid] = cok ? ldg4(ds + co) : make_float4(0.f, 0.f, 0.f, 0.f);
    par[5][tid] = cok ? ldg4(dss + co) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (T > 1)  // the zero rows before each dy box of each stage
    for (int q = tid; q < S * 2 * DY0 / 16; q += kBlockThreads) {
      const int box_i = q / (DY0 / 16), off = q % (DY0 / 16);
      *reinterpret_cast<float4*>(smem + (box_i / 2) * SB + 2 * kBoxF +
                                 (box_i % 2) * DB + off * 16) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  init_bars<S>(bars);  // its barrier also makes `par` and the zeros whole
  if (tid == 0 && nsteps > 0) fetch(0);

  // the rewrite: thread tid takes chunk position fp = tid % 8 of rows fr
  // and fr + 32 (fr = tid / 8: one r % 8, so one logical chunk, channels
  // 4 * fchunk of each box) of the x and the dy tiles
  const int fr = tid >> 3, fp = tid & 7;
  const int fchunk = fp ^ (fr & 7);
  int fj[2], fi[2], fn[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = fr + 32 * k;
    fj[k] = row % box.bw;
    fi[k] = (row / box.bw) % box.bh;
    fn[k] = row / (box.bw * box.bh);
  }

  // the product: input channels 32 * (warp % 2) + 4 * (lane % 8) + i and
  // output channels 4 * cy + j, cy = 4 * (warp / 2) + lane / 8; per pixel
  // row p one float4 of x and, per tap, one of dy's row p - kx: x's lands
  // in the 8 chunks of one row of a box and dy's in 4 (each one
  // wavefront). oxk[k], oyk[k]: the offsets of those chunks in row k of a
  // stage (row p: + (p / 8) * 1024, p % 8 = k).
  const int xb = warp & 1, lx = lane & 7;
  const int cy = 4 * (warp >> 1) + (lane >> 3);
  uint32_t oxk[8], oyk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    oxk[k] = xb * kBoxF + k * 128 + ((lx ^ k) << 4);
    oyk[k] = 2 * kBoxF + (cy >> 3) * DB + DY0 + k * 128 +
             (((cy & 7) ^ k) << 4);
  }
  const int nq = (box.rows + 7) >> 3;  // 8-row groups holding pixels
  float acc[T][4][4];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int step = 0; step < nsteps; ++step) {
    uint8_t* st = smem + (step % S) * SB;
    int wo0, ho0, n0;
    box_origin(box, c_begin + step, wo0, ho0, n0);
    mbar_wait(&bars[step % S], (step / S) & 1);
    // dW's rewrite: x_pro in place of x, dy_t in place of dy; 0 for rows
    // past the box, pixels outside the output, taps outside x (the
    // padding) and channels past Ci or Co
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = fr + 32 * k;
      const uint32_t off = row * 128 + fp * 16;
      const int n = n0 + fn[k], ho = ho0 + fi[k], wo = wo0 + fj[k];
      const bool in = row < box.rows && n < sh.N;
      const bool pix = in && ho < sh.Ho && wo < sh.Wo;
      const int hi = ho * s - sh.pad + ky, wi = wo * s - sh.pad + kx0;
      const bool xin = in && hi >= 0 && hi < sh.H && wi >= 0 && wi < sh.W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + h * kDepthF + 4 * fchunk;
        uint8_t* dt = st + 2 * kBoxF + h * DB + DY0;
        const int pc = h * (kDepthF / 4) + fchunk;  // chunk in `par`
        float4 d = zero;
        if (pix && co < sh.Co) {
          const float4 dv = ld4(dt, off), yv = ld4(ys + h * kBoxF, off);
          const float4 sv = par[4][pc], qv = par[5][pc];
          d = make_float4(fold_cotangent(dv.x, yv.x, sv.x, qv.x),
                          fold_cotangent(dv.y, yv.y, sv.y, qv.y),
                          fold_cotangent(dv.z, yv.z, sv.z, qv.z),
                          fold_cotangent(dv.w, yv.w, sv.w, qv.w));
        }
        *reinterpret_cast<float4*>(dt + off) = d;
        // x: with no prologue TMA's zero fill is the padding already;
        // only the rows past the box hold stale values
        const int ci = ci0 + h * kDepthF + 4 * fchunk;
        uint8_t* xt = st + h * kBoxF;
        if (pro) {
          float4 v = zero;
          if (xin && ci < sh.Ci)
            v = prologue4(ld4(xt, off),
                          has_res ? ld4(rs + h * kBoxF, off) : zero,
                          Pro4{par[0][pc], par[1][pc], par[2][pc],
                               par[3][pc]},
                          has_res, relu);
          *reinterpret_cast<float4*>(xt + off) = v;
        } else if (row >= box.rows) {
          *reinterpret_cast<float4*>(xt + off) = zero;
        }
      }
    }
    // the rewritten tiles whole, and every thread done with the stage and
    // the y and r buffers that the next loads refill
    __syncthreads();
    if (tid == 0 && step + 1 < nsteps) fetch(step + 1);

    // 8 pixel rows of the product, rows 8q .. 8q + 7
    auto rows8 = [&](int q) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 xv = ld4(st, q * 1024 + oxk[k]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int t = 0; t < T; ++t) {
          // dy's row p - t: row k - t of this 8-row group, or of the one
          // before (the zero rows before the box for the first group)
          const float4 dv = k >= t ? ld4(st, q * 1024 + oyk[k - t])
                                   : ld4(st, (q - 1) * 1024 + oyk[k - t + 8]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[t][i][0] = fmaf(xs[i], dv.x, acc[t][i][0]);
            acc[t][i][1] = fmaf(xs[i], dv.y, acc[t][i][1]);
            acc[t][i][2] = fmaf(xs[i], dv.z, acc[t][i][2]);
            acc[t][i][3] = fmaf(xs[i], dv.w, acc[t][i][3]);
          }
        }
      }
    };
    if constexpr (T == 1) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q >= nq) break;  // uniform over the block
        rows8(q);
      }
    } else {  // unrolled over 64 rows, 3 taps outgrow the instruction cache
      for (int q = 0; q < nq; ++q) rows8(q);
    }
  }

  // the block's tiles of dW[ky, kx0 + t], rows ci, 4 channels of Co each
  const long long plane = (long long)sh.KH * sh.KW * sh.Ci * sh.Co;
  const int co = co0 + 4 * cy;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float* o = out + blockIdx.z * plane +
               (long long)(ky * sh.KW + kx0 + t) * sh.Ci * sh.Co + co;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = ci0 + 32 * xb + 4 * lx + i;
      if (ci < sh.Ci && co < sh.Co)
        st4(o + (long long)ci * sh.Co, acc[t][i][0], acc[t][i][1],
            acc[t][i][2], acc[t][i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launches
// ---------------------------------------------------------------------------
int launch_dx(const float* dy, const float* y, const float* x,
              const float* w, const float* a, const float* b,
              const float* ds, const float* dss, const float* r,
              const float* ar, const float* br, const float* g, float* dx,
              float* da, float* db, float* dr, float* dar, float* part,
              const Shape& sh, int relu, int bw, int bh, int bn,
              cudaStream_t stream) {
  const int s = sh.stride;
  Box box;
  if (!make_box(bw, bh, bn, (sh.W + s - 1) / s, (sh.H + s - 1) / s, sh.N,
                &box))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_dy, map_y, map_w;
  const uint64_t wdims[2] = {(uint64_t)sh.Co,
                             (uint64_t)sh.KH * sh.KW * sh.Ci};
  const uint32_t wbox[2] = {(uint32_t)kDepthF, (uint32_t)kTileRows};
  int err;
  if ((err = encode_act_f32(&map_dy, dy, sh.N, sh.Ho, sh.Wo, sh.Co, box,
                            1)) ||
      (err = encode_act_f32(&map_y, y, sh.N, sh.Ho, sh.Wo, sh.Co, box, 1)) ||
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

template <int T>
int launch_dw_taps(const CUtensorMap (&maps)[4], const float* a,
                   const float* b, const float* ds, const float* dss,
                   const float* r, const float* ar, const float* br,
                   float* out, int splits, const Shape& sh, const Box& box,
                   int relu, cudaStream_t stream) {
  static bool opted = false;
  const int err = allow_smem((const void*)conv_bwd_dw_f32_kernel<T>,
                             dw_f32_smem_bytes<T>(true), &opted);
  if (err) return err;
  const int total = box.tw * box.th * box.tn;
  const int per_split = (total + splits - 1) / splits;
  const dim3 grid(sh.KH * (sh.KW / T) * ((sh.Ci + kCols - 1) / kCols),
                  (sh.Co + kCols - 1) / kCols, splits);
  conv_bwd_dw_f32_kernel<T><<<grid, kBlockThreads,
                              dw_f32_smem_bytes<T>(r != nullptr), stream>>>(
      maps[0], maps[1], maps[2], maps[3], a, b, ds, dss, r != nullptr ? 1 : 0,
      ar, br, out, sh, box, relu, per_split);
  return (int)cudaGetLastError();
}

int launch_dw(const float* x, const float* dy, const float* y,
              const float* a, const float* b, const float* ds,
              const float* dss, const float* r, const float* ar,
              const float* br, float* dw, float* part, int splits,
              const Shape& sh, int relu, int bw, int bh, int bn, int taps,
              cudaStream_t stream) {
  Box box;
  if (splits < 1 || !make_box(bw, bh, bn, sh.Wo, sh.Ho, sh.N, &box))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];  // x, r, dy, y
  int err;
  if ((err = encode_act_f32(&maps[0], x, sh.N, sh.H, sh.W, sh.Ci, box,
                            sh.stride)) ||
      (err = encode_act_f32(&maps[1], r != nullptr ? r : x, sh.N, sh.H, sh.W,
                            sh.Ci, box, sh.stride)) ||
      (err = encode_act_f32(&maps[2], dy, sh.N, sh.Ho, sh.Wo, sh.Co, box,
                            1)) ||
      (err = encode_act_f32(&maps[3], y, sh.N, sh.Ho, sh.Wo, sh.Co, box, 1)))
    return err;
  float* out = splits == 1 ? dw : part;
  err = taps == 1 ? launch_dw_taps<1>(maps, a, b, ds, dss, r, ar, br, out,
                                      splits, sh, box, relu, stream)
                  : launch_dw_taps<3>(maps, a, b, ds, dss, r, ar, br, out,
                                      splits, sh, box, relu, stream);
  if (err != 0 || splits == 1) return err;
  const long long cols = (long long)sh.KH * sh.KW * sh.Ci * sh.Co;
  const long long blocks = (cols + 255) / 256;
  split_sum_kernel<float><<<(int)(blocks < 65535 ? blocks : 65535), 256, 0,
                            stream>>>(part, splits, cols, dw);
  return (int)cudaGetLastError();
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

// The fp32 weight gradient on the FP32 pipes: mxtpu_conv_bwd_dw's contract
// (conv_bwd.cu) for fp32 with Ci % 4 == 0, Co % 4 == 0 and every operand
// 16-byte aligned. The output pixels are cut into boxes of bw x bh x bn
// (<= 64) and the boxes into `splits` ranges of whole boxes. taps: 1, or
// KW (3) for a stride-1 conv without a residual, whose boxes are then bw =
// Wo + KW - 1 wide (one whole row of the output and the KW - 1 columns the
// row's taps reach past it). part: scratch of splits * KH*KW*Ci*Co floats
// (unused with one split). Returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for widths, boxes or operands it does
// not take, or kMapError + a CUresult when the tensor-map encoder refuses
// one.
extern "C" int mxtpu_conv_bwd_dw_f32(
    const void* x, const void* dy, const void* y, const float* a,
    const float* b, const float* ds, const float* dss, const void* r,
    const float* ar, const float* br, void* dw, float* part, int splits,
    int N, int H, int W, int Ci, int Co, int KH, int KW, int stride, int pad,
    int Ho, int Wo, int relu, int bw, int bh, int bn, int taps,
    void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  if (Ci % 4 != 0 || Co % 4 != 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  if (taps != 1 && (taps != 3 || KW != 3 || stride != 1 || r != nullptr ||
                    bw != Wo + KW - 1 || bn != 1))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, dy, y, a, b, ds, dss, r, ar, br, dw, part};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  return launch_dw(static_cast<const float*>(x),
                   static_cast<const float*>(dy),
                   static_cast<const float*>(y), a, b, ds, dss,
                   static_cast<const float*>(r), ar, br,
                   static_cast<float*>(dw), part, splits, sh, relu, bw, bh,
                   bn, taps, static_cast<cudaStream_t>(stream));
}
