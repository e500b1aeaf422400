// Fused conv + BatchNorm backward in bf16 on Hopper's tensor cores
// (sm_90a): the input-gradient kernel (K2) and the weight-gradient kernel
// (K3) as wgmma products of shared-memory tiles that TMA fills. Plain C
// interface for ctypes.
//
// They compute what csrc/conv_bwd.cu computes (see its header: the TPU
// kernels `_conv_bwd_dx_kernel` and `_conv_bwd_dw_kernel` of the JAX
// package's ops/pallas_conv.py), for bf16 with Ci and Co multiples of 8:
// TMA needs 16-byte row strides. ops/fused_conv.py's `conv_bwd_route`
// sends every other call to conv_bwd.cu.
//
// What bounds them: by their bytes and operations, most ResNet-50 convs
// in bf16 are bound by bytes (chip_smoke.conv_bound), so the products run
// on wgmma (m64, bf16 in, fp32 accumulate) and the bytes come in by TMA,
// each tile in one request, into a ring of three stages that one producer
// warp keeps full while the consumer warpgroup works. Two blocks share an
// SM, so one block's rewrites overlap the other's products. On the card
// they are bound by neither: the consumer's per-tile rewrites below (about
// 40 fp32 and conversion instructions per 16-byte chunk, repeated for
// every tap and channel block that reads the chunk) and the waits between
// them set the time (tools/torch_conv_tc_phases.py counts the cycles). So
// at stride 1 a 3-wide kernel row shares one rewritten tile among its
// three taps (below). More stages at one block per SM, or two stages at
// three, measured no faster on an H100 (PERF.md).
//
// Both operands of both products carry elementwise work that the plain
// version does in fp32 and rounds to bf16 (the folded cotangent dy_t =
// dy + ds + 2*y*dss, and K3's x_pro = relu(a*x + b [+ ar*r + br])). TMA
// brings the raw tiles; the consumer warpgroup rewrites each tile in
// place, 16-byte chunk by chunk, then runs fence.proxy.async so that the
// wgmma (the async proxy) sees the rewritten tile. All tiles are 64 rows
// of 64 bf16 (128 bytes) under TMA's 128-byte swizzle, so the same chunk
// offset in two tiles holds the same (row, channel) and a chunk's channel
// is (chunk ^ row % 8) * 8: the rewrite needs no unswizzling beyond that.
// It also writes the zeros of the conv padding: TMA's zero fill is right
// for dy and x, but the fold of a zero is ds and the prologue of a zero is
// relu(b), so rows outside the tensor and channels past its width are
// written as 0, as are rows past the pixels a box holds.
//
// K2: an implicit GEMM per stride phase (as in conv_bwd.cu): M = the
// phase's input pixels, N = Ci, K = taps * Co. A block's 64 rows are a
// box of pixels (whole rows of the phase's width, then whole images), so
// A for one tap is the same box of dy shifted by the tap, loaded by one
// 4-D TMA; B is the tap's weight w[ky,kx,ci0:+BN,co0:+64], co contiguous:
// K-major, wgmma's native layout. At stride 1 with KW = 3 a step takes a
// row of 3 taps: the box is widened by 2 columns, and each tap's A is the
// one folded tile shifted by whole rows. The epilogue (+ g, the recomputed ReLU
// mask, dx/dr, per-channel partials of da/db/dar, then the ordered
// column_sum) reads the accumulator in wgmma's register layout.
// K3: per tap, M = Ci, N = Co, K = output pixels in boxes of at most 64,
// split over the grid's third dimension with fp32 partial planes and the
// ordered split_sum_kernel (deterministic, no atomics). Both operands are
// MN-major (ci and co contiguous): wgmma reads them transposed. For stride
// 2 the x map's elementStrides are 2 on H and W, so one box is the tap's
// strided pixels. At stride 1 with KW = 3 and no residual a block takes a
// row of 3 taps the same way as K2, sharing the rewritten x and dy.

#include "tc_common.cuh"

namespace {

using namespace mxconv;

// dy_t of 8 channels: fold_cotangent in fp32, rounded to bf16.
__device__ __forceinline__ uint4 fold8(uint4 dv, uint4 yv, const float (&ds)[8],
                                       const float (&dss)[8]) {
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 d = __bfloat1622float2(d2[q]);
    const float2 y = __bfloat1622float2(y2[q]);
    o2[q] = __floats2bfloat162_rn(
        fold_cotangent(d.x, y.x, ds[2 * q], dss[2 * q]),
        fold_cotangent(d.y, y.y, ds[2 * q + 1], dss[2 * q + 1]));
  }
  return out;
}

// The steps of a K2 block, in order: each tap of its stride phase (tap
// column tx, row ty), and within a tap each 64-channel chunk c of Co.
struct TapWalk {
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

// The steps of a K3 block, in order: its pixel boxes (wb, hb, nb).
struct BoxWalk {
  int wb, hb, nb;
  __device__ __forceinline__ BoxWalk(const Geo& g, int c)
      : wb(c % g.tw), hb((c / g.tw) % g.th), nb(c / (g.tw * g.th)) {}
  __device__ __forceinline__ void next(const Geo& g) {
    if (++wb == g.tw) {
      wb = 0;
      if (++hb == g.th) {
        hb = 0;
        ++nb;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// K2: dx
// ---------------------------------------------------------------------------
// K2 takes T taps of one kernel row per step: T = 1 in general; T = KW (3)
// at stride 1, where a block's box is whole rows of the input widened by
// the KW - 1 columns the row's taps reach (no output pixels there), so
// one box of dy, folded once, is A for all KW taps: tap kx's operand is
// that tile KW - 1 - kx rows further on, against kx's own weight tile.
template <int T>
__host__ __device__ constexpr int dx_dy_bytes() {  // rows for the shifts
  return T == 1 ? kTileBytes : kTileBytes + 1024;
}

template <int T>
__host__ __device__ constexpr int dx_stages() {  // two blocks an SM
  return T == 1 ? kStages : 2;
}

template <int BN, int T>
__host__ __device__ constexpr int dx_stage_bytes() {
  return 2 * dx_dy_bytes<T>() + T * BN * kDepth * 2;  // dy, y, T of w
}

template <int BN, int T>
__host__ __device__ constexpr int dx_smem_bytes() {
  return 1024 + dx_stages<T>() * dx_stage_bytes<BN, T>() +
         2 * dx_stages<T>() * 8 + 3 * 4 * BN * 4;
}

// One block: the 64-pixel box blockIdx.x of stride phase blockIdx.z, input
// channels blockIdx.y*BN (+BN). Threads 0-127 are the consumer warpgroup,
// thread 128 the producer.
template <int BN, int T>
__global__ void __launch_bounds__(kTcThreads, 2)
conv_bwd_dx_tc_kernel(const __grid_constant__ CUtensorMap map_dy,
                      const __grid_constant__ CUtensorMap map_y,
                      const __grid_constant__ CUtensorMap map_w,
                      const bf16* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ ds,
                      const float* __restrict__ dss,
                      const bf16* __restrict__ r,
                      const float* __restrict__ ar,
                      const float* __restrict__ br,
                      const bf16* __restrict__ g, bf16* __restrict__ dx,
                      bf16* __restrict__ dr, float* __restrict__ part,
                      long long part_rows, Shape sh, Geo geo, int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  constexpr int kS = dx_stages<T>();
  constexpr int kX = dx_dy_bytes<T>();
  constexpr int kStage = dx_stage_bytes<BN, T>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * kStage);
  uint64_t* empty = full + kS;
  float* red = reinterpret_cast<float*>(empty + kS);  // [3][4][BN]

  const int tid = threadIdx.x;
  const int s = sh.stride;
  const int ry = blockIdx.z / s, rx = blockIdx.z % s;
  // the taps of this phase: ky = ky0 + s*t, t < nky (same for kx)
  const int ky0 = (ry + sh.pad) % s, kx0 = (rx + sh.pad) % s;
  const int nky = ky0 < sh.KH ? (sh.KH - 1 - ky0) / s + 1 : 0;
  const int nkx = kx0 < sh.KW ? (sh.KW - 1 - kx0) / s + 1 : 0;
  const int chunks = (sh.Co + kDepth - 1) / kDepth;
  const int nkx_steps = T == 1 ? nkx : 1;  // T > 1: a row of taps a step
  const int nsteps = nky * nkx_steps * chunks;
  const int wb = blockIdx.x % geo.tw;
  const int hb = (blockIdx.x / geo.tw) % geo.th;
  const int nb = blockIdx.x / (geo.tw * geo.th);
  const int i0 = hb * geo.bh, j0 = wb * geo.bw, n0 = nb * geo.bn;
  const int ci0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int k = 0; k < kS; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a step's Co chunk, first tap, and the shift of dy against the phase
  // (for a row of taps, that of its last tap: the box's first column)
  auto tap_of = [&](const TapWalk& t, int& c0, int& tapi, int& oy,
                    int& ox) {
    c0 = t.c * kDepth;
    const int ky = ky0 + s * t.ty;
    const int kx = T == 1 ? kx0 + s * t.tx : sh.KW - 1;
    tapi = ky * sh.KW + (T == 1 ? kx : 0);
    // exact divisions by s (1 or 2) of multiples of s: a shift, not the
    // long sequence an integer division by a run-time value compiles to
    oy = (ry + sh.pad - ky) >> (s - 1);
    ox = (rx + sh.pad - kx) >> (s - 1);
  };

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128) {
      const uint32_t bytes =
          2 * geo.rows * kDepth * 2 + T * BN * kDepth * 2;
      TapWalk walk;
      for (int step = 0; step < nsteps;
           ++step, walk.next(chunks, nkx_steps)) {
        const int st = step % kS;
        const uint32_t round = step / kS;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        int c0, tapi, oy, ox;
        tap_of(walk, c0, tapi, oy, ox);
        uint8_t* base = smem + st * kStage;
        mbar_expect_tx(&full[st], bytes);
        tma_load_4d(base, &map_dy, &full[st], c0, j0 + ox, i0 + oy, n0);
        tma_load_4d(base + kX, &map_y, &full[st], c0, j0 + ox, i0 + oy, n0);
        for (int t = 0; t < T; ++t)
          tma_load_2d(base + 2 * kX + t * BN * kDepth * 2, &map_w, &full[st],
                      c0, (tapi + t) * sh.Ci + ci0);
      }
    }
    return;
  }

  // the consumer warpgroup. Fold: thread tid rewrites the 16-byte chunk
  // tid % 8 of rows tid/8 + 16k, k < 4; all four hold the same channels.
  const int prow = tid >> 3, pchunk = tid & 7;
  const int lchunk = pchunk ^ (prow & 7);
  int fi[4], fj[4];
  bool fok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int jj, ii, nn;
    const int row = prow + 16 * k;
    box_pos(geo, row, jj, ii, nn);
    fok[k] = row < geo.rows && n0 + nn < sh.N;
    fi[k] = i0 + ii;
    fj[k] = j0 + jj;
  }

  // the epilogue's chunks: thread tid owns channels ci0 + 8*(tid % kCpr)
  // of rows tid / kCpr + k * (128 / kCpr)
  constexpr int kCpr = BN / 8;                 // chunks per row
  constexpr int kChunks = kRows * kCpr / 128;  // chunks per thread
  const bool has_pro = a != nullptr, has_res = r != nullptr;
  const bool pro = has_pro || has_res;
  const int hq = ry < sh.H ? (sh.H - ry + s - 1) / s : 0;
  const int wq = rx < sh.W ? (sh.W - rx + s - 1) / s : 0;
  const int cc = tid % kCpr;
  const int ci = ci0 + cc * 8;
  const bool cok = ci < sh.Ci;  // Ci % 8 == 0: the whole chunk
  auto epi_chunk = [&](int k, long long& off) {
    const int row = tid / kCpr + k * (128 / kCpr);
    int jj, ii, nn;
    box_pos(geo, row, jj, ii, nn);
    const int n = n0 + nn, i = i0 + ii, j = j0 + jj;
    const bool ok = cok && row < geo.rows && n < sh.N && i < hq && j < wq;
    off = ok ? (((long long)n * sh.H + ry + s * i) * sh.W + rx + s * j) *
                       sh.Ci + ci
             : 0;
    return ok;
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);

  TapWalk walk;
  for (int step = 0; step < nsteps; ++step, walk.next(chunks, nkx_steps)) {
    const int st = step % kS;
    const uint32_t round = step / kS;
    int c0, tapi, oy, ox;
    tap_of(walk, c0, tapi, oy, ox);
    const int co = c0 + lchunk * 8;
    const bool cok_f = co < sh.Co;
    float dsv[8], dssv[8];
    if (cok_f) {
      load8(ds + co, dsv);
      load8(dss + co, dssv);
    }
    mbar_wait(&full[st], round & 1);
    uint8_t* base = smem + st * kStage;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int off = (prow + 16 * k) * 128 + pchunk * 16;
      const int ho = fi[k] + oy, wo = fj[k] + ox;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (cok_f && fok[k] && ho >= 0 && ho < sh.Ho && wo >= 0 && wo < sh.Wo)
        out = fold8(*reinterpret_cast<const uint4*>(base + off),
                    *reinterpret_cast<const uint4*>(base + kX + off), dsv,
                    dssv);
      *reinterpret_cast<uint4*>(base + off) = out;
    }
    fence_proxy_async();
    sync_consumers();
    wgmma_fence();
    // tap t of a row reads dy T - 1 - t rows further on (see K3 on rows
    // that start inside a swizzle atom)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_tile<BN, 0, 0>(
            acc, smem_desc(base + (T - 1 - t) * 128 + kk * 32, 0, 1024),
            smem_desc(base + 2 * kX + t * BN * kDepth * 2 + kk * 32, 0,
                      1024));
    wgmma_commit();
    // the products of this step run on while the next step's tile is
    // folded; the previous step's are done, so its stage goes back
    wgmma_wait<1>();
    fence_regs(acc);
    if (step > 0) mbar_arrive(&empty[(step - 1) % kS]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue. The accumulator goes through shared memory (the stages are
  // free: every load has landed and every product has read its tiles), so
  // that each thread then owns whole 16-byte chunks of 8 channels: + g, the
  // prologue's mask, dx (dr), the partial da/db/dar, all in 16-byte loads
  // and stores, the loads of four chunks in flight together.
  constexpr int kLd = BN + 4;  // floats per staged row
  static_assert(kRows * kLd * 4 <= kS * kStage, "staging fits");
  float* stage = reinterpret_cast<float*>(smem);
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      *reinterpret_cast<float2*>(
          stage + (warp * 16 + (lane >> 2) + 8 * h2) * kLd + jb * 8 +
          2 * (lane & 3)) =
          make_float2(acc[jb * 4 + h2 * 2], acc[jb * 4 + h2 * 2 + 1]);
  sync_consumers();

  Pro8 p;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    p.a[q] = (cok && has_pro) ? a[ci + q] : 1.0f;
    p.b[q] = (cok && has_pro) ? b[ci + q] : 0.0f;
    p.ar[q] = (cok && has_res) ? ar[ci + q] : 0.0f;
    p.br[q] = (cok && has_res) ? br[ci + q] : 0.0f;
  }
  float sa[8], sb[8], sr[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sa[q] = sb[q] = sr[q] = 0.0f;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k0 = 0; k0 < kChunks; k0 += 4) {
    long long off[4];
    bool ok[4];
    uint4 xv[4], gv[4], rv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ok[k] = epi_chunk(k0 + k, off[k]);
      gv[k] = ok[k] && g != nullptr ? ld16(g + off[k]) : zero;
      xv[k] = ok[k] && pro ? ld16(x + off[k]) : zero;
      rv[k] = ok[k] && has_res ? ld16(r + off[k]) : zero;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!ok[k]) continue;
      const int row = tid / kCpr + (k0 + k) * (128 / kCpr);
      const float4* sp =
          reinterpret_cast<const float4*>(stage + row * kLd + cc * 8);
      const float4 v0 = sp[0], v1 = sp[1];
      float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      float gf[8], xf[8], rf[8];
      unpack8(gv[k], gf);
      unpack8(xv[k], xf);
      unpack8(rv[k], rf);
      if (g != nullptr)
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __fadd_rn(v[q], gf[q]);
      if (!pro) {
        st16(dx + off[k], v);
        continue;
      }
      float d[8], o[8], orr[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float lin = prologue_lin(xf[q], p.a[q], p.b[q], has_res, rf[q],
                                       p.ar[q], p.br[q]);
        d[q] = (relu && !(lin > 0.0f)) ? 0.0f : v[q];
        sa[q] += d[q] * xf[q];
        sb[q] += d[q];
        sr[q] += d[q] * rf[q];
        o[q] = __fmul_rn(d[q], p.a[q]);
        orr[q] = __fmul_rn(d[q], p.ar[q]);
      }
      st16(dx + off[k], o);
      if (has_res) st16(dr + off[k], orr);
    }
  }
  if (!pro) return;  // uniform over the block: no sums to take
  // a column's partials: the lanes kCpr apart in each warp, then the four
  // warps in order (no atomics)
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int m = kCpr; m < 32; m <<= 1) {
      sa[q] += __shfl_xor_sync(0xffffffffu, sa[q], m);
      sb[q] += __shfl_xor_sync(0xffffffffu, sb[q], m);
      sr[q] += __shfl_xor_sync(0xffffffffu, sr[q], m);
    }
  if (lane < kCpr)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      red[(0 * 4 + warp) * BN + cc * 8 + q] = sa[q];
      red[(1 * 4 + warp) * BN + cc * 8 + q] = sb[q];
      red[(2 * 4 + warp) * BN + cc * 8 + q] = sr[q];
    }
  sync_consumers();
  const long long prow_out = (long long)blockIdx.z * gridDim.x + blockIdx.x;
  for (int idx = tid; idx < 3 * BN; idx += 128) {
    const int which = idx / BN, c = idx % BN;
    const float* q = red + which * 4 * BN + c;
    const float tot = ((q[0] + q[BN]) + q[2 * BN]) + q[3 * BN];
    if (ci0 + c < sh.Ci)
      part[((long long)which * part_rows + prow_out) * sh.Ci + ci0 + c] = tot;
  }
}

// ---------------------------------------------------------------------------
// K3: dW
// ---------------------------------------------------------------------------
// K3 takes T taps of one kernel row per block: T = 1 in general; T = KW
// (3) for a stride-1 conv with no residual, where one box of x, KW - 1
// pixels wider than the output box (the dy box is widened to match, its
// extra columns no output pixel), serves all KW taps of the row: tap kx's
// operand is that tile kx rows further on. x and dy are then rewritten
// once for KW products instead of once for each.
template <int T>
__host__ __device__ constexpr int dw_x_bytes() {  // rows for the shifts
  return T == 1 ? kTileBytes : kTileBytes + 1024;
}

template <int T>
__host__ __device__ constexpr int dw_stage_bytes() {  // x, r, dy, y
  return 2 * dw_x_bytes<T>() + 2 * kTileBytes;
}

template <int T>
__host__ __device__ constexpr int dw_smem_bytes() {
  return 1024 + kStages * dw_stage_bytes<T>() + 2 * kStages * 8;
}

// One block: the 64 input channels (blockIdx.x % cib)*64 of T taps (tap
// group blockIdx.x / cib) against the 64 output channels blockIdx.y*64,
// over the pixel boxes [blockIdx.z * per_split, +per_split) of the output.
template <int T>
__global__ void __launch_bounds__(kTcThreads, 2)
conv_bwd_dw_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_r,
                      const __grid_constant__ CUtensorMap map_dy,
                      const __grid_constant__ CUtensorMap map_y,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ ds,
                      const float* __restrict__ dss, int has_res_arg,
                      const float* __restrict__ ar,
                      const float* __restrict__ br, float* __restrict__ part,
                      Shape sh, Geo geo, int relu, int per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  constexpr int kX = dw_x_bytes<T>();
  constexpr int kStage = dw_stage_bytes<T>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int s = sh.stride;
  const bool has_res = T == 1 && has_res_arg;  // T > 1: never a residual
  const int cib = (sh.Ci + kRows - 1) / kRows;
  const int group = blockIdx.x / cib;
  const int ci0 = (blockIdx.x - group * cib) * kRows;
  // the first tap of the group; x's box starts at its column
  const int ky = T == 1 ? group / sh.KW : group;
  const int kx = T == 1 ? group - ky * sh.KW : 0;
  const int co0 = blockIdx.y * 64;
  const int total = geo.tw * geo.th * geo.tn;
  const int c_begin = blockIdx.z * per_split;
  const int c_end = min(c_begin + per_split, total);
  const int nsteps = max(0, c_end - c_begin);

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a step's output box: its first pixel (wo0, ho0, n0)
  auto box_of = [&](const BoxWalk& b, int& wo0, int& ho0, int& n0) {
    wo0 = b.wb * geo.bw;
    ho0 = b.hb * geo.bh;
    n0 = b.nb * geo.bn;
  };

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128) {
      const uint32_t box = geo.rows * kDepth * 2;
      const uint32_t bytes = (3 + (has_res ? 1 : 0)) * box;
      BoxWalk walk(geo, c_begin);
      for (int step = 0; step < nsteps; ++step, walk.next(geo)) {
        const int st = step % kStages;
        const uint32_t round = step / kStages;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        int wo0, ho0, n0;
        box_of(walk, wo0, ho0, n0);
        const int wi0 = wo0 * s - sh.pad + kx, hi0 = ho0 * s - sh.pad + ky;
        uint8_t* base = smem + st * kStage;
        mbar_expect_tx(&full[st], bytes);
        tma_load_4d(base, &map_x, &full[st], ci0, wi0, hi0, n0);
        if (has_res)
          tma_load_4d(base + kX, &map_r, &full[st], ci0, wi0, hi0, n0);
        tma_load_4d(base + 2 * kX, &map_dy, &full[st], co0, wo0, ho0, n0);
        tma_load_4d(base + 2 * kX + kTileBytes, &map_y, &full[st], co0, wo0,
                    ho0, n0);
      }
    }
    return;
  }

  // the consumer warpgroup: thread tid rewrites the 16-byte chunk tid % 8
  // of rows tid/8 + 16k, k < 4, in the x and the dy tile; all hold the
  // channels ci0 + 8*lchunk and co0 + 8*lchunk.
  const int prow = tid >> 3, pchunk = tid & 7;
  const int lchunk = pchunk ^ (prow & 7);
  const int ci = ci0 + lchunk * 8, co = co0 + lchunk * 8;
  const bool cic = ci < sh.Ci, coc = co < sh.Co;
  const bool has_pro = a != nullptr;
  const bool pro = has_pro || has_res;
  Pro8 p;
  float dsv[8], dssv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    p.a[q] = (cic && has_pro) ? a[ci + q] : 1.0f;
    p.b[q] = (cic && has_pro) ? b[ci + q] : 0.0f;
    p.ar[q] = (cic && has_res) ? ar[ci + q] : 0.0f;
    p.br[q] = (cic && has_res) ? br[ci + q] : 0.0f;
    dsv[q] = coc ? ds[co + q] : 0.0f;
    dssv[q] = coc ? dss[co + q] : 0.0f;
  }
  int bj[4], bi[4], bnn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) box_pos(geo, prow + 16 * k, bj[k], bi[k], bnn[k]);

  float acc[T][32];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.0f;
    fence_regs(acc[t]);
  }

  const uint4 zero = make_uint4(0, 0, 0, 0);
  // x rows past the box, which TMA never writes, must hold no stale NaN:
  // they are zeroed once, in every stage (with a prologue, the rewrite
  // below zeroes those under 64 again each step). Without a prologue x
  // needs no rewrite at all: TMA's zero fill is the conv padding, and a
  // row that is no pixel of the output meets a zero row of dy_t.
  const int stale = kX / 128 - geo.rows;
  for (int i = tid; i < kStages * stale * 8; i += 128) {
    const int st = i / (stale * 8);
    const int c = i - st * stale * 8;
    *reinterpret_cast<uint4*>(smem + st * kStage + geo.rows * 128 + c * 16) =
        zero;
  }
  fence_proxy_async();
  BoxWalk walk(geo, c_begin);
  for (int step = 0; step < nsteps; ++step, walk.next(geo)) {
    const int st = step % kStages;
    const uint32_t round = step / kStages;
    int wo0, ho0, n0;
    box_of(walk, wo0, ho0, n0);
    mbar_wait(&full[st], round & 1);
    uint8_t* base = smem + st * kStage;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = prow + 16 * k;
      const int off = row * 128 + pchunk * 16;
      const int wo = wo0 + bj[k], ho = ho0 + bi[k], n = n0 + bnn[k];
      const bool rok = row < geo.rows && n < sh.N;
      if (pro) {  // x at this row's own pixel, whatever the output's
        const int hi = ho * s - sh.pad + ky, wi = wo * s - sh.pad + kx;
        uint4 xo = zero;
        if (rok && cic && hi >= 0 && hi < sh.H && wi >= 0 && wi < sh.W)
          xo = prologue8(
              *reinterpret_cast<const uint4*>(base + off),
              has_res ? *reinterpret_cast<const uint4*>(base + kX + off)
                      : zero,
              p, has_res, relu);
        *reinterpret_cast<uint4*>(base + off) = xo;
      }
      uint4 yo = zero;
      if (rok && coc && ho < sh.Ho && wo < sh.Wo)
        yo = fold8(*reinterpret_cast<const uint4*>(base + 2 * kX + off),
                   *reinterpret_cast<const uint4*>(base + 2 * kX +
                                                   kTileBytes + off),
                   dsv, dssv);
      *reinterpret_cast<uint4*>(base + 2 * kX + off) = yo;
    }
    fence_proxy_async();
    sync_consumers();
    wgmma_fence();
    // 16 pixels (rows) per product: 16 * 128 bytes further on. Tap t of
    // the group reads x t rows further on: the swizzle is a function of
    // the shared-memory address, for TMA and wgmma alike, so an operand
    // may start at any row of a 1024-byte atom with the descriptor's base
    // offset left 0 (on an H100, setting it to the row gave wrong sums)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_n64<1, 1>(acc[t], smem_desc(base + t * 128 + kk * 2048, 1024,
                                          1024),
                        smem_desc(base + 2 * kX + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // as in K2: the previous step's stage goes back
#pragma unroll
    for (int t = 0; t < T; ++t) fence_regs(acc[t]);
    if (step > 0) mbar_arrive(&empty[(step - 1) % kStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < T; ++t) fence_regs(acc[t]);

  // the fp32 partial dW of this split
  const int warp = tid >> 5, lane = tid & 31;
  const long long plane = (long long)sh.KH * sh.KW * sh.Ci * sh.Co;
  float* out = part + (long long)blockIdx.z * plane;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int tap = ky * sh.KW + kx + t;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int ci_r = ci0 + warp * 16 + (lane >> 2) + 8 * h2;
      if (ci_r >= sh.Ci) continue;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int co_c = co0 + jb * 8 + 2 * (lane & 3);
        if (co_c < sh.Co)  // Co % 8 == 0: co_c + 1 too
          *reinterpret_cast<float2*>(
              out + ((long long)tap * sh.Ci + ci_r) * sh.Co + co_c) =
              make_float2(acc[t][jb * 4 + h2 * 2],
                          acc[t][jb * 4 + h2 * 2 + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------
template <int BN, int T>
int launch_dx(const void* dy, const void* y, const void* x, const void* w,
              const float* a, const float* b, const float* ds,
              const float* dss, const void* r, const float* ar,
              const float* br, const void* g, void* dx, float* da, float* db,
              void* dr, float* dar, float* part, const Shape& sh, int relu,
              int bw, int bh, int bn, cudaStream_t stream) {
  const int s = sh.stride;
  Geo geo;
  int err = make_geo(bw, bh, bn, (sh.W + s - 1) / s, (sh.H + s - 1) / s, sh.N,
                     &geo);
  if (err) return err;
  CUtensorMap map_dy, map_y, map_w;
  if ((err = encode_act(&map_dy, dy, sh.N, sh.Ho, sh.Wo, sh.Co, geo, 1)) ||
      (err = encode_act(&map_y, y, sh.N, sh.Ho, sh.Wo, sh.Co, geo, 1)))
    return err;
  const uint64_t wdims[2] = {(uint64_t)sh.Co,
                             (uint64_t)sh.KH * sh.KW * sh.Ci};
  const uint32_t wbox[2] = {(uint32_t)kDepth, (uint32_t)BN}, wes[2] = {1, 1};
  if ((err = encode_packed(&map_w, w, 2, wdims, wbox, wes))) return err;
  constexpr int smem = dx_smem_bytes<BN, T>();
  static bool opted = false;
  if ((err = allow_smem((const void*)conv_bwd_dx_tc_kernel<BN, T>, smem,
                        &opted)))
    return err;
  const int tiles = geo.tw * geo.th * geo.tn;
  const long long part_rows = (long long)s * s * tiles;
  conv_bwd_dx_tc_kernel<BN, T>
      <<<dim3(tiles, (sh.Ci + BN - 1) / BN, s * s), kTcThreads, smem,
         stream>>>(map_dy, map_y, map_w, static_cast<const bf16*>(x), a, b,
                   ds, dss, static_cast<const bf16*>(r), ar, br,
                   static_cast<const bf16*>(g), static_cast<bf16*>(dx),
                   static_cast<bf16*>(dr), part, part_rows, sh, geo, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a != nullptr || r != nullptr)  // da, db, dar: one launch
    column_sums(part, 3, (int)part_rows, sh.Ci, da, db, dar, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core input gradient: mxtpu_conv_bwd_dx's contract (see
// conv_bwd.cu) for bf16 with Ci % 8 == 0 and Co % 8 == 0. A block takes
// a box of bw x bh x bn (<= 64) pixels of one stride phase (the phase's
// width ceil(W/s), height ceil(H/s)) and bn_cols (64 or 128) channels of
// Ci. taps: 1, or KW (3) at stride 1 with bn_cols 64, the box then
// bw = W + KW - 1 wide (whole rows and the columns the taps reach past
// them). part: scratch of 3 * stride^2 * (boxes per phase) * Ci floats.
extern "C" int mxtpu_conv_bwd_dx_tc(
    const void* dy, const void* y, const void* x, const void* w,
    const float* a, const float* b, const float* ds, const float* dss,
    const void* r, const float* ar, const float* br, const void* g, void* dx,
    float* da, float* db, void* dr, float* dar, float* part, int N, int H,
    int W, int Ci, int Co, int KH, int KW, int stride, int pad, int Ho, int Wo,
    int relu, int bw, int bh, int bn, int bn_cols, int taps, void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ci % 8 != 0 || Co % 8 != 0) return (int)cudaErrorInvalidValue;
  if (taps == 3 && KW == 3 && stride == 1 && bn_cols == 64 &&
      bw == W + KW - 1)
    return launch_dx<64, 3>(dy, y, x, w, a, b, ds, dss, r, ar, br, g, dx, da,
                            db, dr, dar, part, sh, relu, bw, bh, bn, st);
  if (taps != 1) return (int)cudaErrorInvalidValue;
  if (bn_cols == 64)
    return launch_dx<64, 1>(dy, y, x, w, a, b, ds, dss, r, ar, br, g, dx, da,
                            db, dr, dar, part, sh, relu, bw, bh, bn, st);
  if (bn_cols == 128)
    return launch_dx<128, 1>(dy, y, x, w, a, b, ds, dss, r, ar, br, g, dx,
                             da, db, dr, dar, part, sh, relu, bw, bh, bn, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core weight gradient: mxtpu_conv_bwd_dw's contract for
// bf16 with Ci % 8 == 0 and Co % 8 == 0. The output pixels are cut into
// boxes of bw x bh x bn (<= 64) and the boxes into `splits` ranges of
// whole boxes. taps: 1, or KW for a stride-1 conv without a residual,
// whose boxes are then bw = Wo + KW - 1 wide (one whole row of the output
// and the KW - 1 columns the row's taps reach past it). part: scratch of
// splits * KH*KW*Ci*Co floats.
extern "C" int mxtpu_conv_bwd_dw_tc(
    const void* x, const void* dy, const void* y, const float* a,
    const float* b, const float* ds, const float* dss, const void* r,
    const float* ar, const float* br, void* dw, float* part, int splits,
    int N, int H, int W, int Ci, int Co, int KH, int KW, int stride, int pad,
    int Ho, int Wo, int relu, int bw, int bh, int bn, int taps,
    void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ci % 8 != 0 || Co % 8 != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (taps != 1 && (taps != 3 || KW != 3 || stride != 1 || r != nullptr ||
                    bw != Wo + KW - 1))
    return (int)cudaErrorInvalidValue;
  Geo geo;
  int err = make_geo(bw, bh, bn, Wo, Ho, N, &geo);
  if (err) return err;
  CUtensorMap map_x, map_r, map_dy, map_y;
  if ((err = encode_act(&map_x, x, N, H, W, Ci, geo, stride)) ||
      (err = encode_act(&map_r, r != nullptr ? r : x, N, H, W, Ci, geo,
                        stride)) ||
      (err = encode_act(&map_dy, dy, N, Ho, Wo, Co, geo, 1)) ||
      (err = encode_act(&map_y, y, N, Ho, Wo, Co, geo, 1)))
    return err;
  const int total = geo.tw * geo.th * geo.tn;
  const int per_split = (total + splits - 1) / splits;
  const dim3 grid(KH * (KW / taps) * ((Ci + kRows - 1) / kRows),
                  (Co + 63) / 64, splits);
  const int res = r != nullptr ? 1 : 0;
  if (taps == 1) {
    static bool opted = false;
    if ((err = allow_smem((const void*)conv_bwd_dw_tc_kernel<1>,
                          dw_smem_bytes<1>(), &opted)))
      return err;
    conv_bwd_dw_tc_kernel<1><<<grid, kTcThreads, dw_smem_bytes<1>(), st>>>(
        map_x, map_r, map_dy, map_y, a, b, ds, dss, res, ar, br, part, sh,
        geo, relu, per_split);
  } else {
    static bool opted = false;
    if ((err = allow_smem((const void*)conv_bwd_dw_tc_kernel<3>,
                          dw_smem_bytes<3>(), &opted)))
      return err;
    conv_bwd_dw_tc_kernel<3><<<grid, kTcThreads, dw_smem_bytes<3>(), st>>>(
        map_x, map_r, map_dy, map_y, a, b, ds, dss, res, ar, br, part, sh,
        geo, relu, per_split);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long cols = (long long)KH * KW * Ci * Co;
  const long long blocks = (cols + 255) / 256;
  split_sum_kernel<bf16><<<(int)(blocks < 65535 ? blocks : 65535), 256, 0,
                           st>>>(part, splits, cols, static_cast<bf16*>(dw));
  return (int)cudaGetLastError();
}
