// Flash-attention backward in fp32 on Hopper's FP32 pipes (sm_90a): the dq
// kernel (K5) and the dk/dv kernel (K6) as register micro-tiles fed from
// shared memory. Plain C interface for ctypes.
//
// They compute what csrc/flash_bwd.cu computes (see its header: the TPU
// kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` of the JAX
// package's ops/pallas_attention.py, launched there by `_flash_bwd`), for
// fp32 with D = 64 or 128 and every operand's base and (b, h, t) strides
// multiples of 16 bytes. ops/flash_attention.py's `flash_bwd_route` sends
// those calls here ("f32"). The contract, per (batch, head):
//   p  = exp(scale * q.k - lse)      0 where masked or lse is not finite
//   dS = p * (dO.v - delta) * scale
//   dq = dS . K,  dk = dS^T . Q,  dv = P^T . dO
// every sum in fp32 (no TF32: the reference pins fp32 matmuls to full
// precision). Masks: per-batch key `lengths`, causal aligned bottom-right
// (key <= query + Tk - Tq) or, with `cache_offset`, at the per-batch fill
// (key <= query + lengths[b] - Tq); queries past Tq and keys past Tk are
// masked here. Each block owns its output tile and walks the other
// sequence: no atomics, and a run repeats bit for bit.
//
// Design: 256 threads (8 warps) per 64-row tile, one block an SM. Every
// tile is 64 rows of D fp32 in boxes of 32 floats (128 bytes) under the
// 128-byte swizzle: the 16-byte chunk c of row r of a box lies at r * 128
// + ((c ^ r % 8) << 4). A product C += A . B^T over the depth d (both
// operands row-major) reads, per 4 depths, one float4 of each of a
// thread's 4 A rows and 4 B rows: 8 loads for a 4x4 micro-tile's 64 FMAs.
// A warp's lanes are 4 x 8 over the micro-tiles (A rows 16*wr + lane/8 +
// 4i, B rows 32*wc + lane%8 + 8j), so the 4 (or 8) rows one load reads are
// consecutive and the swizzle puts them in distinct banks: each load is
// one shared-memory wavefront, broadcast across the warp. The second
// products C += A . B (the depth on B's rows) read A the same way and B's
// row at 8 consecutive chunks, again one wavefront. p and dS are formed
// in the score registers, then stored once a tile to shared memory in the
// layout the second product reads.
// * dq: one block per (b*h, 64-query tile), Q and dO loaded once; K and V
//   stream in 64-key tiles up to the causal/length bound. Per tile S =
//   Q.K^T and dP = dO.V^T, dS to shared memory, dQ += dS.K (a thread owns
//   4 rows by D/16 columns of dQ).
// * dkv: one block per (b*h, 64-key tile), K and V loaded once; Q and dO
//   stream in 64-query tiles over the rows that reach the keys, with their
//   lse and delta. The transposed scores S^T = K.Q^T and dP^T = V.dO^T put
//   keys on the rows, P^T and dS^T go to shared memory, then dV += P^T.dO
//   and dK += dS^T.Q.
// The next tile's operands load into a ring of two stages while the
// current one is computed: thread 0 starts TMA boxes of 32 floats x 64
// rows under the same swizzle (4-D maps over (D, T, H, B) with the
// operand's own strides; rows past T are zero-filled), one mbarrier a
// stage, and dkv's lse and delta come by 4-byte cp.async. (A loader of
// cp.async 16-byte copies from every thread measured slower than TMA on an
// H100: the copies cost every thread registers and instruction slots;
// PERF.md.) The barriers are two a tile: after p and dS are stored,
// and after the second products, where the next stage's wait joins. The
// tile walks, the mask and the causal grids' order (heaviest
// blocks first) are the tensor-core kernels' (flash_tc.cuh, mirrored on
// the CPU by tests/test_torch_flash_bwd_route.py). The softmax takes one
// uniform branch a tile between the masked and the unmasked form and one
// ex2.approx.ftz an element with lse pre-scaled by log2(e); a non-finite
// lse reads as +inf, so a dead row gives p = 0 with no test per element.
//
// What bounds them: at the GPT training shape (B=8, H=12, T=256, D=64,
// causal) the work is 6*D (dq) and 8*D (dk, dv) FLOPs per attended pair,
// 1.2 and 1.6 GFLOP, against about 32 and 38 MB of fp32 in and out: both
// are bound by operations at the card's FP32 rate, not by bytes.
// The micro-tiles make one 16-byte shared load per 8 FMAs (the SIMT
// kernels of flash_bwd.cu made one 4-byte load per FMA, which capped them
// near a quarter of the FMA rate), and each such load costs what a
// broadcast does (tools/torch_lds_wavefronts.py), so shared memory is not
// the limit. On an H100 the two product phases run at about 60% of the
// FMA rate with two warps a scheduler to hide the loads' latency (one
// block an SM: 168-226 registers a thread), and a block spends about 12%
// of its cycles on set-up, the first loads and the epilogue
// (tools/torch_flash_f32_times.py --phases; PERF.md); the causal grid's
// short walks (1 to 4 tiles a block at T=256) leave the last wave part
// empty.
//
// Inputs may be strided: q, k, v, dO and every output have their own
// batch, head and sequence strides (elements); the head dim is contiguous.

#include <type_traits>

#include "f32_tile.cuh"
#include "flash_tc.cuh"

namespace {

using namespace mxflash;
using namespace mxf32;

constexpr int kThreads = 256;
constexpr int kStages = 2;                 // ring of shared-memory stages
// depth chunks unrolled in the product loops: a multiple of 8 keeps every
// swizzle offset an immediate; 16 measured faster than 8 on an H100, and
// 32 overflows the instruction cache at D = 128 (twice as slow)
constexpr int kUnroll = 16;

// the TMA maps of q, k, v and dO
struct Maps {
  CUtensorMap q, k, v, g;
};

// bytes of a 64-row fp32 tile of D columns
template <int D>
constexpr int kTileBytes = kTile * D * 4;

// ---------------------------------------------------------------------------
// loads: 4-byte row statistics by cp.async (src_size 0 zero-fills the
// destination without reading); the tiles by TMA (f32_tile.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the micro-tile products
// ---------------------------------------------------------------------------
// s[i][j] += A1[ra + 4i] . B1[rb + 8j] and dp[i][j] += A2[ra + 4i] .
// B2[rb + 8j] over the D columns
template <int D>
__device__ __forceinline__ void scores(const uint8_t* a1, const uint8_t* b1,
                                       const uint8_t* a2, const uint8_t* b2,
                                       const RowOffs& ra, const RowOffs& rb,
                                       float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll kUnroll
  for (int c = 0; c < D / 4; ++c) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(a1, ra.step4(i, c));
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(b1, rb.step8(j, c));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(a2, ra.step4(i, c));
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(b2, rb.step8(j, c));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
  }
}

// acc1[i][4u + x] += sum_t A1[ra + 4i][t] * B1[t][chunk u of the
// thread][x] over the tile's 64 rows t (and acc2 from A2, B2 when kTwo).
// The thread's column chunks are chunk lane % 8 of box box0 / kBoxBytes +
// u: row t of B holds it at t * 128 + xl[t % 8] in each box, xl[k] = (lx ^
// k) << 4.
template <int D, bool kTwo>
__device__ __forceinline__ void products(const uint8_t* a1, const uint8_t* b1,
                                         const uint8_t* a2, const uint8_t* b2,
                                         const RowOffs& ra,
                                         const uint32_t (&xl)[8],
                                         float (&acc1)[4][D / 16],
                                         float (&acc2)[4][D / 16]) {
  constexpr int NU = D / 64;  // 4-float chunks of a thread's output row
#pragma unroll kUnroll
  for (int c = 0; c < kTile / 4; ++c) {
    float4 x1[4], x2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x1[i] = ld4(a1, ra.step4(i, c));
      if constexpr (kTwo) x2[i] = ld4(a2, ra.step4(i, c));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 4 * c + e;  // the depth row of B
      const uint32_t row = t * 128 + xl[t & 7];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 y1 = ld4(b1, row + u * kBoxBytes);
        float4 y2;
        if constexpr (kTwo) y2 = ld4(b2, row + u * kBoxBytes);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w1 = lane_of(x1[i], e);
          acc1[i][4 * u + 0] = fmaf(w1, y1.x, acc1[i][4 * u + 0]);
          acc1[i][4 * u + 1] = fmaf(w1, y1.y, acc1[i][4 * u + 1]);
          acc1[i][4 * u + 2] = fmaf(w1, y1.z, acc1[i][4 * u + 2]);
          acc1[i][4 * u + 3] = fmaf(w1, y1.w, acc1[i][4 * u + 3]);
          if constexpr (kTwo) {
            const float w2 = lane_of(x2[i], e);
            acc2[i][4 * u + 0] = fmaf(w2, y2.x, acc2[i][4 * u + 0]);
            acc2[i][4 * u + 1] = fmaf(w2, y2.y, acc2[i][4 * u + 1]);
            acc2[i][4 * u + 2] = fmaf(w2, y2.z, acc2[i][4 * u + 2]);
            acc2[i][4 * u + 3] = fmaf(w2, y2.w, acc2[i][4 * u + 3]);
          }
        }
      }
    }
  }
}

// the thread's rows of an accumulator (4 rows, D/16 columns in D/64
// chunks of 4: chunk u at column 4 * (cb + 8u)) to a strided output
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[4][D / 16],
                                           float* out, long long st, int r0,
                                           int rows, int cb) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
      *reinterpret_cast<float4*>(out + r * st + 4 * (cb + 8 * u)) =
          make_float4(acc[i][4 * u], acc[i][4 * u + 1], acc[i][4 * u + 2],
                      acc[i][4 * u + 3]);
  }
}

// ---------------------------------------------------------------------------
// K5: dq
// ---------------------------------------------------------------------------
template <int D>
constexpr int dq_smem_bytes() {  // Q, dO, the K/V ring, dS
  return kAlign + (2 + 2 * kStages) * kTileBytes<D> + kTileBytes<64>;
}

// One block: queries [q0, q0 + 64) of (batch, head) blockIdx.x, q0 from
// blockIdx.y counted from the last tile (the causal grid's heaviest
// blocks first).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ lengths,
                        float* __restrict__ dq, int H, int Tq, int Tk,
                        Strides sdq, float scale, int causal,
                        int cache_offset,
                        const __grid_constant__ Maps maps) {
  constexpr int TB = kTileBytes<D>, S = kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[S];           // the stages' TMA barriers
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* qs = smem;                    // Q of the block's queries
  uint8_t* gs = qs + TB;                 // dO
  uint8_t* ring = gs + TB;               // [S][K, V]
  uint8_t* dss = ring + S * 2 * TB;      // dS, 64 queries x 64 keys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1, ly = lane >> 3, lx = lane & 7;
  const int ra = 16 * wr + ly;  // the thread's queries ra + 4i
  const int rb = 32 * wc + lx;  // its keys rb + 8j of a tile
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  const int ntiles = key_tiles(m, q0);

  uint32_t ka[4], xl[8];  // the keys of rows ra + 4i; see products
#pragma unroll
  for (int i = 0; i < 4; ++i) ka[i] = row_key(ra + 4 * i);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    xl[k] = ((lx ^ k) << 4) + (D / 64) * wc * kBoxBytes;
  const RowOffs oa(ra), ob(rb);
  float l2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 4 * i;
    const long long at = (long long)bh * Tq + row;
    l2[i] = row < Tq ? lse_log2(lse[at]) : INFINITY;
    dl[i] = row < Tq ? delta[at] : 0.f;
  }
  const float sl2 = scale * kLog2e;

  float acc[4][D / 16], unused[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  // key tile t's K and V into stage t % S (the first also brings Q and
  // dO: a compile-time flag, so the loop keeps no registers for them)
  auto fetch = [&](int t, auto first) {
    uint8_t* kt = ring + (t % S) * 2 * TB;
    if (tid == 0) {
      uint64_t* bar = &bars[t % S];
      fence_proxy_async();  // the stage's last reads come first
      mbar_expect_tx(bar, (decltype(first)::value ? 4 : 2) * TB);
      if constexpr (decltype(first)::value) {
        tma_tile<D>(qs, &maps.q, bar, q0, h, b);
        tma_tile<D>(gs, &maps.g, bar, q0, h, b);
      }
      tma_tile<D>(kt, &maps.k, bar, t * kTile, h, b);
      tma_tile<D>(kt + TB, &maps.v, bar, t * kTile, h, b);
    }
  };
  // tile t has landed, for every thread
  auto wait = [&](int t) {
    mbar_wait(&bars[t % S], (t / S) & 1);
    __syncthreads();
  };

  init_bars<S>(bars);
  if (ntiles > 0) {
    fetch(0, std::true_type{});
    wait(0);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kTile;
    if (it + 1 < ntiles)  // while this one runs
      fetch(it + 1, std::false_type{});
    const uint8_t* kt = ring + (it % S) * 2 * TB;
    const uint8_t* vt = kt + TB;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    scores<D>(qs, kt, gs, vt, oa, ob, s, dp);

    // dS in the score registers; a tile inside the valid pairs skips the
    // mask (one branch per tile, uniform over the block)
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2_fast(fmaf(s[i][j], sl2, -l2[i]));
          if constexpr (decltype(masked)::value)
            p = m.ok(q0 + ra + 4 * i, j0 + rb + 8 * j) ? p : 0.f;
          st1(dss, ka[i], rb + 8 * j, p * (dp[i][j] - dl[i]) * scale);
        }
    };
    if (m.full(q0, j0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    __syncthreads();  // dS complete

    products<D, false>(dss, kt, nullptr, nullptr, oa, xl, acc, unused);
    if (it + 1 < ntiles) wait(it + 1);  // and dS and the stage consumed
  }

  store_rows<D>(acc, dq + b * sdq.b + h * sdq.h + (long long)q0 * sdq.t,
                sdq.t, ra, Tq - q0, (D / 8) * wc + lx);
}

// ---------------------------------------------------------------------------
// K6: dk, dv
// ---------------------------------------------------------------------------
template <int D>
constexpr int dkv_smem_bytes() {  // K, V, the Q/dO ring, P^T, dS^T, stats
  return kAlign + (2 + 2 * kStages) * kTileBytes<D> + 2 * kTileBytes<64> +
         kStages * 2 * kTile * 4;
}

// One block: keys [j0, j0 + 64) of (batch, head) blockIdx.x, j0 from
// blockIdx.y (the causal grid's heaviest blocks first).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ lengths,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Tq, int Tk, Strides sdk, Strides sdv,
                         float scale, int causal, int cache_offset,
                         const __grid_constant__ Maps maps) {
  constexpr int TB = kTileBytes<D>, S = kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[S];           // the stages' TMA barriers
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ks = smem;                    // K of the block's keys
  uint8_t* vs = ks + TB;                 // V
  uint8_t* ring = vs + TB;               // [S][Q, dO]
  uint8_t* pts = ring + S * 2 * TB;      // P^T, 64 keys x 64 queries
  uint8_t* dts = pts + kTileBytes<64>;   // dS^T
  float* stats = reinterpret_cast<float*>(dts + kTileBytes<64>);
  // stats: [S][lse 64, delta 64] of the stage's queries, as read

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1, ly = lane >> 3, lx = lane & 7;
  const int ra = 16 * wr + ly;  // the thread's keys ra + 4i
  const int rb = 32 * wc + lx;  // its queries rb + 8j of a tile
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j0 = blockIdx.y * kTile;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  int i_begin;
  const int ntiles = dkv_tiles(m, j0, &i_begin);

  uint32_t ka[4], xl[8];  // the keys of rows ra + 4i; see products
#pragma unroll
  for (int i = 0; i < 4; ++i) ka[i] = row_key(ra + 4 * i);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    xl[k] = ((lx ^ k) << 4) + (D / 64) * wc * kBoxBytes;
  const RowOffs oa(ra), ob(rb);
  const float sl2 = scale * kLog2e;

  // query tile t's Q and dO into stage t % S with their lse and delta
  // (the first brings K and V too, a compile-time flag)
  auto fetch = [&](int t, auto first) {
    const int i0 = i_begin + t * kTile;
    uint8_t* qt = ring + (t % S) * 2 * TB;
    if (tid == 0) {
      uint64_t* bar = &bars[t % S];
      fence_proxy_async();  // the stage's last reads come first
      mbar_expect_tx(bar, (decltype(first)::value ? 4 : 2) * TB);
      if constexpr (decltype(first)::value) {
        tma_tile<D>(ks, &maps.k, bar, j0, h, b);
        tma_tile<D>(vs, &maps.v, bar, j0, h, b);
      }
      tma_tile<D>(qt, &maps.q, bar, i0, h, b);
      tma_tile<D>(qt + TB, &maps.g, bar, i0, h, b);
    }
    if (tid < 2 * kTile) {
      const int row = i0 + (tid & (kTile - 1));
      const float* src = (tid < kTile ? lse : delta) + (long long)bh * Tq;
      cp_async4(stats + (t % S) * 2 * kTile + tid,
                row < Tq ? src + row : src, row < Tq);
    }
    cp_async_commit();
  };
  // tile t has landed, for every thread
  auto wait = [&](int t) {
    cp_async_wait<0>();
    mbar_wait(&bars[t % S], (t / S) & 1);
    __syncthreads();
  };

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dka[i][j] = dva[i][j] = 0.f;

  init_bars<S>(bars);
  if (ntiles > 0) {
    fetch(0, std::true_type{});
    wait(0);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = i_begin + it * kTile;
    if (it + 1 < ntiles)  // while this one runs
      fetch(it + 1, std::false_type{});
    const uint8_t* qt = ring + (it % S) * 2 * TB;
    const uint8_t* gt = qt + TB;
    const float* st = stats + (it % S) * 2 * kTile;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    scores<D>(ks, qt, vs, gt, oa, ob, s, dp);

    // rows are keys, columns queries: P^T and dS^T; rows past Tq read a
    // zero lse but lie outside any full tile, so the mask clears them
    float l2[4], dl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l2[j] = lse_log2(st[rb + 8 * j]);
      dl[j] = st[kTile + rb + 8 * j];
    }
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2_fast(fmaf(s[i][j], sl2, -l2[j]));
          if constexpr (decltype(masked)::value)
            p = m.ok(i0 + rb + 8 * j, j0 + ra + 4 * i) ? p : 0.f;
          st1(pts, ka[i], rb + 8 * j, p);
          st1(dts, ka[i], rb + 8 * j, p * (dp[i][j] - dl[j]) * scale);
        }
    };
    if (m.full(i0, j0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    __syncthreads();  // P^T and dS^T complete

    products<D, true>(pts, gt, dts, qt, oa, xl, dva, dka);
    if (it + 1 < ntiles) wait(it + 1);  // and P^T, dS^T, the stage consumed
  }

  const long long rows = Tk - j0;
  const int cb = (D / 8) * wc + lx;
  store_rows<D>(dka, dk + b * sdk.b + h * sdk.h + (long long)j0 * sdk.t,
                sdk.t, ra, (int)rows, cb);
  store_rows<D>(dva, dv + b * sdv.b + h * sdv.h + (long long)j0 * sdv.t,
                sdv.t, ra, (int)rows, cb);
}

// ---------------------------------------------------------------------------
// host: launches
// ---------------------------------------------------------------------------
struct Args {
  const float *q, *k, *v, *g, *lse, *delta;
  const int* lengths;
  float *o1, *o2;
  int B, H, Tq, Tk;
  Strides s[6];  // q, k, v, g, o1, o2
  float scale;
  int causal, cache_offset;
};

// the maps of q, k, v and dO
int make_maps(const Args& a, int D, Maps* m) {
  int err;
  if ((err = encode_f32(&m->q, a.q, a.B, a.H, a.Tq, D, a.s[0])) ||
      (err = encode_f32(&m->k, a.k, a.B, a.H, a.Tk, D, a.s[1])) ||
      (err = encode_f32(&m->v, a.v, a.B, a.H, a.Tk, D, a.s[2])) ||
      (err = encode_f32(&m->g, a.g, a.B, a.H, a.Tq, D, a.s[3])))
    return err;
  return 0;
}

template <int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  static bool opted = false;
  int err = allow_smem((const void*)flash_bwd_dq_f32_kernel<D>, smem, &opted);
  if (err) return err;
  Maps maps{};
  if ((err = make_maps(a, D, &maps))) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kTile - 1) / kTile);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      a.lse, a.delta, a.lengths, a.o1, a.H, a.Tq, a.Tk, a.s[4], a.scale,
      a.causal, a.cache_offset, maps);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  static bool opted = false;
  int err =
      allow_smem((const void*)flash_bwd_dkv_f32_kernel<D>, smem, &opted);
  if (err) return err;
  Maps maps{};
  if ((err = make_maps(a, D, &maps))) return err;
  const dim3 grid(a.B * a.H, (a.Tk + kTile - 1) / kTile);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      a.lse, a.delta, a.lengths, a.o1, a.o2, a.H, a.Tq, a.Tk, a.s[4],
      a.s[5], a.scale, a.causal, a.cache_offset, maps);
  return (int)cudaGetLastError();
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* g, const float* lse, const float* delta,
        const int* lengths, void* o1, void* o2, int B, int H, int Tq, int Tk,
        int D, const long long* st, float scale, int causal,
        int cache_offset, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(g),
         lse, delta, lengths, static_cast<float*>(o1),
         static_cast<float*>(o2), B, H, Tq, Tk, {}, scale, causal,
         cache_offset};
  for (int i = 0; i < 6; ++i)
    a.s[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  const void* ptrs[6] = {q, k, v, g, o1, o2};
  const int ts[6] = {Tq, Tk, Tk, Tq, dkv ? Tk : Tq, Tk};
  for (int i = 0; i < (dkv ? 6 : 5); ++i)
    if (!aligned(ptrs[i], a.s[i], B, H, ts[i]))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return dkv ? launch_dkv<64>(a, s) : launch_dq<64>(a, s);
  if (D == 128) return dkv ? launch_dkv<128>(a, s) : launch_dq<128>(a, s);
  return -1;
}

}  // namespace

extern "C" {

// The fp32 backward: mxtpu_flash_bwd_dq's and mxtpu_flash_bwd_dkv's
// contract (flash_bwd.cu) for fp32 with D = 64 or 128, every operand's
// base and (b, h, t) strides multiples of 16 bytes (dims of size 1
// aside). strides: 18 values, (b, h, t) of q, k, v, g and the two outputs,
// in elements (dq uses the first output only). Returns the cudaError_t of
// the launch (0 on success), cudaErrorInvalidValue for a misaligned
// operand, or -1 for another D.
int mxtpu_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                           const void* g, const float* lse,
                           const float* delta, const int* lengths, void* dq,
                           int B, int H, int Tq, int Tk, int D,
                           const long long* strides, float scale, int causal,
                           int cache_offset, void* stream) {
  return run(false, q, k, v, g, lse, delta, lengths, dq, nullptr, B, H, Tq,
             Tk, D, strides, scale, causal, cache_offset, stream);
}

int mxtpu_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                            const void* g, const float* lse,
                            const float* delta, const int* lengths,
                            void* dk, void* dv, int B, int H, int Tq, int Tk,
                            int D, const long long* strides, float scale,
                            int causal, int cache_offset, void* stream) {
  return run(true, q, k, v, g, lse, delta, lengths, dk, dv, B, H, Tq, Tk, D,
             strides, scale, causal, cache_offset, stream);
}

}  // extern "C"
