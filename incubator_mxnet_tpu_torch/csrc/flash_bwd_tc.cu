// Flash-attention backward in bf16 or fp16 on Hopper's tensor cores
// (sm_90a): the dq kernel (K5) and the dk/dv kernel (K6) as wgmma products of
// shared-memory tiles that TMA fills, with the scores kept in registers.
// Plain C interface for ctypes.
//
// They compute what csrc/flash_bwd.cu computes (see its header: the TPU
// kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` of the JAX
// package's ops/pallas_attention.py), for bf16 or fp16 (one template over
// the element type T: the wgmma operand type, the TMA element type and the
// conversions differ) with D = 64 or 128 and every operand's base and
// (b, h, t) strides multiples of 16 bytes, as TMA needs.
// ops/flash_attention.py's `flash_bwd_route` sends every other call
// to flash_bwd.cu. The contract, per (batch, head):
//   p  = exp(scale * q.k - lse)      0 where masked or lse is not finite
//   dS = p * (dO.v - delta) * scale
//   dq = dS . K,  dk = dS^T . Q,  dv = P^T . dO
// p and dS are rounded to the input type before their products (the TPU
// kernels cast them to it); every sum runs in fp32 and each output is
// rounded to the input type once. Masks: per-batch key `lengths`, causal
// aligned bottom-right (key <= query + Tk - Tq) or, with `cache_offset`, at the
// per-batch fill (key <= query + lengths[b] - Tq); queries past Tq and
// keys past Tk are masked here. Each block owns its output tile and walks
// the other sequence: no atomics, and a run repeats bit for bit.
//
// Design: one consumer warpgroup (128 threads) per 64 rows and one
// producer warp, whose thread 0 issues every TMA load into a ring of two
// stages. Every tile is 64 rows of 64 bf16 under the 128-byte swizzle, so
// a (64 x D) tile of q, k, v or dO is D/64 boxes of one 4-D tensor map over
// (D, T, H, B) with the operand's own strides (the head-split views of a
// fused QKV projection go in as they are; TMA's zero fill covers rows past
// T).
// * dq: one block per (b*h, 64-query tile). Q and dO are loaded once; K
//   and V stream in 64-key tiles up to the causal/length bound `kend`.
//   Per tile S = Q.K^T and dP = dO.V^T (both operands K-major in shared
//   memory), p and dS formed in the accumulator registers, then dQ += dS.K
//   with dS as the register A operand (bf16/fp16) and K read MN-major.
// * dkv: one block per (b*h, 64-key tile). K and V are loaded once; Q and
//   dO stream in 64-query tiles over the rows that reach the keys, with
//   their 64 lse and delta (written by the producer warp's 32 lanes, which
//   all arrive on the stage's barrier). The transposed scores S^T = K.Q^T
//   and dP^T = V.dO^T put keys on the rows, so P^T and dS^T land in
//   registers as A operands of dV += P^T.dO and dK += dS^T.Q (dO and Q
//   MN-major).
// The m64 accumulator's element d[4j + 2h + c] is row 16*warp + lane/4 +
// 8h, column 8j + 2*(lane%4) + c: every mask is evaluated there, and a
// tile wholly inside the valid pairs skips it. A register A fragment of
// k-step s is the bf16/fp16 pairs (d[8s + 2i], d[8s + 2i + 1]), i < 4
// (hopper.cuh, pack_a). Causal grids put the heaviest blocks first: the
// last query tiles of dq, the first key tiles of dk/dv. The epilogue
// stages the tile in shared memory (swizzled) and writes 16-byte chunks.
// tests/test_torch_flash_bwd_route.py mirrors the tile plan on the CPU.
//
// What bounds them: at the GPT training shape (B=8, H=12, T=256, D=64,
// causal) the bytes (about 16-19 MB of bf16 in and out) bound both by
// their counts, far above the operations at the tensor cores' rate. On an
// H100 neither binds: a block walks 2.5 tiles on average there, so the
// ring never fills; its fixed costs (set-up, the first loads, the
// epilogue) take about 40% of its cycles and the register softmax about a
// quarter, each tile's products waiting on the last
// (tools/torch_flash_tc_phases.py; PERF.md). The softmax takes one uniform
// branch a tile between the masked and the unmasked form and one MUFU op
// an element (ex2.approx.ftz), which halved it.

#include <type_traits>

#include "flash_tc.cuh"

namespace {

using namespace mxflash;

constexpr int kThreads = 160;                // consumer warpgroup + producer
constexpr int kStages = 2;                   // ring of shared-memory stages

// ---------------------------------------------------------------------------
// K5: dq
// ---------------------------------------------------------------------------
template <int D>
constexpr int dq_smem_bytes() {  // Q, dO, the K/V ring, barriers
  return 1024 + (2 + 2 * kStages) * (D / 64) * kBox + (1 + 2 * kStages) * 8;
}

// One block: queries [q0, q0 + 64) of (batch, head) blockIdx.x, q0 from
// blockIdx.y counted from the last tile. Threads 0-127 are the consumer
// warpgroup, thread 128 the producer.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ lengths, T* __restrict__ dq,
                       int H, int Tq, int Tk, long long sb, long long sh,
                       long long st, float scale, int causal,
                       int cache_offset) {
  constexpr int NB = D / 64;  // 64-column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                    // [NB] boxes
  uint8_t* gs = qs + NB * kBox;          // [NB]
  uint8_t* ring = gs + NB * kBox;        // [kStages][K: NB, V: NB]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * 2 * NB * kBox);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  const int ntiles = key_tiles(m, q0);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128 && ntiles > 0) {
      mbar_expect_tx(qbar, 2 * NB * kBox);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(qs + c * kBox, &map_q, qbar, 64 * c, q0, h, b);
        tma_load_4d(gs + c * kBox, &map_g, qbar, 64 * c, q0, h, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* kt = ring + s * 2 * NB * kBox;
        mbar_expect_tx(&full[s], 2 * NB * kBox);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(kt + c * kBox, &map_k, &full[s], 64 * c, it * kTile, h,
                      b);
          tma_load_4d(kt + (NB + c) * kBox, &map_v, &full[s], 64 * c,
                      it * kTile, h, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: rows r0 and r0 + 8 of the tile
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    const long long at = (long long)bh * Tq + row;
    l2[hh] = row < Tq ? lse_log2(lse[at]) : INFINITY;
    dl[hh] = row < Tq ? delta[at] : 0.f;
  }
  const float sl2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int j0 = it * kTile;
    const uint8_t* kt = ring + s * 2 * NB * kBox;
    const uint8_t* vt = kt + NB * kBox;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    mbar_wait(&full[s], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      wgmma_n64<0, 0, T>(sc, kmajor(qs, kk), kmajor(kt, kk));
      wgmma_n64<0, 0, T>(dp, kmajor(gs, kk), kmajor(vt, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // p and dS in registers; a tile inside the valid pairs skips the
    // mask (one branch per tile, uniform over the block)
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float p = exp2_fast(fmaf(sc[i], sl2, -l2[hh]));
        if constexpr (decltype(masked)::value) {
          const int col = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          p = m.ok(r0 + 8 * hh, col) ? p : 0.f;
        }
        dp[i] = p * (dp[i] - dl[hh]) * scale;
      }
    };
    if (m.full(q0, j0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    uint32_t a[4][4];
    pack_a<0, T>(dp, a[0]);
    pack_a<1, T>(dp, a[1]);
    pack_a<2, T>(dp, a[2]);
    pack_a<3, T>(dp, a[3]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1, T>(acc, a[kk], mnmajor(kt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  const int rows = min(kTile, Tq - q0);
  store_tile<D>(acc, qs, dq + b * sb + h * sh + q0 * st, st, rows);
}

// ---------------------------------------------------------------------------
// K6: dk, dv
// ---------------------------------------------------------------------------
template <int D>
constexpr int dkv_smem_bytes() {  // K, V, the Q/dO ring, lse/delta, bars
  return 1024 + (2 + 2 * kStages) * (D / 64) * kBox + kStages * 2 * kTile * 4 +
         (1 + 2 * kStages) * 8;
}

// One block: keys [j0, j0 + 64) of (batch, head) blockIdx.x, j0 from
// blockIdx.y. Threads 0-127 are the consumer warpgroup, 128-159 the
// producer warp (thread 128 issues the loads, all 32 write lse and delta).
// One block an SM: at two (at most 200 registers) the D=64 instance spills
// 32-36 bytes; it takes about 207, so two blocks rarely share an SM.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ lengths,
                        T* __restrict__ dk, T* __restrict__ dv, int H,
                        int Tq, int Tk, long long sb, long long sh,
                        long long st, float scale, int causal,
                        int cache_offset) {
  constexpr int NB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ks = smem;                    // [NB] boxes
  uint8_t* vs = ks + NB * kBox;          // [NB]
  uint8_t* ring = vs + NB * kBox;        // [kStages][Q: NB, dO: NB]
  float* lsd = reinterpret_cast<float*>(ring + kStages * 2 * NB * kBox);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(lsd + kStages * 2 * kTile);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int j0 = blockIdx.y * kTile;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  int i_begin;
  const int ntiles = dkv_tiles(m, j0, &i_begin);

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the loads' thread + 32 lse writers
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    const int lane = tid - 128;
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(kvbar, 2 * NB * kBox);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(ks + c * kBox, &map_k, kvbar, 64 * c, j0, h, b);
        tma_load_4d(vs + c * kBox, &map_v, kvbar, 64 * c, j0, h, b);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      const int i0 = i_begin + it * kTile;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        uint8_t* qt = ring + s * 2 * NB * kBox;
        mbar_expect_tx(&full[s], 2 * NB * kBox);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(qt + c * kBox, &map_q, &full[s], 64 * c, i0, h, b);
          tma_load_4d(qt + (NB + c) * kBox, &map_g, &full[s], 64 * c, i0, h,
                      b);
        }
      }
      // lse (as lse_log2; +inf past Tq) and delta of the tile's queries
      float* ls = lsd + s * 2 * kTile;
#pragma unroll
      for (int r = lane; r < kTile; r += 32) {
        const int row = i0 + r;
        const long long at = (long long)bh * Tq + row;
        ls[r] = row < Tq ? lse_log2(lse[at]) : INFINITY;
        ls[kTile + r] = row < Tq ? delta[at] : 0.f;
      }
      mbar_arrive(&full[s]);  // releases this lane's writes
    }
    return;
  }

  // the consumer warpgroup: keys kr and kr + 8 of the tile
  const int warp = tid >> 5, lane = tid & 31;
  const int kr = j0 + 16 * warp + (lane >> 2);
  const float sl2 = scale * kLog2e;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  fence_regs(dka);
  fence_regs(dva);

  if (ntiles > 0) mbar_wait(kvbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const int i0 = i_begin + it * kTile;
    const uint8_t* qt = ring + s * 2 * NB * kBox;
    const uint8_t* gt = qt + NB * kBox;
    const float* ls = lsd + s * 2 * kTile;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    mbar_wait(&full[s], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      wgmma_n64<0, 0, T>(sc, kmajor(ks, kk), kmajor(qt, kk));
      wgmma_n64<0, 0, T>(dp, kmajor(vs, kk), kmajor(gt, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // rows are keys, columns queries: P^T and dS^T in place; a tile
    // inside the valid pairs skips the mask (as in dq)
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hh = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + 2 * (lane & 3);  // even: one float2
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 dl = *reinterpret_cast<const float2*>(ls + kTile + c);
        float p0 = exp2_fast(fmaf(sc[i], sl2, -l2.x));
        float p1 = exp2_fast(fmaf(sc[i + 1], sl2, -l2.y));
        if constexpr (decltype(masked)::value) {
          p0 = m.ok(i0 + c, kr + 8 * hh) ? p0 : 0.f;
          p1 = m.ok(i0 + c + 1, kr + 8 * hh) ? p1 : 0.f;
        }
        sc[i] = p0;
        sc[i + 1] = p1;
        dp[i] = p0 * (dp[i] - dl.x) * scale;
        dp[i + 1] = p1 * (dp[i + 1] - dl.y) * scale;
      }
    };
    if (m.full(i0, j0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    uint32_t pa[4][4], da[4][4];
    pack_a<0, T>(sc, pa[0]);
    pack_a<1, T>(sc, pa[1]);
    pack_a<2, T>(sc, pa[2]);
    pack_a<3, T>(sc, pa[3]);
    pack_a<0, T>(dp, da[0]);
    pack_a<1, T>(dp, da[1]);
    pack_a<2, T>(dp, da[2]);
    pack_a<3, T>(dp, da[3]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<D, 1, T>(dva, pa[kk], mnmajor(gt, kk));
      wgmma_rs<D, 1, T>(dka, da[kk], mnmajor(qt, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    mbar_arrive(&empty[s]);
  }

  const int rows = min(kTile, Tk - j0);
  const long long off = b * sb + h * sh + j0 * st;
  store_tile<D>(dka, ks, dk + off, st, rows);
  store_tile<D>(dva, vs, dv + off, st, rows);
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int* lengths;
  void *o1, *o2;
  int B, H, Tq, Tk;
  const long long* strides;  // (b, h, t) of q, k, v, g, o1, o2
  float scale;
  int causal, cache_offset;
};

int maps(const Args& a, int D, CUtensorMapDataType dt, CUtensorMap* mq,
         CUtensorMap* mk, CUtensorMap* mv, CUtensorMap* mg) {
  const long long* s = a.strides;
  int err;
  if ((err = encode_bhtd(mq, a.q, a.B, a.H, a.Tq, D, s, dt)) ||
      (err = encode_bhtd(mk, a.k, a.B, a.H, a.Tk, D, s + 3, dt)) ||
      (err = encode_bhtd(mv, a.v, a.B, a.H, a.Tk, D, s + 6, dt)) ||
      (err = encode_bhtd(mg, a.g, a.B, a.H, a.Tq, D, s + 9, dt)))
    return err;
  return 0;
}

template <int D, typename T>
int launch_dq(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  int err = maps(a, D, tma_dtype<T>(), &mq, &mk, &mv, &mg);
  if (err) return err;
  constexpr int smem = dq_smem_bytes<D>();
  static bool opted = false;
  if ((err = allow_smem((const void*)flash_bwd_dq_tc_kernel<D, T>, smem,
                        &opted)))
    return err;
  const long long* so = a.strides + 12;
  const dim3 grid(a.B * a.H, (a.Tq + kTile - 1) / kTile);
  flash_bwd_dq_tc_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mg, a.lse, a.delta, a.lengths, static_cast<T*>(a.o1),
      a.H, a.Tq, a.Tk, so[0], so[1], so[2], a.scale, a.causal,
      a.cache_offset);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  int err = maps(a, D, tma_dtype<T>(), &mq, &mk, &mv, &mg);
  if (err) return err;
  const long long *s1 = a.strides + 12, *s2 = a.strides + 15;
  // dk and dv share one set of strides (both the wrapper's fresh buffers)
  if (s1[0] != s2[0] || s1[1] != s2[1] || s1[2] != s2[2])
    return (int)cudaErrorInvalidValue;
  constexpr int smem = dkv_smem_bytes<D>();
  static bool opted = false;
  if ((err = allow_smem((const void*)flash_bwd_dkv_tc_kernel<D, T>, smem,
                        &opted)))
    return err;
  const dim3 grid(a.B * a.H, (a.Tk + kTile - 1) / kTile);
  flash_bwd_dkv_tc_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mg, a.lse, a.delta, a.lengths, static_cast<T*>(a.o1),
      static_cast<T*>(a.o2), a.H, a.Tq, a.Tk, s1[0], s1[1], s1[2],
      a.scale, a.causal, a.cache_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int run_t(bool dkv, const Args& a, int D, cudaStream_t st) {
  if (D == 64) return dkv ? launch_dkv<64, T>(a, st) : launch_dq<64, T>(a, st);
  if (D == 128)
    return dkv ? launch_dkv<128, T>(a, st) : launch_dq<128, T>(a, st);
  return -1;
}

int run(bool dkv, const Args& a, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the outputs are written in 16-byte chunks
  for (int i = 12; i < (dkv ? 18 : 15); ++i)
    if (a.strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a.o1) % 16 != 0 ||
      (dkv && reinterpret_cast<uintptr_t>(a.o2) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return run_t<bf16>(dkv, a, D, st);
  if (dtype == 2) return run_t<__half>(dkv, a, D, st);
  return -1;
}

}  // namespace

extern "C" {

// The tensor-core backward: mxtpu_flash_bwd_dq's and
// mxtpu_flash_bwd_dkv's contract (flash_bwd.cu) for bf16 (dtype 1) or fp16
// (dtype 2) with D = 64 or 128, every operand's base and (b, h, t)
// strides multiples of 16 bytes (dims of size 1 aside), and dk and dv with the
// same strides. strides: 18
// values, (b, h, t) of q, k, v, g and the two outputs, in elements.
// Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for operands TMA cannot describe, kMapError + a
// CUresult when the tensor-map encoder refuses one, or -1 for another D
// or dtype.
int mxtpu_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                          const void* g, const float* lse, const float* delta,
                          const int* lengths, void* dq, int B, int H, int Tq,
                          int Tk, int D, const long long* strides,
                          float scale, int causal, int cache_offset,
                          int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, lengths, dq, nullptr, B, H, Tq, Tk,
               strides, scale, causal, cache_offset};
  return run(false, a, D, dtype, stream);
}

int mxtpu_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                           const void* g, const float* lse,
                           const float* delta, const int* lengths, void* dk,
                           void* dv, int B, int H, int Tq, int Tk, int D,
                           const long long* strides, float scale, int causal,
                           int cache_offset, int dtype, void* stream) {
  const Args a{q, k, v, g, lse, delta, lengths, dk, dv, B, H, Tq, Tk,
               strides, scale, causal, cache_offset};
  return run(true, a, D, dtype, stream);
}

}  // extern "C"
