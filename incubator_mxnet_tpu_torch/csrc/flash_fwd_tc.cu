// Flash-attention forward in bf16 or fp16 on Hopper's tensor cores
// (sm_90a): K4 as wgmma products of shared-memory tiles that TMA fills,
// with the online softmax in registers. Plain C interface for ctypes.
//
// It computes what csrc/flash_fwd.cu computes (see its header: the TPU
// kernel `_flash_fwd_kernel` of the JAX package's ops/pallas_attention.py),
// for bf16 or fp16 (one template over the element type T: the wgmma
// operand type, the TMA element type and the conversions differ, the rest
// is one code) with D = 64 or 128 and every operand's base and (b, h, t)
// strides multiples of 16 bytes, as TMA needs. ops/flash_attention.py's
// `flash_fwd_route` sends training and prefill calls of that kind here,
// decode steps (one query row) to csrc/flash_fwd_split.cu and every other
// call to flash_fwd.cu. The contract, per (batch, head) and query row:
//   o   = sum_j p_j v_j / sum_j p_j,  p_j = exp(scale * q.k_j)
//   lse = log(sum_j exp(scale * q.k_j))   (fp32, natural log)
// over the attended keys: per-batch `lengths`, causal aligned bottom-right
// (key <= query + Tk - Tq) or, with `cache_offset`, at the per-batch fill
// (key <= query + lengths[b] - Tq). A row with no attended key writes 0
// and lse = -inf. p is rounded to the input type before P.V (as the TPU
// kernel casts it); every sum runs in fp32 and o is rounded once.
// Each block owns its output rows: no atomics, and a run repeats bit for
// bit.
//
// Design (K5's, csrc/flash_bwd_tc.cu, turned around): one block per
// (b*h, 64 query rows) with one consumer warpgroup and one producer warp,
// whose thread 0 issues every TMA load (two consumer warpgroups sharing
// each K/V tile, 128 rows a block, measured slower in every case: PERF.md).
// Q is loaded once; K and V stream in 64-key tiles through a ring of two
// stages, up to the block's causal/length bound (flash_tc.cuh,
// `Mask::kend`). Per tile,
// S = Q.K^T (both K-major in shared memory) lands in registers; the row
// max and sum are taken there (each accumulator row lives in one quad of
// lanes, so a row reduction is two shfl_xor steps), p = exp2(s * scale *
// log2e - m) is packed to bf16/fp16 A fragments (hopper.cuh, pack_a), and
// O += P.V runs with A from registers and V read MN-major. The O
// accumulator has the scores' row map, so the rescale by exp2(m_old -
// m_new) is a multiply in place. One uniform branch a tile picks the
// masked or the unmasked softmax. Causal grids put the heaviest query tiles
// first. The epilogue divides by the row sum, stages O in swizzled shared
// memory (its Q tile) and writes 16-byte chunks into the (B, T, H, D)
// buffer; the lse goes out in natural-log units, as the backward reads it.
// Rows past Tq and keys past Tk arrive as TMA's zero fill and are masked.
//
// What bounds it: at the GPT training shape (B=8, H=12, T=256, D=64,
// causal) the bytes (q, k, v read and o, lse written: 12.7 MB of bf16)
// bound it at about 3.8 us, the operations at about 1.6 us on the tensor
// cores. A block walks at most 4 key tiles there, so its fixed costs (the
// first loads, the epilogue) weigh as in K5; PERF.md has the phase counts
// (tools/torch_flash_tc_phases.py).

#include <type_traits>

#include "flash_tc.cuh"

namespace {

using namespace mxflash;

constexpr int kStages = 2;  // ring of shared-memory stages

constexpr int kThreads = 160;  // the consumer warpgroup + the producer warp

template <int D>
constexpr int fwd_smem_bytes() {  // Q, the K/V ring, barriers
  return 1024 + (1 + 2 * kStages) * (D / 64) * kBox + (1 + 2 * kStages) * 8;
}

// One block: queries [q0, q0 + 64) of (batch, head) blockIdx.x, q0 from
// blockIdx.y counted from the last tile. Threads 0..127 are the consumer
// warpgroup, 128..159 the producer warp.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    float* __restrict__ lse, const int* __restrict__ lengths,
                    T* __restrict__ o, int H, int Tq, int Tk, long long sb,
                    long long sh, long long st, float scale, int causal,
                    int cache_offset) {
  constexpr int NB = D / 64;  // 64-column boxes of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;                   // [NB] boxes
  uint8_t* ring = qs + NB * kBox;       // [kStages][K: NB, V: NB]
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

  if (tid >= 128) {  // the producer warp: one thread issues the loads
    if (tid == 128 && ntiles > 0) {
      mbar_expect_tx(qbar, NB * kBox);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(qs + c * kBox, &map_q, qbar, 64 * c, q0, h, b);
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

  // the consumer warpgroup: rows r0 and r0 + 8 of the 64
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const float sl2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // the running row max (log2 units, scale folded in) and this thread's
  // share of the row sum
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const int j0 = it * kTile;
    const uint8_t* kt = ring + s * 2 * NB * kBox;
    const uint8_t* vt = kt + NB * kBox;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wgmma_n64<0, 0, T>(sc, kmajor(qs, kk), kmajor(kt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the online softmax in registers; a tile inside the valid pairs
    // skips the mask (one branch per tile, uniform over the warpgroup)
    auto softmax = [&](auto masked) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float x = sc[i] * sl2;
        if constexpr (decltype(masked)::value) {
          const int col = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          x = m.ok(r0 + 8 * hh, col) ? x : -INFINITY;
        }
        sc[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
      float muse[2], alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float mnew = fmaxf(mrow[hh], mx[hh]);
        // a row with no attended key yet keeps -inf: guard the exps
        muse[hh] = mnew == -INFINITY ? 0.f : mnew;
        alpha[hh] = exp2_fast(mrow[hh] - muse[hh]);
        mrow[hh] = mnew;
        lrow[hh] *= alpha[hh];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const float p = exp2_fast(sc[i] - muse[hh]);
        sc[i] = p;
        lrow[hh] += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    if (m.full(q0, j0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    uint32_t a[4][4];
    pack_a<0, T>(sc, a[0]);
    pack_a<1, T>(sc, a[1]);
    pack_a<2, T>(sc, a[2]);
    pack_a<3, T>(sc, a[3]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1, T>(acc, a[kk], mnmajor(vt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  const int rows = min(kTile, Tq - q0);
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = lrow[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = l > 0.f ? 1.f / l : 0.f;
    const int row = r0 + 8 * hh;
    if (lse != nullptr && (lane & 3) == 0 && row < Tq)
      lse[(long long)bh * Tq + row] =
          l > 0.f ? (mrow[hh] + log2f(l)) * kLn2 : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i >> 1) & 1];
  store_tile<D>(acc, qs, o + b * sb + h * sh + q0 * st, st, rows);
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int* lengths;
  int B, H, Tq, Tk;
  const long long* strides;  // (b, h, t) of q, k, v, o
  float scale;
  int causal, cache_offset;
};

template <int D, typename T>
int launch(const Args& a, cudaStream_t stream) {
  const long long* s = a.strides;
  CUtensorMap mq, mk, mv;
  int err;
  constexpr CUtensorMapDataType dt = tma_dtype<T>();
  if ((err = encode_bhtd(&mq, a.q, a.B, a.H, a.Tq, D, s, dt)) ||
      (err = encode_bhtd(&mk, a.k, a.B, a.H, a.Tk, D, s + 3, dt)) ||
      (err = encode_bhtd(&mv, a.v, a.B, a.H, a.Tk, D, s + 6, dt)))
    return err;
  constexpr int smem = fwd_smem_bytes<D>();
  static bool opted = false;
  if ((err = allow_smem((const void*)flash_fwd_tc_kernel<D, T>, smem,
                        &opted)))
    return err;
  const long long* so = s + 9;
  const dim3 grid(a.B * a.H, (a.Tq + kTile - 1) / kTile);
  flash_fwd_tc_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, a.lse, a.lengths, static_cast<T*>(a.o), a.H, a.Tq, a.Tk,
      so[0], so[1], so[2], a.scale, a.causal, a.cache_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tensor-core forward: mxtpu_flash_fwd's contract (flash_fwd.cu) for
// bf16 (dtype 1) or fp16 (dtype 2) with D = 64 or 128 and every
// operand's base and (b, h, t) strides multiples of 16 bytes (dims of
// size 1 aside). strides: 12 values, (b, h, t) of q, k, v, o, in elements.
// Returns the cudaError_t
// of the launch (0 on success), cudaErrorInvalidValue for operands TMA
// cannot describe, kMapError + a CUresult when the tensor-map encoder
// refuses one, or -1 for another D or dtype.
int mxtpu_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                       float* lse, const int* lengths, int B, int H, int Tq,
                       int Tk, int D, const long long* strides, float scale,
                       int causal, int cache_offset, int dtype,
                       void* stream) {
  // the output is written in 16-byte chunks
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, lengths, B, H, Tq, Tk, strides, scale,
               causal, cache_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch<64, bf16>(a, st);
  if (dtype == 1 && D == 128) return launch<128, bf16>(a, st);
  if (dtype == 2 && D == 64) return launch<64, __half>(a, st);
  if (dtype == 2 && D == 128) return launch<128, __half>(a, st);
  return -1;
}

}  // extern "C"
