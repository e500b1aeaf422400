// Flash-attention forward in fp32 on Hopper's FP32 pipes (sm_90a): K4 as
// register micro-tiles fed by TMA. Plain C interface for ctypes.
//
// It computes what csrc/flash_fwd.cu computes (see its header: the TPU
// kernel `_flash_fwd_kernel` of the JAX package's ops/pallas_attention.py,
// launched there by `_flash_fwd`), for fp32 with D = 64 or 128, more than
// one query row and every operand's base and (b, h, t) strides multiples
// of 16 bytes. ops/flash_attention.py's `flash_fwd_route` sends those
// calls here ("f32"). The contract, per (batch, head): o = softmax(scale *
// q.k^T) . v with an fp32 online softmax (running max, sum and
// accumulator), per-batch key `lengths`, causal masking aligned
// bottom-right (key <= query + Tk - Tq) or, with `cache_offset`, at the
// per-batch fill (key <= query + lengths[b] - Tq), and the optional fp32
// row log-sum-exp. A row with no valid key writes 0 and lse = -inf. Every
// sum is fp32 (no TF32).
//
// Design: flash_bwd_f32.cu's dq kernel turned into the forward. One block
// of 256 threads (8 warps) per (b*h, 64-query tile), the causal grid's
// heaviest blocks first; Q comes by TMA once, K and V in 64-key tiles into
// a ring of two stages (thread 0 starts the boxes of 32 floats x 64 rows
// under the 128-byte swizzle, one mbarrier a stage) up to the causal or
// length bound (flash_tc.cuh's walk and mask). The online softmax needs
// each row's max every tile, so a warp owns whole rows: warp w takes
// queries 8w .. 8w + 7, a lane the 2 rows 8w + lane/8 + 4i and, of each
// tile, the 8 keys lane%8 + 8j. So
//   S = Q.K^T is a 2x8 micro-tile per thread: per 4 depths one float4 of
//       each of its 2 Q rows and 8 K rows, 10 loads for 64 FMAs; the 4 Q
//       rows and the 8 K rows one load reads across the warp lie in
//       distinct bank quads (one wavefront each, broadcast across the
//       lanes that share them);
//   the row max is three shuffles among the 8 lanes of a row, the
//       exponentials one ex2.approx.ftz each on scale*log2(e)-scaled
//       scores, and the row sum stays a per-thread share until the end;
//   P goes to the warp's own rows of a swizzled 64 x 64 tile, read back
//       by the same warp after a __syncwarp (no block barrier for it);
//   O += P.V: a thread owns its 2 rows x D/8 columns (chunks lane%8 + 8u
//       of 4 floats), per 4 keys one float4 of each P row and, per key,
//       D/32 float4 of the V row: 10 loads for 64 FMAs at D = 64.
// One block barrier a tile remains: the next stage's wait, which also
// frees the stage the TMA refills next.
//
// What bounds it: at the GPT training shape (B=8, H=12, T=256, D=64,
// causal) the work is 4*D FLOPs per attended pair, 0.81 GFLOP, against
// about 25 MB of fp32 in and out: bound by operations at the card's FP32
// rate (no tensor-core path keeps fp32 off TF32). The SIMT kernel of
// flash_fwd.cu made about one 4-byte shared load per FMA in both products
// and loaded K and V by scalar loads between two barriers; here a 16-byte
// load feeds 6.4 FMAs and TMA brings the next tile while one is computed.
//
// Inputs may be strided: q, k, v and o have their own batch, head and
// sequence strides (elements); the head dim is contiguous.

#include <type_traits>

#include "f32_tile.cuh"
#include "flash_tc.cuh"

namespace {

using namespace mxflash;
using namespace mxf32;

constexpr int kThreads = 256;
constexpr int kStages = 2;  // ring of shared-memory stages
// depth chunks unrolled in the product loops (a multiple of 8 keeps every
// swizzle offset an immediate)
constexpr int kUnroll = 16;

struct Maps {
  CUtensorMap q, k, v;
};

// bytes of a 64-row fp32 tile of D columns
template <int D>
constexpr int kTileBytes = kTile * D * 4;

template <int D>
constexpr int fwd_smem_bytes() {  // Q, the K/V ring, P
  return kAlign + (1 + 2 * kStages) * kTileBytes<D> + kTileBytes<64>;
}

// One block: queries [q0, q0 + 64) of (batch, head) blockIdx.x, q0 from
// blockIdx.y counted from the last tile (the causal grid's heaviest
// blocks first).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(float* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ lengths, int H, int Tq, int Tk,
                     Strides so, float scale, int causal, int cache_offset,
                     const __grid_constant__ Maps maps) {
  constexpr int TB = kTileBytes<D>, S = kStages;
  constexpr int NU = D / 32;  // 4-float chunks of a thread's output row
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[S];         // the stages' TMA barriers
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* qs = smem;                  // Q of the block's queries
  uint8_t* ring = qs + TB;             // [S][K, V]
  uint8_t* ps = ring + S * 2 * TB;     // P, 64 queries x 64 keys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ly = lane >> 3, lx = lane & 7;
  const int ra = 8 * warp + ly;  // the thread's queries ra + 4i, i < 2
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const Mask m = make_mask(lengths, b, Tq, Tk, causal, cache_offset);
  const int ntiles = key_tiles(m, q0);

  uint32_t ka[2], xl[8];  // the P keys of rows ra + 4i; V's chunk lx
#pragma unroll
  for (int i = 0; i < 2; ++i) ka[i] = row_key(ra + 4 * i);
#pragma unroll
  for (int k = 0; k < 8; ++k) xl[k] = (lx ^ k) << 4;
  const RowOffs oa(ra), ob(lx);
  const float sl2 = scale * kLog2e;

  float acc[2][D / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;
  // the running row max (log2 units, scale folded in) and this thread's
  // share of the row sum
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  // key tile t's K and V into stage t % S (the first also brings Q: a
  // compile-time flag)
  auto fetch = [&](int t, auto first) {
    uint8_t* kt = ring + (t % S) * 2 * TB;
    if (tid == 0) {
      uint64_t* bar = &bars[t % S];
      fence_proxy_async();  // the stage's last reads come first
      mbar_expect_tx(bar, (decltype(first)::value ? 3 : 2) * TB);
      if constexpr (decltype(first)::value)
        tma_tile<D>(qs, &maps.q, bar, q0, h, b);
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

    // S = Q.K^T: rows ra + 4i, keys lx + 8j
    float s[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll kUnroll
    for (int c = 0; c < D / 4; ++c) {
      float4 a[2], bk[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = ld4(qs, oa.step4(i, c));
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = ld4(kt, ob.step8(j, c));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = dot4(a[i], bk[j], s[i][j]);
    }

    // the online softmax in registers; a tile inside the valid pairs
    // skips the mask (one branch per tile, uniform over the block)
    float alpha[2];
    auto softmax = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = s[i][j] * sl2;
          if constexpr (decltype(masked)::value)
            x = m.ok(q0 + ra + 4 * i, j0 + lx + 8 * j) ? x : -INFINITY;
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float mnew = fmaxf(mrow[i], mx);
        // a row with no attended key yet keeps -inf: guard the exps
        const float muse = mnew == -INFINITY ? 0.f : mnew;
        alpha[i] = exp2_fast(mrow[i] - muse);
        mrow[i] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = exp2_fast(s[i][j] - muse);
          sum += p;
          st1(ps, ka[i], lx + 8 * j, p);
        }
        lrow[i] = lrow[i] * alpha[i] + sum;
      }
    };
    if (m.full(q0, j0))
      softmax(std::false_type{});
    else
      softmax(std::true_type{});
    __syncwarp();  // the warp's P rows complete

    // O = O * alpha + P.V: rows ra + 4i, columns chunk lx + 8u
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= alpha[i];
#pragma unroll kUnroll
    for (int c = 0; c < kTile / 4; ++c) {
      float4 x[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) x[i] = ld4(ps, oa.step4(i, c));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * c + e;  // the key row of V
        const uint32_t row = t * 128 + xl[t & 7];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float4 y = ld4(vt, row + u * kBoxBytes);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float w = lane_of(x[i], e);
            acc[i][4 * u + 0] = fmaf(w, y.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(w, y.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(w, y.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(w, y.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
    // the next stage has landed, and every warp is done with this one
    if (it + 1 < ntiles) wait(it + 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + ra + 4 * i;
    if (row >= Tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* out = o + b * so.b + h * so.h + (long long)row * so.t;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      *reinterpret_cast<float4*>(out + 4 * (lx + 8 * u)) = make_float4(
          acc[i][4 * u] * inv, acc[i][4 * u + 1] * inv,
          acc[i][4 * u + 2] * inv, acc[i][4 * u + 3] * inv);
    if (lse != nullptr && lx == 0)
      lse[(long long)bh * Tq + row] =
          l > 0.f ? (mrow[i] + log2f(l)) * kLn2 : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------
template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, const int* lengths, int B, int H, int Tq, int Tk,
           const Strides (&st)[4], float scale, int causal,
           int cache_offset, cudaStream_t stream) {
  Maps maps{};
  int err;
  if ((err = encode_f32(&maps.q, q, B, H, Tq, D, st[0])) ||
      (err = encode_f32(&maps.k, k, B, H, Tk, D, st[1])) ||
      (err = encode_f32(&maps.v, v, B, H, Tk, D, st[2])))
    return err;
  constexpr int smem = fwd_smem_bytes<D>();
  static bool opted = false;
  if ((err = allow_smem((const void*)flash_fwd_f32_kernel<D>, smem, &opted)))
    return err;
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      o, lse, lengths, H, Tq, Tk, st[3], scale, causal, cache_offset, maps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The fp32 forward: mxtpu_flash_fwd's contract (flash_fwd.cu) for fp32
// with D = 64 or 128 and every operand's base and (b, h, t) strides
// multiples of 16 bytes (dims of size 1 aside). strides: 12 values, (b,
// h, t) of q, k, v, o, in elements. lse and lengths may be null. Returns
// the cudaError_t of the launch (0 on success), cudaErrorInvalidValue for
// a misaligned operand, kMapError + a CUresult when the tensor-map encoder
// refuses one, or -1 for another D.
int mxtpu_flash_fwd_f32(const void* q, const void* k, const void* v,
                        void* o, float* lse, const int* lengths, int B, int H,
                        int Tq, int Tk, int D, const long long* strides,
                        float scale, int causal, int cache_offset,
                        void* stream) {
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  const void* ptrs[4] = {q, k, v, o};
  const int ts[4] = {Tq, Tk, Tk, Tq};
  for (int i = 0; i < 4; ++i)
    if (!aligned(ptrs[i], st[i], B, H, ts[i]))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  if (D == 64)
    return launch<64>(fq, fk, fv, fo, lse, lengths, B, H, Tq, Tk, st, scale,
                      causal, cache_offset, s);
  if (D == 128)
    return launch<128>(fq, fk, fv, fo, lse, lengths, B, H, Tq, Tk, st,
                       scale, causal, cache_offset, s);
  return -1;
}

}  // extern "C"
