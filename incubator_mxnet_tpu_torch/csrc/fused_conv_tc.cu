// Fused conv + BatchNorm forward in bf16 on Hopper's tensor cores
// (sm_90a): K1 as wgmma products of shared-memory tiles that TMA fills.
// Plain C interface for ctypes.
//
// It computes what csrc/fused_conv.cu computes (see its header: the TPU
// kernel `_fused_conv_kernel` of the JAX package's ops/pallas_conv.py), for
// bf16 with Ci and Co multiples of 8: TMA needs 16-byte row strides.
// ops/fused_conv.py's `conv_route` sends every other call to
// fused_conv.cu. The contract, NHWC activations and HWIO weights:
//   x_pro = relu(a*x + b [+ ar*r + br])   fp32, rounded to bf16
//           (no prologue at all when neither a nor r is given)
//   y     = conv(zero-pad(x_pro), w)      fp32 accumulation, stored in bf16
//   s, ss = per-channel sum and sum of squares of the fp32 accumulator
//   xp    = x_pro, written out when asked (`emit`)
//
// Design: an implicit GEMM with M = output pixels, N = Co, K = taps * Ci,
// on the mainloop of conv_bwd_tc.cu (tc_common.cuh) with the roles of the
// operands swapped. A block's 64 rows are a box of output pixels (whole
// rows, then whole images); A for one tap and one 64-channel chunk is the
// matching box of x shifted by the tap, loaded by one 4-D TMA (at stride 2
// the map's elementStrides are 2, so the box is the tap's strided pixels),
// K-major: wgmma's native layout. B is the tap's weight
// w[ky,kx,c0:+64,co0:+BN], co contiguous: MN-major, read transposed, by a
// 2-D TMA over the (KH*KW*Ci, Co) matrix (two 64-column boxes at BN 128).
// A ring of three stages, one producer warp, one consumer warpgroup, two
// blocks per SM, wgmma m64 with BN 64 or 128, bf16 in, fp32 accumulate.
//
// The prologue: the consumer rewrites the raw x tile in place, 16-byte
// chunk by chunk in the swizzled layout, then runs fence.proxy.async
// before the wgmma reads it. TMA's zero fill outside the tensor is the
// padding of a plain conv (no a, no r: ResNet-50's first conv1 and its
// downsample convs), which skips the rewrite and the fence; under a
// prologue a padded tap would be relu(b), so the rewrite writes 0 there,
// and on channels past Ci. At 3x3 stride 1 one rewritten box serves the 3
// taps of a kernel row: the box is whole output rows widened by 2 columns,
// and tap kx's operand is the tile kx rows further on (as K3's). The
// widened columns hold no output pixel: they are never stored, summed or
// emitted.
//
// The epilogue: the accumulator goes through shared memory into 16-byte
// bf16 stores of y; the per-channel partial sums and sums of squares of
// the fp32 accumulator over real pixels go to `part`, one row per box,
// then the ordered column_sum (no atomics: the result repeats bit for
// bit). With `emit` at 1x1 stride 1 pad 0 (the model's join convs, whose
// rows are x's pixels) the column-block-0 blocks store their rewritten
// rows to xp; any other shape takes join_emit_kernel. Where the grid is
// short of the card at a deep K, the steps are split over the grid's third
// dimension into fp32 partial planes, and split_finish_kernel sums them in
// order, rounds y and takes the partial sums.
//
// What bounds it: by its bytes and operations most ResNet-50 convs are
// bound by bytes in bf16 (chip_smoke.conv_bound), the 7x7 ones by
// operations. The products run on wgmma and the bytes come by TMA; the
// x tile is rewritten once per Co block that reads it (PERF.md has the
// cycle counts, tools/torch_conv_tc_phases.py).

#include "tc_common.cuh"

namespace {

using namespace mxconv;

// The steps of a block, in order: each 64-channel chunk c of Ci, within it
// each tap column tx (one step for a row of taps), then each tap row ty.
struct FwdWalk {
  int c, tx, ty;
  __device__ __forceinline__ FwdWalk(int step, int chunks, int nkx) {
    c = step % chunks;
    const int t = step / chunks;
    tx = t % nkx;
    ty = t / nkx;
  }
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

// T taps of one kernel row per step: T = 1 in general; T = KW (3) for a
// stride-1 conv without a residual, whose x box is 2 pixels wider than the
// output's rows (the rows the shifts reach, 8 more, stay in the stage).
template <int T>
__host__ __device__ constexpr int fwd_x_bytes() {
  return T == 1 ? kTileBytes : kTileBytes + 1024;
}

template <int BN, int T>
__host__ __device__ constexpr int fwd_stage_bytes() {  // x [r], T of w
  return (T == 1 ? 2 : 1) * fwd_x_bytes<T>() + T * BN * kDepth * 2;
}

template <int BN, int T>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 1024 + kStages * fwd_stage_bytes<BN, T>() + 2 * kStages * 8 +
         2 * 4 * BN * 4;
}

// One block: the output box blockIdx.x, output channels blockIdx.y*BN
// (+BN), the steps [blockIdx.z * per_split, +per_split). Threads 0-127 are
// the consumer warpgroup, thread 128 the producer.
template <int BN, int T>
__global__ void __launch_bounds__(kTcThreads, 2)
fused_conv_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_r,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ a, const float* __restrict__ b,
                     int has_res_arg, const float* __restrict__ ar,
                     const float* __restrict__ br, bf16* __restrict__ y,
                     float* __restrict__ part, float* __restrict__ part_y,
                     bf16* __restrict__ xp, Shape sh, Geo geo, int relu,
                     int per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  constexpr int kX = fwd_x_bytes<T>();
  constexpr int kW = BN * kDepth * 2;           // one tap's weight tile
  constexpr int kWOff = (T == 1 ? 2 : 1) * kX;  // weights after x [and r]
  constexpr int kStage = fwd_stage_bytes<BN, T>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(empty + kStages);  // [2][4][BN]

  const int tid = threadIdx.x;
  const int s = sh.stride;
  const bool has_res = T == 1 && has_res_arg;  // T > 1: never a residual
  const bool has_pro = a != nullptr;
  const bool pro = has_pro || has_res;
  const int chunks = (sh.Ci + kDepth - 1) / kDepth;
  const int nkx = T == 1 ? sh.KW : 1;
  const int total = sh.KH * nkx * chunks;
  const int s_begin = blockIdx.z * per_split;
  const int nsteps = max(0, min(s_begin + per_split, total) - s_begin);
  const int wb = blockIdx.x % geo.tw;
  const int hb = (blockIdx.x / geo.tw) % geo.th;
  const int nb = blockIdx.x / (geo.tw * geo.th);
  const int wo0 = wb * geo.bw, ho0 = hb * geo.bh, n0 = nb * geo.bn;
  const int co0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128) {
      const uint32_t bytes =
          (has_res ? 2 : 1) * geo.rows * kDepth * 2 + T * kW;
      FwdWalk walk(s_begin, chunks, nkx);
      for (int step = 0; step < nsteps; ++step, walk.next(chunks, nkx)) {
        const int st = step % kStages;
        const uint32_t round = step / kStages;
        mbar_wait(&empty[st], (round & 1) ^ 1);
        const int c0 = walk.c * kDepth, ky = walk.ty;
        const int kx = T == 1 ? walk.tx : 0;  // a row: its first tap
        const int wi0 = wo0 * s - sh.pad + kx, hi0 = ho0 * s - sh.pad + ky;
        uint8_t* base = smem + st * kStage;
        mbar_expect_tx(&full[st], bytes);
        tma_load_4d(base, &map_x, &full[st], c0, wi0, hi0, n0);
        if (has_res)
          tma_load_4d(base + kX, &map_r, &full[st], c0, wi0, hi0, n0);
        const int row0 = (ky * sh.KW + kx) * sh.Ci + c0;
        for (int t = 0; t < T; ++t)
          for (int h = 0; h < BN / 64; ++h)
            tma_load_2d(base + kWOff + t * kW + h * kTileBytes, &map_w,
                        &full[st], co0 + 64 * h, row0 + t * sh.Ci);
      }
    }
    return;
  }

  // the consumer warpgroup. Prologue: thread tid rewrites the 16-byte
  // chunk tid % 8 of rows tid/8 + 16k, k < 4; all four hold the channels
  // c0 + 8*lchunk.
  const int prow = tid >> 3, pchunk = tid & 7;
  const int lchunk = pchunk ^ (prow & 7);
  int bj[4], bi[4], bnn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) box_pos(geo, prow + 16 * k, bj[k], bi[k], bnn[k]);
  bf16* emit = blockIdx.y == 0 ? xp : nullptr;
  // the per-channel operands of the chunk's 8 channels, in 16-byte loads
  // (the wrapper hands them 16-byte aligned; Ci % 8 == 0: whole chunks)
  Pro8 p;
  auto load_pro = [&](int c0) {
    const int ci = c0 + lchunk * 8;
    const bool cic = ci < sh.Ci;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      p.a[q] = 1.0f;
      p.b[q] = p.ar[q] = p.br[q] = 0.0f;
    }
    if (cic && has_pro) {
      load8(a + ci, p.a);
      load8(b + ci, p.b);
    }
    if (cic && has_res) {
      load8(ar + ci, p.ar);
      load8(br + ci, p.br);
    }
  };
  if (pro && chunks == 1) load_pro(0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  FwdWalk walk(s_begin, chunks, nkx);
  for (int step = 0; step < nsteps; ++step, walk.next(chunks, nkx)) {
    const int st = step % kStages;
    const uint32_t round = step / kStages;
    const int c0 = walk.c * kDepth, ky = walk.ty;
    const int kx = T == 1 ? walk.tx : 0;
    if (pro && chunks > 1) load_pro(c0);  // in flight during the wait
    mbar_wait(&full[st], round & 1);
    uint8_t* base = smem + st * kStage;
    if (pro) {
      const int ci = c0 + lchunk * 8;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = prow + 16 * k;
        if (row >= geo.rows) continue;  // no output pixel reads it
        const int off = row * 128 + pchunk * 16;
        const int hi = (ho0 + bi[k]) * s - sh.pad + ky;
        const int wi = (wo0 + bj[k]) * s - sh.pad + kx;
        const int n = n0 + bnn[k];
        uint4 xo = zero;
        if (ci < sh.Ci && n < sh.N && hi >= 0 && hi < sh.H && wi >= 0 &&
            wi < sh.W) {
          xo = prologue8(*reinterpret_cast<const uint4*>(base + off),
                         has_res ? *reinterpret_cast<const uint4*>(
                                       base + kX + off)
                                 : zero,
                         p, has_res, relu);
          if (emit != nullptr)  // 1x1, stride 1, pad 0: the row is x's
            *reinterpret_cast<uint4*>(
                emit + (((long long)n * sh.H + hi) * sh.W + wi) * sh.Ci +
                ci) = xo;
        }
        *reinterpret_cast<uint4*>(base + off) = xo;
      }
      fence_proxy_async();
      sync_consumers();
    }
    wgmma_fence();
    // tap t of a row reads x t rows further on; B is MN-major: 16 rows of
    // K are 2048 bytes, the two 64-column halves of BN 128 8192 apart
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_tile<BN, 0, 1>(
            acc, smem_desc(base + t * 128 + kk * 32, 0, 1024),
            smem_desc(base + kWOff + t * kW + kk * 2048, kTileBytes, 1024));
    wgmma_commit();
    // the products of this step run on while the next tile is rewritten;
    // the previous step's are done, so its stage goes back
    wgmma_wait<1>();
    fence_regs(acc);
    if (step > 0) mbar_arrive(&empty[(step - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue. The accumulator goes through shared memory (the stages are
  // free: every load has landed and every product has read its tiles), so
  // that each thread then owns whole 16-byte chunks of 8 channels.
  constexpr int kLd = BN + 4;  // floats per staged row
  static_assert(kRows * kLd * 4 <= kStages * kStage, "staging fits");
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

  // thread tid owns the channels co0 + 8*(tid % kCpr) of rows
  // tid / kCpr + k * (128 / kCpr)
  constexpr int kCpr = BN / 8;                 // chunks per row
  constexpr int kChunks = kRows * kCpr / 128;  // chunks per thread
  const int cc = tid % kCpr;
  const int co = co0 + cc * 8;
  const bool cok = co < sh.Co;  // Co % 8 == 0: the whole chunk
  const bool split = gridDim.z > 1;
  float sv[8], qv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sv[q] = qv[q] = 0.0f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int row = tid / kCpr + k * (128 / kCpr);
    const float4* sp =
        reinterpret_cast<const float4*>(stage + row * kLd + cc * 8);
    const float4 v0 = sp[0], v1 = sp[1];
    if (split) {  // the fp32 plane of this split: every row, real or not
      if (cok) {
        float4* dst = reinterpret_cast<float4*>(
            part_y + (((long long)blockIdx.z * gridDim.x + blockIdx.x) *
                          kRows + row) * sh.Co + co);
        dst[0] = v0;
        dst[1] = v1;
      }
      continue;
    }
    int jj, ii, nn;
    box_pos(geo, row, jj, ii, nn);
    const int wo = wo0 + jj, ho = ho0 + ii, n = n0 + nn;
    if (!(cok && row < geo.rows && wo < sh.Wo && ho < sh.Ho && n < sh.N))
      continue;
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    st16(y + (((long long)n * sh.Ho + ho) * sh.Wo + wo) * sh.Co + co, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sv[q] += v[q];
      qv[q] += v[q] * v[q];
    }
  }
  if (split) return;  // uniform over the grid: the sums come later
  // a column's partials: the lanes kCpr apart in each warp, then the four
  // warps in order (no atomics)
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int m = kCpr; m < 32; m <<= 1) {
      sv[q] += __shfl_xor_sync(0xffffffffu, sv[q], m);
      qv[q] += __shfl_xor_sync(0xffffffffu, qv[q], m);
    }
  if (lane < kCpr)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      red[(0 * 4 + warp) * BN + cc * 8 + q] = sv[q];
      red[(1 * 4 + warp) * BN + cc * 8 + q] = qv[q];
    }
  sync_consumers();
  for (int idx = tid; idx < 2 * BN; idx += 128) {
    const int which = idx / BN, c = idx % BN;
    const float* q = red + which * 4 * BN + c;
    const float tot = ((q[0] + q[BN]) + q[2 * BN]) + q[3 * BN];
    if (co0 + c < sh.Co)
      part[((long long)which * gridDim.x + blockIdx.x) * sh.Co + co0 + c] =
          tot;
  }
}

// y and the partial sums of box blockIdx.x, channels blockIdx.y*64 (+64),
// from the split planes: thread t takes channel t % 64 over the 32 rows of
// half t / 64, each the planes' sum in order.
__global__ void __launch_bounds__(128)
split_finish_kernel(const float* __restrict__ part_y, int splits, Shape sh,
                    Geo geo, bf16* __restrict__ y, float* __restrict__ part) {
  __shared__ float red[2][2][64];
  const int box = blockIdx.x, boxes = gridDim.x;
  const int t = threadIdx.x & 63, half = threadIdx.x >> 6;
  const int c = blockIdx.y * 64 + t;
  const int wo0 = (box % geo.tw) * geo.bw;
  const int ho0 = ((box / geo.tw) % geo.th) * geo.bh;
  const int n0 = (box / (geo.tw * geo.th)) * geo.bn;
  float sv = 0.0f, qv = 0.0f;
  if (c < sh.Co)
    for (int row = half * 32; row < half * 32 + 32; ++row) {
      int jj, ii, nn;
      box_pos(geo, row, jj, ii, nn);
      const int wo = wo0 + jj, ho = ho0 + ii, n = n0 + nn;
      if (!(row < geo.rows && wo < sh.Wo && ho < sh.Ho && n < sh.N)) continue;
      float v = 0.0f;
      for (int z = 0; z < splits; ++z)
        v += part_y[(((long long)z * boxes + box) * kRows + row) * sh.Co + c];
      y[(((long long)n * sh.Ho + ho) * sh.Wo + wo) * sh.Co + c] =
          __float2bfloat16(v);
      sv += v;
      qv += v * v;
    }
  red[0][half][t] = sv;
  red[1][half][t] = qv;
  __syncthreads();
  if (threadIdx.x < 64 && c < sh.Co) {
    part[(long long)box * sh.Co + c] = red[0][0][t] + red[0][1][t];
    part[((long long)boxes + box) * sh.Co + c] = red[1][0][t] + red[1][1][t];
  }
}

template <int BN, int T>
int launch_fwd(const void* x, const void* w, const float* a, const float* b,
               const void* r, const float* ar, const float* br, void* y,
               float* s, float* ss, void* xp, float* part, float* part_y,
               const Shape& sh, int relu, int bw, int bh, int bn, int splits,
               cudaStream_t stream) {
  Geo geo;
  int err = make_geo(bw, bh, bn, sh.Wo, sh.Ho, sh.N, &geo);
  if (err) return err;
  CUtensorMap map_x, map_r, map_w;
  if ((err = encode_act(&map_x, x, sh.N, sh.H, sh.W, sh.Ci, geo,
                        sh.stride)) ||
      (err = encode_act(&map_r, r != nullptr ? r : x, sh.N, sh.H, sh.W,
                        sh.Ci, geo, sh.stride)))
    return err;
  const uint64_t wdims[2] = {(uint64_t)sh.Co,
                             (uint64_t)sh.KH * sh.KW * sh.Ci};
  const uint32_t wbox[2] = {(uint32_t)kDepth, (uint32_t)kDepth};
  const uint32_t wes[2] = {1, 1};
  if ((err = encode_packed(&map_w, w, 2, wdims, wbox, wes))) return err;
  constexpr int smem = fwd_smem_bytes<BN, T>();
  static bool opted = false;
  if ((err = allow_smem((const void*)fused_conv_tc_kernel<BN, T>, smem,
                        &opted)))
    return err;
  const int boxes = geo.tw * geo.th * geo.tn;
  const int total =
      sh.KH * (T == 1 ? sh.KW : 1) * ((sh.Ci + kDepth - 1) / kDepth);
  const int per_split = (total + splits - 1) / splits;
  const bool emit_rows = xp != nullptr && sh.KH == 1 && sh.KW == 1 &&
                         sh.stride == 1 && sh.pad == 0;
  fused_conv_tc_kernel<BN, T>
      <<<dim3(boxes, (sh.Co + BN - 1) / BN, splits), kTcThreads, smem,
         stream>>>(map_x, map_r, map_w, a, b, r != nullptr ? 1 : 0, ar, br,
                   static_cast<bf16*>(y), part, part_y,
                   emit_rows ? static_cast<bf16*>(xp) : nullptr, sh, geo,
                   relu, per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (splits > 1)
    split_finish_kernel<<<dim3(boxes, (sh.Co + 63) / 64), 128, 0, stream>>>(
        part_y, splits, sh, geo, static_cast<bf16*>(y), part);
  column_sums(part, 2, boxes, sh.Co, s, ss, nullptr, stream);
  if (xp != nullptr && !emit_rows) {
    const long long total_x = (long long)sh.N * sh.H * sh.W * sh.Ci;
    const long long want = (total_x + 255) / 256;
    join_emit_kernel<bf16><<<(int)(want < 4096 ? want : 4096), 256, 0,
                             stream>>>(
        static_cast<const bf16*>(x), a, b, static_cast<const bf16*>(r), ar,
        br, static_cast<bf16*>(xp), total_x, sh.Ci, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core forward: mxtpu_fused_conv_fwd's contract (see
// fused_conv.cu) for bf16 with Ci % 8 == 0 and Co % 8 == 0. A block takes
// a box of bw x bh x bn (<= 64) output pixels and bn_cols (64 or 128)
// output channels. taps: 1, or KW (3) for a stride-1 conv without a
// residual, with bn_cols 64, the box then bw = Wo + KW - 1 wide (whole
// output rows and the columns the row's taps reach past them). splits: the
// ranges of whole steps (one step: 64 channels of one tap, or of a row of
// taps) the grid's third dimension cuts K into. part: scratch of 2 *
// boxes * Co floats; part_y (splits > 1): splits * boxes * 64 * Co floats.
extern "C" int mxtpu_fused_conv_tc(
    const void* x, const void* w, const float* a, const float* b,
    const void* r, const float* ar, const float* br, void* y, float* s,
    float* ss, void* xp, float* part, float* part_y, int N, int H, int W,
    int Ci, int Co, int KH, int KW, int stride, int pad, int Ho, int Wo,
    int relu, int bw, int bh, int bn, int bn_cols, int taps, int splits,
    void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ci % 8 != 0 || Co % 8 != 0 || splits < 1 ||
      (splits > 1 && part_y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (taps == 3) {
    if (KW != 3 || stride != 1 || r != nullptr || bn_cols != 64 ||
        bw != Wo + KW - 1)
      return (int)cudaErrorInvalidValue;
    return launch_fwd<64, 3>(x, w, a, b, r, ar, br, y, s, ss, xp, part,
                             part_y, sh, relu, bw, bh, bn, splits, st);
  }
  if (taps != 1) return (int)cudaErrorInvalidValue;
  if (bn_cols == 64)
    return launch_fwd<64, 1>(x, w, a, b, r, ar, br, y, s, ss, xp, part,
                             part_y, sh, relu, bw, bh, bn, splits, st);
  if (bn_cols == 128)
    return launch_fwd<128, 1>(x, w, a, b, r, ar, br, y, s, ss, xp, part,
                              part_y, sh, relu, bw, bh, bn, splits, st);
  return (int)cudaErrorInvalidValue;
}
