// Fused conv + BatchNorm forward in fp32 on Hopper's FP32 pipes (sm_90a):
// K1 as register micro-tiles fed by TMA. Plain C interface for ctypes.
//
// It computes what fused_conv_fwd_kernel of csrc/fused_conv.cu computes
// (see its header: the TPU kernel `_fused_conv_kernel` of the JAX
// package's ops/pallas_conv.py), for fp32 with Ci and Co multiples of 4
// (rows of whole 16-byte chunks, as TMA and the vector loads need) and
// 16-byte aligned operands; ops/fused_conv.py's `conv_route` sends those
// calls here ("f32"):
//   x_pro = relu(a*x + b [+ ar*r + br])   fp32 (no prologue at all when
//                                         neither a nor r is given)
//   y     = conv(zero-pad(x_pro), w)      fp32
//   s, ss = per-channel sum and sum of squares of y
//   xp    = x_pro, written out when asked (`emit`)
// y is the SIMT kernel's bit for bit: both accumulate each output in fp32
// FMAs over (tap, input channel) in ascending order. The sums are too:
// `tile_stats_kernel` takes them from y in the SIMT kernel's epilogue
// order (64-row tiles, 4 rows a thread, 16 thread rows in order, then the
// ordered column_sum), so the fp32 results do not depend on which of the
// two routes a call takes. (The batch variance is ss/n - mean^2, which a
// network at its initial weights turns from a rounding difference into a
// percent of its early gradients, so another order of the sums would
// change where fp32 training goes.) No atomics: a run repeats bit for bit.
//
// Design: conv_bwd_f32.cu's K2 with the operands' roles swapped, as
// fused_conv_tc.cu is to conv_bwd_tc.cu. An implicit GEMM: M = output
// pixels, N = Co, K = taps x Ci. A block of 256 threads owns a box of 64
// output pixels (whole rows of the width, then whole images:
// ops/fused_conv.py's `tc_box`) and 64 output channels; a step is one tap
// and 64 channels of Ci. A for the step is the box of x shifted by the tap
// (every second pixel at stride 2: the map's elementStrides), two 4-D TMA
// boxes of 32 channels (128 bytes); B is w[tap, ci0:+64, co0:+64], two 2-D
// boxes of 32 output channels by 64 rows of (tap, ci), co contiguous: the
// depth sits on B's rows. So the product is the C += A . B form of
// flash_fwd_f32.cu's P . V: a thread owns 4 pixels (rows 16*wr + lane/8 +
// 4i) by 4 output channels (chunk lane % 8 of box wc), and per 4 depths it
// reads one float4 of each of its 4 A rows and the float4 of its chunk in
// each of the 4 B rows: 8 loads of one wavefront for 64 FMAs
// (f32_tile.cuh). The steps run through a ring of two stages with one
// mbarrier each; thread 0 starts a step's loads while the step before it
// is computed, and r (the residual, read by the prologue alone) has one
// buffer, refilled with the stage.
//
// The prologue: once a stage has landed each thread rewrites four 16-byte
// chunks of the x tile in place with x_pro, then one block barrier makes
// the tile whole. TMA's zero fill is wrong after the prologue (the
// prologue of a zero is relu(b)), so taps outside x (the padding) and
// channels past Ci are written as 0; rows past the box hold no output
// pixel and are never stored. A plain conv (no a, no r) skips the rewrite:
// there TMA's zero fill is the padding. A 1x1 stride-1 conv's rows are x's
// pixels, so its column-block-0 blocks write `xp` from the rewrite; any
// other shape that emits gets conv_common.cuh's join_emit_kernel.
//
// The epilogue goes through shared memory (the stages are free by then),
// so that a thread stores whole 16-byte chunks of 4 channels of y.
//
// What bounds it: 2*N*Ho*Wo*Ci*Co*taps FLOPs (7.40 GFLOP at 3x3 64->64
// 56^2, B=32) against about 2 bytes read per 100 FLOPs: the card's FP32
// rate (no tensor-core path keeps fp32 off TF32). The SIMT kernel of
// fused_conv.cu gathered A with 4-byte loads and the prologue in every
// thread and stored it transposed, 16 channels a step between two
// barriers; here TMA brings the tiles and a step is 1024 FMAs a thread
// behind one barrier; two blocks an SM (128 registers a thread) overlap one
// block's rewrite with the other's products.

#include "conv_f32.cuh"

namespace {

using namespace mxconv;
using namespace mxf32;

constexpr int kBlockThreads = 256;
constexpr int kCols = 64;                       // output channels of a block
constexpr int kDepthF = 32;                     // channels of a box
constexpr int kStagesF = 2;
constexpr int kBoxF = kTileRows * kDepthF * 4;  // one 64 x 32 fp32 tile
constexpr int kStage = 4 * kBoxF;               // x (2 boxes), w (2 boxes)
// floats per row of the staged output: the 8 lanes of a quarter warp store
// to 32 distinct banks
constexpr int kStageLd = kCols + 8;

constexpr int fwd_f32_smem_bytes(bool res) {
  return kAlign + kStagesF * kStage + (res ? 2 * kBoxF : 0);
}

// One block: output-pixel box blockIdx.x, output channels blockIdx.y * 64
// (+64).
__global__ void __launch_bounds__(kBlockThreads, 2)
fused_conv_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_r,
                      const __grid_constant__ CUtensorMap map_w,
                      const float* __restrict__ a,
                      const float* __restrict__ b, int has_res,
                      const float* __restrict__ ar,
                      const float* __restrict__ br, float* __restrict__ y,
                      float* __restrict__ xp, Shape sh, Box box, int relu,
                      int emit_rows) {
  constexpr int S = kStagesF;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[S];  // the stages' TMA barriers
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* rs = smem + S * kStage;  // r of the step being rewritten

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = sh.stride;
  const int chunks = (sh.Ci + kCols - 1) / kCols;
  const int nsteps = sh.KH * sh.KW * chunks;
  int wo0, ho0, n0;
  box_origin(box, blockIdx.x, wo0, ho0, n0);
  const int co0 = blockIdx.y * kCols;
  const bool pro = a != nullptr || has_res;
  const bool emit = emit_rows && blockIdx.y == 0;

  // step t: tap t / chunks, input channels c0 = 64 * (t % chunks); the
  // box of x the tap reads starts at (wi0, hi0)
  auto step_of = [&](int t, int& tap, int& c0, int& wi0, int& hi0) {
    tap = t / chunks;
    c0 = (t - tap * chunks) * kCols;
    const int ky = tap / sh.KW, kx = tap - ky * sh.KW;
    wi0 = wo0 * s - sh.pad + kx;
    hi0 = ho0 * s - sh.pad + ky;
  };
  // thread 0 starts step t's loads: x and w into stage t % S, r into its
  // buffer
  auto fetch = [&](int t) {
    int tap, c0, wi0, hi0;
    step_of(t, tap, c0, wi0, hi0);
    uint8_t* st = smem + (t % S) * kStage;
    uint64_t* bar = &bars[t % S];
    fence_proxy_async();  // the stage's last reads and writes come first
    mbar_expect_tx(bar, (2 + 2 * has_res) * box.rows * 128 +
                            2 * kTileRows * 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tma_load_4d(st + h * kBoxF, &map_x, bar, c0 + h * kDepthF, wi0, hi0,
                  n0);
      tma_load_2d(st + (2 + h) * kBoxF, &map_w, bar, co0 + h * kDepthF,
                  tap * sh.Ci + c0);
      if (has_res)
        tma_load_4d(rs + h * kBoxF, &map_r, bar, c0 + h * kDepthF, wi0, hi0,
                    n0);
    }
  };

  init_bars<S>(bars);
  if (tid == 0) fetch(0);  // nsteps >= 1

  // the prologue: thread tid rewrites chunk position fp = tid % 8 of rows
  // fr and fr + 32 (fr = tid / 8: one r % 8, so one logical chunk,
  // channels 4 * fchunk of each box)
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

  // the product: pixels ra + 4i, output channels 4 * lx + j of box wc;
  // row t of B holds the thread's chunk at t * 128 + xl[t % 8]
  const int wr = warp >> 1, wc = warp & 1, ly = lane >> 3, lx = lane & 7;
  const int ra = 16 * wr + ly;
  const RowOffs oa(ra);
  uint32_t xl[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) xl[k] = (2 + wc) * kBoxF + ((lx ^ k) << 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int step = 0; step < nsteps; ++step) {
    uint8_t* st = smem + (step % S) * kStage;
    int tap, c0, wi0, hi0;
    step_of(step, tap, c0, wi0, hi0);
    // the prologue's operands of the thread's channels, loaded before the
    // wait
    Pro4 p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = c0 + h * kDepthF + 4 * fchunk;
      p[h] = load_pro4(a, b, ar, br, ci, pro && ci < sh.Ci);
    }
    mbar_wait(&bars[step % S], (step / S) & 1);
    if (pro) {  // uniform over the block
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = c0 + h * kDepthF + 4 * fchunk;
        const bool cin = ci < sh.Ci;  // Ci % 4 == 0: the whole chunk
        uint8_t* xt = st + h * kBoxF;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int row = fr + 32 * k;
          const uint32_t off = row * 128 + fp * 16;
          const int n = n0 + fn[k];
          const int hi = hi0 + s * fi[k], wi = wi0 + s * fj[k];
          const bool xin = row < box.rows && n < sh.N && hi >= 0 &&
                           hi < sh.H && wi >= 0 && wi < sh.W;
          float4 v = zero;
          if (xin && cin) {
            v = prologue4(ld4(xt, off),
                          has_res ? ld4(rs + h * kBoxF, off) : zero, p[h],
                          has_res, relu);
            // a 1x1 stride-1 conv: this row is x's pixel (n, hi, wi)
            if (emit)
              *reinterpret_cast<float4*>(
                  xp + (((long long)n * sh.H + hi) * sh.W + wi) * sh.Ci +
                  ci) = v;
          }
          *reinterpret_cast<float4*>(xt + off) = v;
        }
      }
    }
    // the rewritten tile whole, and every thread done with the stage and
    // the r buffer that the next loads refill
    __syncthreads();
    if (tid == 0 && step + 1 < nsteps) fetch(step + 1);

#pragma unroll
    for (int c = 0; c < kCols / 4; ++c) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = ld4(st, oa.step4(i, c));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * c + e;  // the (tap, ci) row of B
        const float4 bv = ld4(st, t * 128 + xl[t & 7]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = lane_of(av[i], e);
          acc[i][0] = fmaf(wv, bv.x, acc[i][0]);
          acc[i][1] = fmaf(wv, bv.y, acc[i][1]);
          acc[i][2] = fmaf(wv, bv.z, acc[i][2]);
          acc[i][3] = fmaf(wv, bv.w, acc[i][3]);
        }
      }
    }
  }
  __syncthreads();  // every product has read its stage

  // epilogue: the accumulator through shared memory, then thread tid owns
  // the 4-channel chunk cc = tid % 16 of rows tid / 16 + 16k, k < 4
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(stage + (ra + 4 * i) * kStageLd + 32 * wc +
                               4 * lx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();

  const int cc = tid & 15;
  const int co = co0 + 4 * cc;
  if (co >= sh.Co) return;  // Co % 4 == 0: the whole chunk
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = (tid >> 4) + 16 * k;
    const int jj = row % box.bw, ii = (row / box.bw) % box.bh;
    const int n = n0 + row / (box.bw * box.bh), ho = ho0 + ii, wo = wo0 + jj;
    if (row >= box.rows || n >= sh.N || ho >= sh.Ho || wo >= sh.Wo) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(stage + row * kStageLd + 4 * cc);
    st4(y + (((long long)n * sh.Ho + ho) * sh.Wo + wo) * sh.Co + co, v.x, v.y,
        v.z, v.w);
  }
}

// The per-channel partial sums and sums of squares of y over 64-row tiles
// of its N*Ho*Wo rows, in the order of fused_conv.cu's epilogue: thread
// (ty, tx) of 16 x 16 adds rows 4*ty + i, i < 4, of columns 4*tx + j, then
// the 16 thread rows are added in order.
__global__ void __launch_bounds__(kBlockThreads)
tile_stats_kernel(const float* __restrict__ y, long long M, int Co,
                  float* __restrict__ part_s, float* __restrict__ part_ss) {
  __shared__ float red[2][16][kCols];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long m0 = (long long)blockIdx.x * kTileRows;
  const int n0 = blockIdx.y * kCols;
  float s[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      const float v = col < Co ? y[row * Co + col] : 0.0f;
      s[j] += v;
      q[j] += v * v;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = s[j];
    red[1][ty][tx * 4 + j] = q[j];
  }
  __syncthreads();
  if (tid < 2 * kCols) {
    const int which = tid / kCols, c = tid % kCols;
    const int col = n0 + c;
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) t += red[which][k][c];
    if (col < Co)
      (which ? part_ss : part_s)[(long long)blockIdx.x * Co + col] = t;
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch
// ---------------------------------------------------------------------------
int launch(const float* x, const float* w, const float* a, const float* b,
           const float* r, const float* ar, const float* br, float* y,
           float* s, float* ss, float* xp, float* part, const Shape& sh,
           int relu, int bw, int bh, int bn, cudaStream_t stream) {
  Box box;
  if (!make_box(bw, bh, bn, sh.Wo, sh.Ho, sh.N, &box))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_r, map_w;
  const uint64_t wdims[2] = {(uint64_t)sh.Co,
                             (uint64_t)sh.KH * sh.KW * sh.Ci};
  const uint32_t wbox[2] = {(uint32_t)kDepthF, (uint32_t)kTileRows};
  int err;
  if ((err = encode_act_f32(&map_x, x, sh.N, sh.H, sh.W, sh.Ci, box,
                            sh.stride)) ||
      (err = encode_act_f32(&map_r, r != nullptr ? r : x, sh.N, sh.H, sh.W,
                            sh.Ci, box, sh.stride)) ||
      (err = encode_packed_f32(&map_w, w, 2, wdims, wbox)))
    return err;
  static bool opted = false;
  if ((err = allow_smem((const void*)fused_conv_f32_kernel,
                        fwd_f32_smem_bytes(true), &opted)))
    return err;
  const int boxes = box.tw * box.th * box.tn;
  const int emit_rows = xp != nullptr && sh.KH == 1 && sh.KW == 1 &&
                        sh.stride == 1 && sh.pad == 0;
  const int cols = (sh.Co + kCols - 1) / kCols;
  fused_conv_f32_kernel<<<dim3(boxes, cols), kBlockThreads,
                          fwd_f32_smem_bytes(r != nullptr), stream>>>(
      map_x, map_r, map_w, a, b, r != nullptr ? 1 : 0, ar, br, y, xp, sh, box,
      relu, emit_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long M = (long long)sh.N * sh.Ho * sh.Wo;
  const int mtiles = (int)((M + kTileRows - 1) / kTileRows);
  float* part_ss = part + (long long)mtiles * sh.Co;
  tile_stats_kernel<<<dim3(mtiles, cols), kBlockThreads, 0, stream>>>(
      y, M, sh.Co, part, part_ss);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  column_sum(part, mtiles, sh.Co, s, stream);
  column_sum(part_ss, mtiles, sh.Co, ss, stream);
  if (xp != nullptr && !emit_rows) {
    const long long total = (long long)sh.N * sh.H * sh.W * sh.Ci;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                         : 4096);
    join_emit_kernel<float><<<blocks, 256, 0, stream>>>(
        x, a, b, r, ar, br, xp, total, sh.Ci, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The fp32 forward on the FP32 pipes: mxtpu_fused_conv_fwd's contract
// (fused_conv.cu) for fp32 with Ci % 4 == 0, Co % 4 == 0 and every operand
// 16-byte aligned. A block takes a box of bw x bh x bn (<= 64) output
// pixels and 64 output channels. part: scratch of 2 * ceil(N*Ho*Wo / 64) *
// Co floats (the SIMT kernel's).
// Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue for widths, boxes or operands it does not take,
// or kMapError + a CUresult when the tensor-map encoder refuses one.
extern "C" int mxtpu_fused_conv_f32(
    const void* x, const void* w, const float* a, const float* b,
    const void* r, const float* ar, const float* br, void* y, float* s,
    float* ss, void* xp, float* part, int N, int H, int W, int Ci, int Co,
    int KH, int KW, int stride, int pad, int Ho, int Wo, int relu, int bw,
    int bh, int bn, void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  if (Ci % 4 != 0 || Co % 4 != 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w, a, b, r, ar, br, y, s, ss, xp, part};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                a, b, static_cast<const float*>(r), ar, br,
                static_cast<float*>(y), s, ss, static_cast<float*>(xp), part,
                sh, relu, bw, bh, bn, static_cast<cudaStream_t>(stream));
}
