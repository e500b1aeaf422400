// Fused conv + BatchNorm forward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel `_fused_conv_kernel` (the JAX package's
// ops/pallas_conv.py, launched by `_fused_conv_pallas` and, for strided
// convs, by `_fused_conv_prephase`; one kernel here serves both layouts).
// Same contract, NHWC activations and HWIO weights:
//   x_pro = relu(a*x + b [+ ar*r + br])   fp32, rounded to x's type
//           (no prologue at all when neither a nor r is given)
//   y     = conv(zero-pad(x_pro), w)      fp32 accumulation, stored in x's type
//   s, ss = per-channel sum and sum of squares of the fp32 accumulator
//   xp    = x_pro, written out when asked (`emit`)
// The padding is applied after the prologue, so a padded tap is 0 and
// never relu(b).
//
// Design: an implicit GEMM with M = N*Ho*Wo output pixels, N = Co and
// K = kh*kw*Ci in (tap, channel) order, which is the HWIO weight as a
// row-major (K, Co) matrix. A block computes a 64x64 tile of y with 256
// threads, 4x4 outputs each, in fp32 FMAs from shared memory; it walks K
// in steps of 16 channels of one tap. The A tile is gathered from x with
// the prologue applied while it is staged into shared memory, so the
// normalized activation never touches device memory; the global loads of
// the next step are issued before the current step's products. Statistics
// come from the fp32 accumulators: each block writes its per-channel
// partial sums, and a second small pass (column_sum_kernel) adds them in a
// fixed order, so the result is the same on every run (no atomics).
// `emit` for a 1x1, stride 1, pad 0 conv (the only one the model emits
// from) is written by the column-tile-0 blocks while they stage A (their
// rows are exactly x's pixels); any other shape gets one elementwise pass.
//
// What bounds it: at ResNet-50's shapes the work is 2*M*N*K FLOPs against
// a few bytes per FLOP, so the bound is the card's arithmetic; these are
// scalar fp32 FMAs (67 TFLOP/s peak), not tensor cores. It serves the
// widths and operands the other routes do not take (ops/fused_conv.py's
// conv_route): bf16 widths that are no multiple of 8 (the rest of bf16
// goes to the tensor-core fused_conv_tc.cu), fp32 widths that are no
// multiple of 4 and misaligned fp32 views (the rest of fp32 goes to the
// register micro-tiles of fused_conv_f32.cu).

#include "conv_common.cuh"

namespace {

using namespace mxconv;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const T* __restrict__ r, const float* __restrict__ ar,
                      const float* __restrict__ br, T* __restrict__ y,
                      float* __restrict__ part_s,
                      float* __restrict__ part_ss, T* __restrict__ xp,
                      Shape sh, int relu, int emit_rows) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float red[2][16][kBN];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long M = (long long)sh.N * sh.Ho * sh.Wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bool has_pro = a != nullptr;
  const bool has_res = r != nullptr;
  const bool pro = has_pro || has_res;
  const bool emit = emit_rows && blockIdx.y == 0;

  // A loader: one output pixel per 4 threads, channels ak + 4*j
  const int am = tid >> 2, ak = tid & 3;
  const long long arow = m0 + am;
  const bool arow_ok = arow < M;
  int an = 0, aho = 0, awo = 0;
  if (arow_ok) {
    long long q = arow;
    awo = (int)(q % sh.Wo);
    q /= sh.Wo;
    aho = (int)(q % sh.Ho);
    an = (int)(q / sh.Ho);
  }
  // B loader: one K row per 16 threads, columns bc + 16*j
  const int bk = tid >> 4, bc = tid & 15;

  const int chunks = (sh.Ci + kBK - 1) / kBK;
  const int nsteps = sh.KH * sh.KW * chunks;

  float xa[4], ra[4], wb[4];
  bool va[4];

  auto load = [&](int tap, int c0) {
    const int ky = tap / sh.KW, kx = tap - ky * sh.KW;
    const int hi = aho * sh.stride - sh.pad + ky;
    const int wi = awo * sh.stride - sh.pad + kx;
    const bool pix = arow_ok && hi >= 0 && hi < sh.H && wi >= 0 && wi < sh.W;
    const long long base = (((long long)an * sh.H + hi) * sh.W + wi) * sh.Ci;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + ak + 4 * j;
      va[j] = pix && ci < sh.Ci;
      xa[j] = va[j] ? Elem<T>::ld(x + base + ci) : 0.0f;
      ra[j] = (va[j] && has_res) ? Elem<T>::ld(r + base + ci) : 0.0f;
    }
    const int kc = c0 + bk;
    const T* wrow = w + ((long long)tap * sh.Ci + kc) * sh.Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + bc + 16 * j;
      wb[j] = (kc < sh.Ci && co < sh.Co) ? Elem<T>::ld(wrow + co) : 0.0f;
    }
  };

  auto store = [&](int c0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + ak + 4 * j;
      float v = 0.0f;
      if (va[j]) {
        v = xa[j];
        if (pro) {
          v = prologue_lin(v, has_pro ? a[ci] : 1.0f, has_pro ? b[ci] : 0.0f,
                           has_res, ra[j], has_res ? ar[ci] : 0.0f,
                           has_res ? br[ci] : 0.0f);
          if (relu) v = v > 0.0f ? v : 0.0f;
          v = Elem<T>::round(v);
          if (emit) Elem<T>::st(xp + arow * sh.Ci + ci, v);
        }
      }
      As[ak + 4 * j][am] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[bk][bc + 16 * j] = wb[j];
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  int tap = 0, c0 = 0;
  if (nsteps > 0) load(0, 0);
  for (int step = 0; step < nsteps; ++step) {
    store(c0);
    __syncthreads();
    c0 += kBK;
    if (c0 >= sh.Ci) {
      c0 = 0;
      ++tap;
    }
    if (step + 1 < nsteps) load(tap, c0);
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }

  // epilogue: y in x's type, per-channel partial sums of the accumulator
  float s[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < sh.Co) Elem<T>::st(y + row * sh.Co + col, acc[i][j]);
      s[j] += acc[i][j];
      q[j] += acc[i][j] * acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = s[j];
    red[1][ty][tx * 4 + j] = q[j];
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int which = tid / kBN, c = tid % kBN;
    const int col = n0 + c;
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) t += red[which][k][c];
    if (col < sh.Co)
      (which ? part_ss : part_s)[(long long)blockIdx.x * sh.Co + col] = t;
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* a, const float* b,
           const void* r, const float* ar, const float* br, void* y,
           float* s, float* ss, void* xp, float* part, Shape sh, int relu,
           cudaStream_t stream) {
  const long long M = (long long)sh.N * sh.Ho * sh.Wo;
  const int mtiles = (int)((M + kBM - 1) / kBM);
  const int ntiles = (sh.Co + kBN - 1) / kBN;
  const int emit_rows = xp != nullptr && sh.KH == 1 && sh.KW == 1 &&
                        sh.stride == 1 && sh.pad == 0;
  float* part_s = part;
  float* part_ss = part + (long long)mtiles * sh.Co;
  fused_conv_fwd_kernel<T><<<dim3(mtiles, ntiles), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), a, b,
      static_cast<const T*>(r), ar, br, static_cast<T*>(y), part_s, part_ss,
      static_cast<T*>(xp), sh, relu, emit_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum(part_s, mtiles, sh.Co, s, stream);
  column_sum(part_ss, mtiles, sh.Co, ss, stream);
  if (xp != nullptr && !emit_rows) {
    const long long total = (long long)sh.N * sh.H * sh.W * sh.Ci;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                         : 4096);
    join_emit_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(x), a, b, static_cast<const T*>(r), ar, br,
        static_cast<T*>(xp), total, sh.Ci, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, r, y, xp: NHWC in the dtype (0 fp32, 1 bf16); w: HWIO in the dtype;
// a, b, ar, br, s, ss: fp32 per channel. a == NULL: no BatchNorm prologue;
// r == NULL: no residual; xp == NULL: no emitted activation. part: scratch
// of 2 * ceil(N*Ho*Wo / 64) * Co floats. Returns a cudaError_t.
extern "C" int mxtpu_fused_conv_fwd(
    const void* x, const void* w, const float* a, const float* b,
    const void* r, const float* ar, const float* br, void* y, float* s,
    float* ss, void* xp, float* part, int N, int H, int W, int Ci, int Co,
    int KH, int KW, int stride, int pad, int Ho, int Wo, int relu, int dtype,
    void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, a, b, r, ar, br, y, s, ss, xp, part, sh, relu,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, r, ar, br, y, s, ss, xp, part,
                                 sh, relu, st);
  return (int)cudaErrorInvalidValue;
}
