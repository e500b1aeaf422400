// Fused conv + BatchNorm backward for Hopper (sm_90a): the input-gradient
// kernel (K2) and the weight-gradient kernel (K3), plain C interface for
// ctypes.
//
// K2 replaces the TPU kernel `_conv_bwd_dx_kernel` (the JAX package's
// ops/pallas_conv.py, launched by `_conv_bwd_dx_pallas`), for stride 1
// and stride 2 alike:
//   dy_t = dy + ds + 2*y*dss                  fp32, rounded to y's type
//   dxp  = transpose-conv(dy_t, w)            fp32
//        + g                                  (the emitted activation's cotangent)
//   lin  = a*x + b [+ ar*r + br];  dxf = relu ? (lin > 0 ? dxp : 0) : dxp
//   dx = dxf*a, dr = dxf*ar                   in x's type
//   da = sum dxf*x, db = sum dxf, dar = sum dxf*r   fp32 per channel
// With no prologue (a and r absent) dx = dxp, unmasked, and no sums.
// K3 replaces `_conv_bwd_dw_kernel` (launched by `_conv_bwd_dw_pallas`):
//   dW[ky,kx] = sum over output pixels of x_pro(tap ky,kx)^T . dy_t
// with x_pro and dy_t recomputed as in K1 and K2, accumulated in fp32 and
// cast to w's type.
//
// K2 design: an implicit GEMM with M = N*H*W input pixels, N = Ci and
// K = taps*Co. An input pixel (h, w) receives tap (ky, kx) only when
// (h + pad - ky) and (w + pad - kx) are multiples of the stride, so the
// pixels are split into stride^2 phases (h % s, w % s), one grid plane
// each, and a phase walks only its own taps: no work on taps that never
// meet (a stride-2 conv would otherwise waste 3/4 of its products). The A
// tile is dy_t, folded while it is staged into shared memory; B is the
// weight of one tap read as (Co, Ci). The epilogue adds g, recomputes the
// prologue's mask from x (and r), writes dx (and dr) and the per-channel
// partial sums of the block; a second pass adds the partials in a fixed
// order.
// K3 design: a GEMM with M = kh*kw*Ci, N = Co and the long K = N*Ho*Wo
// (100,352 at stage 1 of ResNet-50 at B=32), so K is split over the grid's
// third dimension into as many ranges as fill the card; each block writes
// an fp32 partial dW and a second pass adds the splits in order and casts
// (deterministic, no atomics). A block's rows are 64 channels of one tap.
//
// What bounds them: the same FLOPs as the forward, 2*N*Ho*Wo*kh*kw*Ci*Co
// each, against a few bytes per FLOP: the card's arithmetic, here scalar
// fp32 FMAs in 64x64 tiles (4x4 per thread), not tensor cores.

#include "conv_common.cuh"

namespace {

using namespace mxconv;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                   const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ ds,
                   const float* __restrict__ dss, const T* __restrict__ r,
                   const float* __restrict__ ar,
                   const float* __restrict__ br, const T* __restrict__ g,
                   T* __restrict__ dx, T* __restrict__ dr,
                   float* __restrict__ part, long long part_rows, Shape sh,
                   int relu) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  __shared__ float red[3][16][kBN];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int s = sh.stride;
  const int ry = blockIdx.z / s, rx = blockIdx.z % s;
  const int hq = ry < sh.H ? (sh.H - ry + s - 1) / s : 0;
  const int wq = rx < sh.W ? (sh.W - rx + s - 1) / s : 0;
  const long long Mp = (long long)sh.N * hq * wq;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bool has_pro = a != nullptr;
  const bool has_res = r != nullptr;
  const bool pro = has_pro || has_res;

  // the taps of this phase: ky = ky0 + s*t, t < nky (same for kx)
  const int ky0 = (ry + sh.pad) % s, kx0 = (rx + sh.pad) % s;
  const int nky = ky0 < sh.KH ? (sh.KH - 1 - ky0) / s + 1 : 0;
  const int nkx = kx0 < sh.KW ? (sh.KW - 1 - kx0) / s + 1 : 0;
  const int chunks = (sh.Co + kBK - 1) / kBK;
  const int nsteps = nky * nkx * chunks;

  // A loader: one input pixel of the phase per 4 threads, Co slots ak+4j
  const int am = tid >> 2, ak = tid & 3;
  const long long arow = m0 + am;
  const bool arow_ok = arow < Mp;
  int an = 0, ai = 0, aj = 0;
  if (arow_ok) {
    long long q = arow;
    aj = (int)(q % wq);
    q /= wq;
    ai = (int)(q % hq);
    an = (int)(q / hq);
  }
  // B loader: one input channel per 4 threads, Co slots bk + 4*j
  const int bn = tid >> 2, bk = tid & 3;

  float dya[4], ya[4], wb[4];
  bool va[4];

  auto load = [&](int t, int c0) {
    const int ty_ = t / nkx, tx_ = t - (t / nkx) * nkx;
    const int ky = ky0 + s * ty_, kx = kx0 + s * tx_;
    const int ho = ai + (ry + sh.pad - ky) / s;
    const int wo = aj + (rx + sh.pad - kx) / s;
    const bool pix =
        arow_ok && ho >= 0 && ho < sh.Ho && wo >= 0 && wo < sh.Wo;
    const long long base =
        (((long long)an * sh.Ho + ho) * sh.Wo + wo) * sh.Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + ak + 4 * j;
      va[j] = pix && co < sh.Co;
      dya[j] = va[j] ? Elem<T>::ld(dy + base + co) : 0.0f;
      ya[j] = va[j] ? Elem<T>::ld(y + base + co) : 0.0f;
    }
    const int ci = n0 + bn;
    const T* wrow = w + ((long long)(ky * sh.KW + kx) * sh.Ci + ci) * sh.Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + bk + 4 * j;
      wb[j] = (ci < sh.Ci && co < sh.Co) ? Elem<T>::ld(wrow + co) : 0.0f;
    }
  };

  auto store = [&](int c0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + ak + 4 * j;
      As[ak + 4 * j][am] =
          va[j] ? Elem<T>::round(fold_cotangent(dya[j], ya[j], ds[co], dss[co]))
                : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[bk + 4 * j][bn] = wb[j];
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  int t = 0, c0 = 0;
  if (nsteps > 0) load(0, 0);
  for (int step = 0; step < nsteps; ++step) {
    store(c0);
    __syncthreads();
    c0 += kBK;
    if (c0 >= sh.Co) {
      c0 = 0;
      ++t;
    }
    if (step + 1 < nsteps) load(t, c0);
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }

  // epilogue: + g, the prologue's mask, dx (dr), partial da/db/dar
  float sa[4] = {0, 0, 0, 0}, sb[4] = {0, 0, 0, 0}, sr[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= Mp) continue;
    long long q = m;
    const int j_ = (int)(q % wq);
    q /= wq;
    const int i_ = (int)(q % hq);
    const int n_ = (int)(q / hq);
    const long long pix =
        ((long long)n_ * sh.H + ry + s * i_) * sh.W + rx + s * j_;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ci = n0 + tx * 4 + jj;
      if (ci >= sh.Ci) continue;
      const long long off = pix * sh.Ci + ci;
      float v = acc[i][jj];
      if (g != nullptr) v = __fadd_rn(v, Elem<T>::ld(g + off));
      if (!pro) {
        Elem<T>::st(dx + off, v);
        continue;
      }
      const float xv = Elem<T>::ld(x + off);
      const float rv = has_res ? Elem<T>::ld(r + off) : 0.0f;
      const float av = has_pro ? a[ci] : 1.0f;
      const float lin =
          prologue_lin(xv, av, has_pro ? b[ci] : 0.0f, has_res, rv,
                       has_res ? ar[ci] : 0.0f, has_res ? br[ci] : 0.0f);
      const float dxf = (relu && !(lin > 0.0f)) ? 0.0f : v;
      Elem<T>::st(dx + off, __fmul_rn(dxf, av));
      if (has_res) Elem<T>::st(dr + off, __fmul_rn(dxf, ar[ci]));
      sa[jj] += dxf * xv;
      sb[jj] += dxf;
      sr[jj] += dxf * rv;
    }
  }
  if (!pro) return;  // uniform over the block: no sums to take
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    red[0][ty][tx * 4 + jj] = sa[jj];
    red[1][ty][tx * 4 + jj] = sb[jj];
    red[2][ty][tx * 4 + jj] = sr[jj];
  }
  __syncthreads();
  if (tid < 3 * kBN) {
    const int which = tid / kBN, c = tid % kBN;
    const int col = n0 + c;
    float tot = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) tot += red[which][k][c];
    const long long row = (long long)blockIdx.z * gridDim.x + blockIdx.x;
    if (col < sh.Ci)
      part[((long long)which * part_rows + row) * sh.Ci + col] = tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ y, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ ds,
                   const float* __restrict__ dss, const T* __restrict__ r,
                   const float* __restrict__ ar,
                   const float* __restrict__ br, float* __restrict__ part,
                   Shape sh, int relu, int ksplit) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int cib = (sh.Ci + kBM - 1) / kBM;
  const int tap = blockIdx.x / cib;
  const int ci0 = (blockIdx.x - tap * cib) * kBM;
  const int ky = tap / sh.KW, kx = tap - ky * sh.KW;
  const int n0 = blockIdx.y * kBN;
  const bool has_pro = a != nullptr;
  const bool has_res = r != nullptr;
  const bool pro = has_pro || has_res;

  const long long P = (long long)sh.N * sh.Ho * sh.Wo;
  const long long k_begin = (long long)blockIdx.z * ksplit;
  const long long k_end = k_begin + ksplit < P ? k_begin + ksplit : P;
  const int nsteps =
      k_end > k_begin ? (int)((k_end - k_begin + kBK - 1) / kBK) : 0;

  // loaders: one output pixel per 16 threads, channels lc + 16*j
  const int lk = tid >> 4, lc = tid & 15;
  float xa[4], ra[4], dya[4], ya[4];
  bool vx[4], vy[4];

  auto load = [&](long long k0) {
    const long long p = k0 + lk;
    bool pok = p < k_end;
    int n_ = 0, ho = 0, wo = 0;
    if (pok) {
      long long q = p;
      wo = (int)(q % sh.Wo);
      q /= sh.Wo;
      ho = (int)(q % sh.Ho);
      n_ = (int)(q / sh.Ho);
    }
    const int hi = ho * sh.stride - sh.pad + ky;
    const int wi = wo * sh.stride - sh.pad + kx;
    const bool pix = pok && hi >= 0 && hi < sh.H && wi >= 0 && wi < sh.W;
    const long long xbase =
        (((long long)n_ * sh.H + hi) * sh.W + wi) * sh.Ci;
    const long long ybase = p * sh.Co;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + lc + 16 * j;
      vx[j] = pix && ci < sh.Ci;
      xa[j] = vx[j] ? Elem<T>::ld(x + xbase + ci) : 0.0f;
      ra[j] = (vx[j] && has_res) ? Elem<T>::ld(r + xbase + ci) : 0.0f;
      const int co = n0 + lc + 16 * j;
      vy[j] = pok && co < sh.Co;
      dya[j] = vy[j] ? Elem<T>::ld(dy + ybase + co) : 0.0f;
      ya[j] = vy[j] ? Elem<T>::ld(y + ybase + co) : 0.0f;
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + lc + 16 * j;
      float v = 0.0f;
      if (vx[j]) {
        v = xa[j];
        if (pro) {
          v = prologue_lin(v, has_pro ? a[ci] : 1.0f, has_pro ? b[ci] : 0.0f,
                           has_res, ra[j], has_res ? ar[ci] : 0.0f,
                           has_res ? br[ci] : 0.0f);
          if (relu) v = v > 0.0f ? v : 0.0f;
          v = Elem<T>::round(v);
        }
      }
      As[lk][lc + 16 * j] = v;
      const int co = n0 + lc + 16 * j;
      Bs[lk][lc + 16 * j] =
          vy[j] ? Elem<T>::round(fold_cotangent(dya[j], ya[j], ds[co], dss[co]))
                : 0.0f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (nsteps > 0) load(k_begin);
  for (int step = 0; step < nsteps; ++step) {
    store();
    __syncthreads();
    if (step + 1 < nsteps) load(k_begin + (long long)(step + 1) * kBK);
    tile_product(As, Bs, acc, ty, tx);
    __syncthreads();
  }

  const long long plane = (long long)sh.KH * sh.KW * sh.Ci * sh.Co;
  float* out = part + (long long)blockIdx.z * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= sh.Ci) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < sh.Co) out[((long long)tap * sh.Ci + ci) * sh.Co + co] = acc[i][j];
    }
  }
}

template <typename T>
int launch_dx(const void* dy, const void* y, const void* x, const void* w,
              const float* a, const float* b, const float* ds,
              const float* dss, const void* r, const float* ar,
              const float* br, const void* g, void* dx, float* da, float* db,
              void* dr, float* dar, float* part, Shape sh, int relu,
              cudaStream_t stream) {
  const int s = sh.stride;
  const int hq = (sh.H + s - 1) / s, wq = (sh.W + s - 1) / s;
  const long long Mp = (long long)sh.N * hq * wq;  // the largest phase
  const int mtiles = (int)((Mp + kBM - 1) / kBM);
  const int ntiles = (sh.Ci + kBN - 1) / kBN;
  const long long part_rows = (long long)s * s * mtiles;
  conv_bwd_dx_kernel<T><<<dim3(mtiles, ntiles, s * s), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(x), static_cast<const T*>(w), a, b, ds, dss,
      static_cast<const T*>(r), ar, br, static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(dr), part, part_rows, sh, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a != nullptr || r != nullptr) {
    const long long plane = part_rows * sh.Ci;
    if (da != nullptr) column_sum(part, (int)part_rows, sh.Ci, da, stream);
    if (db != nullptr)
      column_sum(part + plane, (int)part_rows, sh.Ci, db, stream);
    if (dar != nullptr)
      column_sum(part + 2 * plane, (int)part_rows, sh.Ci, dar, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* dy, const void* y, const float* a,
              const float* b, const float* ds, const float* dss,
              const void* r, const float* ar, const float* br, void* dw,
              float* part, int splits, Shape sh, int relu,
              cudaStream_t stream) {
  const long long P = (long long)sh.N * sh.Ho * sh.Wo;
  const long long steps = (P + kBK - 1) / kBK;
  const int ksplit = (int)(((steps + splits - 1) / splits) * kBK);
  const int cib = (sh.Ci + kBM - 1) / kBM;
  const int ntiles = (sh.Co + kBN - 1) / kBN;
  conv_bwd_dw_kernel<T><<<dim3(sh.KH * sh.KW * cib, ntiles, splits),
                          kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), a, b, ds, dss, static_cast<const T*>(r), ar,
      br, part, sh, relu, ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cols = (long long)sh.KH * sh.KW * sh.Ci * sh.Co;
  const long long blocks = (cols + 255) / 256;
  split_sum_kernel<T><<<(int)(blocks < 65535 ? blocks : 65535), 256, 0,
                        stream>>>(part, splits, cols, static_cast<T*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

// dy, y: (N,Ho,Wo,Co); x, r, g, dx, dr: (N,H,W,Ci), all in the dtype (0
// fp32, 1 bf16); w: HWIO; a, b, ar, br, da, db, dar: fp32 (Ci,); ds, dss:
// fp32 (Co,). a == NULL and r == NULL: no prologue (dx unmasked, da, db,
// dar untouched); g == NULL: no emitted activation. part: scratch of
// 3 * stride^2 * ceil(N*ceil(H/s)*ceil(W/s) / 64) * Ci floats.
extern "C" int mxtpu_conv_bwd_dx(
    const void* dy, const void* y, const void* x, const void* w,
    const float* a, const float* b, const float* ds, const float* dss,
    const void* r, const float* ar, const float* br, const void* g, void* dx,
    float* da, float* db, void* dr, float* dar, float* part, int N, int H,
    int W, int Ci, int Co, int KH, int KW, int stride, int pad, int Ho, int Wo,
    int relu, int dtype, void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx<float>(dy, y, x, w, a, b, ds, dss, r, ar, br, g, dx, da,
                            db, dr, dar, part, sh, relu, st);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(dy, y, x, w, a, b, ds, dss, r, ar, br, g,
                                    dx, da, db, dr, dar, part, sh, relu, st);
  return (int)cudaErrorInvalidValue;
}

// x, r: (N,H,W,Ci); dy, y: (N,Ho,Wo,Co); dw: HWIO, all in the dtype. part:
// scratch of splits * KH*KW*Ci*Co floats; the N*Ho*Wo pixels are cut into
// `splits` ranges of whole 16-pixel steps.
extern "C" int mxtpu_conv_bwd_dw(
    const void* x, const void* dy, const void* y, const float* a,
    const float* b, const float* ds, const float* dss, const void* r,
    const float* ar, const float* br, void* dw, float* part, int splits,
    int N, int H, int W, int Ci, int Co, int KH, int KW, int stride, int pad,
    int Ho, int Wo, int relu, int dtype, void* stream) {
  const Shape sh{N, H, W, Ci, Co, KH, KW, Ho, Wo, stride, pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dw<float>(x, dy, y, a, b, ds, dss, r, ar, br, dw, part,
                            splits, sh, relu, st);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, dy, y, a, b, ds, dss, r, ar, br, dw,
                                    part, splits, sh, relu, st);
  return (int)cudaErrorInvalidValue;
}
