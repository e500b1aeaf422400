// The softmax cross-entropy pair of upstream MXNet's
// example/numpy-ops/custom_softmax_rtc.py, used by the CustomOp
// "softmax_ce_rtc" (ops/rtc_kernels.py). Compiled at run time by
// mx.rtc.CudaModule (NVRTC, sm_90a); the launcher names the template
// instances "softmax_ce_fwd<float>" and "softmax_ce_bwd<float>" in
// `exports`, so they are found through NVRTC's lowered names. Only the
// float instances exist.
//
// They are launched through mx.rtc, the port of rtc.py:66
// `PallasKernel._launch_fn`. Both are bound by bytes: the forward reads
// the logits once and writes the probabilities once, the backward reads
// the probabilities once and writes the gradient once (823.4 MB each at
// (2048, 50257) fp32, at least 0.246 ms each at 3.35 TB/s).
//
// The forward, one block per row, takes one of two branches, chosen by
// the launch: the row is resident when the dynamic shared memory it was
// given holds 16 * ceil((row_size + 3) / 4) bytes (ops/rtc_kernels.py
// `softmax_ce_fwd_plan` asks for that much when the card's opt-in limit,
// less the kernel's 192 bytes of static shared memory, allows it: rows up
// to 58,061 floats on an H100), and streamed otherwise, as with no
// dynamic shared memory at all: any launch is right.
// - Resident: the row is read from device memory once, into shared
//   memory, by 1-D bulk copies (cp.async.bulk, TMA) in ROW_CHUNKS chunks,
//   each on its own mbarrier, so the max of a chunk runs while the later
//   ones land. Element i sits at shared float px + i, px being the row's
//   4-float alignment phase in x: the 16-byte aligned middle of the row
//   lands on 16-byte aligned shared quads, and the at most two partial
//   quads at the ends are filled by plain loads, padded with -inf. The
//   sum pass stores e = exp(x - max) back in place (one exponential per
//   element); the write pass stores e * (1 / sum) with 16-byte stores,
//   four a thread a step, when y has x's phase, and with scalar stores
//   when it does not (a view at another offset).
// - Streamed (longer rows): one read with a running max and a rescaled
//   sum, then a second read that writes: two reads and one write.
// The kernel this replaces read its row three times, assuming the second
// and third reads hit L2; on the card they did not. On an NVIDIA H100
// 80GB HBM3 at 700 W (tools/torch_rtc_times.py, both in one run) it took
// 0.771 ms at (2048, 50257); this one takes 0.288 (torch.softmax 0.532,
// the byte bound 0.246), and 0.113 at (256, 100003) (torch.softmax
// 0.147). A block of the path's shape spends 17.8 us: 7.4 loading and
// taking the max, 3.1 on the exponentials, 5.3 writing
// (tools/torch_rtc_designs.py).
//
// Block reductions go through shared memory (one slot per warp) in a
// fixed order, with no atomics: repeated launches are bit-identical.
// req follows MXNet: 1 writes, 2 adds, 0 leaves y alone. A row of -inf
// gives NaN, as torch.softmax does.

#define ROW_CHUNKS 8    // bulk copies (and mbarriers) per resident row

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's reduction of v, broadcast to every thread. blockDim.x is a
// multiple of 32, at most 1024; `slots` holds 32 floats.
template <bool kMax>
__device__ float block_reduce(float v, float *slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                       // slots free from any earlier use
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  v = lane < warps ? slots[lane] : (kMax ? neg_inf() : 0.f);
  return kMax ? warp_max(v) : warp_sum(v);
}

// -- shared memory, mbarriers and 1-D bulk copies (PTX) ----------------------
__device__ __forceinline__ unsigned smem_u32(const void *p) {
  unsigned a;
  asm("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
      : "=r"(a) : "l"(p));
  return a;
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned r;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned long long *bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u) : "memory");
}

// One arrival that also expects `bytes` from bulk copies (0: none).
__device__ __forceinline__ void mbar_expect_tx(unsigned long long *bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the barrier's first phase. A wait of more than about ten
// seconds (2^34 cycles) is a copy that never lands: trap, so the launch
// fails instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long *bar) {
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) asm volatile("trap;");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void *dst, const void *src,
                                          unsigned bytes,
                                          unsigned long long *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int phase_of(const float *p) {
  return (int)((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

__device__ __forceinline__ void put(float *y, float p, int req) {
  *y = req == 2 ? *y + p : p;
}

__device__ __forceinline__ float4 scaled(float4 v, float r) {
  return make_float4(v.x * r, v.y * r, v.z * r, v.w * r);
}

__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// -- resident rows: one read, one write ---------------------------------------
// Partial quad j of the row in shared memory (the first and the last quad,
// when they are not wholly inside the row): its shared float index, or -1
// for a thread with none. Threads 0-3 take quad 0, threads 4-7 quad nq - 1.
__device__ __forceinline__ int partial_slot(int nq, int q0, int q1) {
  const int t = threadIdx.x;
  if (t >= 8 || (t >= 4 && nq <= 1)) return -1;
  const int q = t < 4 ? 0 : nq - 1;
  return (q >= q0 && q < q1) ? -1 : 4 * q + (t & 3);
}

__device__ void softmax_resident(const float *xr, float *yr, int n, int req,
                                 float *slots, unsigned long long *bars,
                                 float4 *row4) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float *row = reinterpret_cast<float *>(row4);
  const int px = phase_of(xr);
  const int nq = (px + n + 3) >> 2;        // quads holding the row
  const int q0 = px ? 1 : 0;               // the full quads: [q0, q1)
  const int q1 = (px + n) >> 2;
  if (tid == 0) {
    for (int c = 0; c < ROW_CHUNKS; ++c) mbar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int slot = partial_slot(nq, q0, q1);
  if (slot >= 0) {
    const int i = slot - px;
    row[slot] = (i >= 0 && i < n) ? xr[i] : neg_inf();
  }
  __syncthreads();                         // barriers and end quads ready
  if (tid == 0) {
    for (int c = 0; c < ROW_CHUNKS; ++c) {
      const int lo = max((int)((long long)nq * c / ROW_CHUNKS), q0);
      const int hi = min((int)((long long)nq * (c + 1) / ROW_CHUNKS), q1);
      const unsigned bytes = hi > lo ? 16u * (hi - lo) : 0u;
      mbar_expect_tx(&bars[c], bytes);
      if (bytes) bulk_load(&row4[lo], xr + 4 * lo - px, bytes, &bars[c]);
    }
  }
  // the max, chunk by chunk as the copies land
  float m = neg_inf();
  for (int c = 0; c < ROW_CHUNKS; ++c) {
    const int lo = (int)((long long)nq * c / ROW_CHUNKS);
    const int hi = (int)((long long)nq * (c + 1) / ROW_CHUNKS);
    mbar_wait(&bars[c]);
    for (int q = lo + tid; q < hi; q += nt) m = fmaxf(m, max4(row4[q]));
  }
  m = block_reduce<true>(m, slots);
  // e = exp(x - max) in place, and its sum (the -inf pads add 0)
  float s = 0.f;
  for (int q = tid; q < nq; q += nt) {
    float4 v = row4[q];
    v.x = expf(v.x - m); v.y = expf(v.y - m);
    v.z = expf(v.z - m); v.w = expf(v.w - m);
    row4[q] = v;
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float r = 1.f / block_reduce<false>(s, slots);
  if (phase_of(yr) == px) {
    // four 16-byte stores a thread a step, after their four loads of y
    // with req 2 (one store a step made the write pass several times
    // slower: PERF.md)
    float4 *y4 = reinterpret_cast<float4 *>(yr + (4 - px) % 4);  // quad q0
    for (int q = q0 + tid; q < q1; q += 4 * nt) {
      float4 o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (req == 2 && q + k * nt < q1) o[k] = y4[q + k * nt - q0];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (q + k * nt >= q1) break;
        const float4 p = scaled(row4[q + k * nt], r);
        y4[q + k * nt - q0] = req == 2 ? plus(o[k], p) : p;
      }
    }
    if (slot >= 0 && slot - px >= 0 && slot - px < n)
      put(yr + slot - px, row[slot] * r, req);
  } else {
    for (int i = tid; i < n; i += nt) put(yr + i, row[i + px] * r, req);
  }
}

// -- streamed rows: two reads, one write ---------------------------------------
// Fold one value block into a running (max, sum of exp(x - max)).
__device__ __forceinline__ void fold(float &m, float &s, float mq) {
  if (mq > m) {                // m = -inf: s is 0 and stays 0
    s *= expf(m - mq);
    m = mq;
  }
}

__device__ __forceinline__ float base_of(float m) {
  return m == neg_inf() ? 0.f : m;   // no -inf - -inf while all seen are -inf
}

__device__ void softmax_streamed(const float *xr, float *yr, int n, int req,
                                 float *slots) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int h = min(n, (4 - phase_of(xr)) & 3);     // head before 16 bytes
  const int n4 = (n - h) >> 2;                       // aligned quads
  const int t0 = h + 4 * n4;                         // the tail, < 4 floats
  const float4 *x4 = reinterpret_cast<const float4 *>(xr + h);
  float m = neg_inf(), s = 0.f;
  if (tid < h) { fold(m, s, xr[tid]); s += expf(xr[tid] - base_of(m)); }
  if (tid < n - t0) {
    const float v = xr[t0 + tid];
    fold(m, s, v);
    s += expf(v - base_of(m));
  }
#pragma unroll 4
  for (int q = tid; q < n4; q += nt) {
    const float4 v = x4[q];
    fold(m, s, max4(v));
    const float b = base_of(m);
    s += (expf(v.x - b) + expf(v.y - b)) + (expf(v.z - b) + expf(v.w - b));
  }
  const float mx = block_reduce<true>(m, slots);
  const float r = 1.f / block_reduce<false>(s * expf(m - mx), slots);
  if (phase_of(yr) == phase_of(xr)) {
    if (tid < h) put(yr + tid, expf(xr[tid] - mx) * r, req);
    if (tid < n - t0) put(yr + t0 + tid, expf(xr[t0 + tid] - mx) * r, req);
    // four loads of x (and of y with req 2) ahead of four stores
    float4 *y4 = reinterpret_cast<float4 *>(yr + h);
    for (int q = tid; q < n4; q += 4 * nt) {
      float4 v[4], o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (q + k * nt >= n4) break;
        v[k] = x4[q + k * nt];
        if (req == 2) o[k] = y4[q + k * nt];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (q + k * nt >= n4) break;
        const float4 e = v[k];
        const float4 p = make_float4(expf(e.x - mx) * r, expf(e.y - mx) * r,
                                     expf(e.z - mx) * r, expf(e.w - mx) * r);
        y4[q + k * nt] = req == 2 ? plus(o[k], p) : p;
      }
    }
  } else {
    for (int i = tid; i < n; i += nt) put(yr + i, expf(xr[i] - mx) * r, req);
  }
}

// Up to 1024 threads a block (a resident row takes them all): at most 64
// registers a thread.
template <class DType>
__global__ void __launch_bounds__(1024)
softmax_ce_fwd(const DType *x, DType *y, const int row_size, const int req) {
  static_assert(sizeof(DType) == sizeof(float), "float rows only");
  __shared__ float slots[32];                     // one a warp
  __shared__ unsigned long long bars[ROW_CHUNKS];
  extern __shared__ __align__(16) float4 row4[];  // a resident row
  if (req == 0) return;
  const float *xr = reinterpret_cast<const float *>(x)
                    + (long long)blockIdx.x * row_size;
  float *yr = reinterpret_cast<float *>(y) + (long long)blockIdx.x * row_size;
  if (16 * (((long long)row_size + 6) >> 2) <= dynamic_smem_bytes())
    softmax_resident(xr, yr, row_size, req, slots, bars, row4);
  else
    softmax_streamed(xr, yr, row_size, req, slots);
}

// dx = y - onehot(label): the gradient of the summed cross entropy
// through the softmax. A label outside [0, row_size) subtracts nothing.
template <class DType>
__global__ void softmax_ce_bwd(const int *label, const DType *y, DType *dx,
                               const int row_size, const int req) {
  if (req == 0) return;
  const long long off = (long long)blockIdx.x * row_size;
  const int z = label[blockIdx.x];
  for (int i = threadIdx.x; i < row_size; i += blockDim.x) {
    const DType g = y[off + i] - (i == z ? (DType)1 : (DType)0);
    if (req == 1) dx[off + i] = g;
    else dx[off + i] += g;
  }
}
