// The generic Hopper (sm_90a) pieces of the port's tensor-core kernels:
// the PTX of the mbarrier ring, TMA loads and wgmma products (A from shared
// memory or from registers), the shared-memory matrix descriptor of the
// 128-byte swizzle, and, on the host, the TMA tensor maps
// (cuTensorMapEncodeTiled through the runtime's driver entry point: no
// -lcuda) and the opt-in to more than 48 KB of dynamic shared memory.
// tc_common.cuh (the conv kernels) and flash_bwd_tc.cu include it.
//
// Every tile the kernels stage is 64 rows of 64 bf16 (128 bytes) under
// TMA's 128-byte swizzle: the 16-byte chunk q of row r holds the elements
// (q ^ r % 8) * 8 .. + 7, and 8-row groups are 1024 bytes apart.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mxhop {

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// of more than about ten seconds (2^34 cycles) is a fault (a load that
// never lands): the kernel traps, and the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Ordinary stores to shared memory become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The consumer warpgroup's own barrier (the producer warp never joins).
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a tile under the 128-byte swizzle:
// 8-row groups of 128-byte rows, `sbo` bytes apart. `lbo` is the stride
// between 64-element blocks of an MN-major operand (unused by the 64-wide
// and the K-major operands here).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

// d += A (64x16) . B (16xN), bf16 in, fp32 accumulate, both operands from
// shared memory; TA/TB = 1: the operand is MN-major there (else K-major).
// d[4*j + 2*h + c] is row 16*warp + lane/4 + 8*h, column 8*j +
// 2*(lane%4) + c.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

// d += A (64x16, registers) . B (16xN, shared memory), bf16 in, fp32
// accumulate; TB = 1: B is MN-major there. A's fragment has the layout of
// an m64 accumulator's 16 columns, two bf16 to a register (the lower
// column in the low half): a[0] = row 16*warp + lane/4, columns 2*(lane%4)
// + {0, 1}; a[1] the same 8 rows down; a[2] and a[3] those 8 columns on.
// So the fragment of an accumulator d's k-step s (its columns 16s..16s+15)
// is the pairs (d[8s], d[8s+1]), (d[8s+2], d[8s+3]), (d[8s+4], d[8s+5]),
// (d[8s+6], d[8s+7]): see pack_a.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BN == 64)
    wgmma_rs_n64<TB>(d, a, db);
  else
    wgmma_rs_n128<TB>(d, a, db);
}

// Two fp32 rounded to bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A fragment of k-step S (columns 16S..16S+15) of an m64
// accumulator d, rounded to bf16 (see wgmma_rs_n64).
template <int S, int R>
__device__ __forceinline__ void pack_a(const float (&d)[R], uint32_t (&a)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    a[q] = pack_bf16(d[8 * S + 2 * q], d[8 * S + 2 * q + 1]);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// host: tensor maps, shared memory
// ---------------------------------------------------------------------------
// An error of the tensor-map encoder is returned as kMapError + its
// CUresult, so the caller can tell it from a CUDA runtime error.
constexpr int kMapError = 10000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A libcuda function, looked up through the runtime: no -lcuda (nullptr
// if absent).
inline void* cuda_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                                &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

// cuTensorMapEncodeTiled from libcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(cuda_entry("cuTensorMapEncodeTiled"));
  return fn;
}

// Make the current device's primary context current on this thread if no
// context is. cuTensorMapEncodeTiled needs a current context, which the
// runtime binds to a thread only at its first call that needs one: a
// thread whose first CUDA work is an encode (a backward on torch's
// autograd thread, say) has none. libcuda calls only: the runtime's way
// to bind one (cudaFree(nullptr)) is refused while a stream of the
// process is being captured into a CUDA graph, and such a thread may meet
// its first encode inside a capture. Returns 0 or kMapError + the
// CUresult.
inline int bind_context() {
  using GetCurrent = CUresult (*)(CUcontext*);
  using SetCurrent = CUresult (*)(CUcontext);
  using DeviceGet = CUresult (*)(CUdevice*, int);
  using Retain = CUresult (*)(CUcontext*, CUdevice);
  static const GetCurrent get_current =
      reinterpret_cast<GetCurrent>(cuda_entry("cuCtxGetCurrent"));
  static const SetCurrent set_current =
      reinterpret_cast<SetCurrent>(cuda_entry("cuCtxSetCurrent"));
  static const DeviceGet device_get =
      reinterpret_cast<DeviceGet>(cuda_entry("cuDeviceGet"));
  static const Retain retain =
      reinterpret_cast<Retain>(cuda_entry("cuDevicePrimaryCtxRetain"));
  static thread_local bool bound = false;
  if (bound) return 0;
  if (!get_current || !set_current || !device_get || !retain)
    return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  CUcontext ctx = nullptr;
  CUresult r = get_current(&ctx);
  if (r == CUDA_SUCCESS && ctx == nullptr) {
    int ordinal = 0;
    const cudaError_t e = cudaGetDevice(&ordinal);
    if (e != cudaSuccess) return (int)e;
    CUdevice dev;
    r = device_get(&dev, ordinal);
    if (r == CUDA_SUCCESS) r = retain(&ctx, dev);
    if (r == CUDA_SUCCESS) r = set_current(ctx);
  }
  if (r != CUDA_SUCCESS) return kMapError + (int)r;
  bound = true;
  return 0;
}

// A bf16 tensor (or one of `dtype`) of `rank` dims (innermost first,
// dims[0] contiguous) whose dims 1.. lie `strides[0..rank-2]` bytes apart
// (multiples of 16), in boxes of `box` under the 128-byte swizzle, zero
// fill outside it.
inline int encode(CUtensorMap* map, const void* base, int rank,
                  const uint64_t* dims, const uint64_t* strides,
                  const uint32_t* box, const uint32_t* estride,
                  CUtensorMapDataType dtype =
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  if (const int err = bind_context()) return err;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], es[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    es[i] = estride[i];
    if (i + 1 < rank) gstride[i] = strides[i];
  }
  const CUresult res = fn(
      map, dtype, rank, const_cast<void*>(base),
      gdim, gstride, bdim, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapError + (int)res;
}

// Opt `kernel` in to `bytes` of dynamic shared memory, once (`done`).
inline int allow_smem(const void* kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = e == cudaSuccess;
  return (int)e;
}

}  // namespace mxhop
