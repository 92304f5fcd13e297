// What the flash-attention kernels for Hopper (sm_90a) share: 16-bit
// packing, mbarriers, TMA loads and tensor maps, wgmma descriptors and
// products, and the launch helpers.  Included by flash_attn_fwd.cu and
// flash_attn_bwd.cu; kernels.load hashes this file into both libraries'
// names, so a change here rebuilds both.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBox = 64;  // columns per TMA box: one 128-byte row

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrives only where `pred` holds, without a branch.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

// Waits for the phase of parity `parity` to complete.  A transfer that
// never lands would hang the card; after about ten seconds of waiting
// the kernel traps instead, which fails the launch.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// One box of a [BH, S, D] tensor map, dims innermost first (d, s, bh),
// into shared memory; completion is counted on `bar` in bytes.  Rows
// past S are zero-filled by the hardware and never read the next head.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int d, int s,
                                            int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(s), "r"(bh)
      : "memory");
}

// wgmma descriptor of a tile stored with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes: the
// compiler may not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define HVD_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HVD_F32(d) HVD_F8(d, 0), HVD_F8(d, 8), HVD_F8(d, 16), HVD_F8(d, 24)
#define HVD_F64(d) \
  HVD_F32(d), HVD_F8(d, 32), HVD_F8(d, 40), HVD_F8(d, 48), HVD_F8(d, 56)

#define HVD_REGS32                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "    \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "     \
  "%26, %27, %28, %29, %30, %31}"
#define HVD_REGS64                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "    \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "     \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "     \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "     \
  "%62, %63}"

// d (64 x N, fp32) = A . B (+ d when scale_d), A and B K-major in
// shared memory.
#define HVD_WGMMA_SS_N64(TY, d, da, db, scale_d)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY   \
               " " HVD_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"          \
               : HVD_F32(d)                                              \
               : "l"(da), "l"(db), "r"(scale_d))
#define HVD_WGMMA_SS_N128(TY, d, da, db, scale_d)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
               " " HVD_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"          \
               : HVD_F64(d)                                              \
               : "l"(da), "l"(db), "r"(scale_d))

// d (64 x N, fp32) += A . B, A from registers, B MN-major in shared
// memory (transpose flag set).
#define HVD_WGMMA_RS_N64(TY, d, a, db)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY   \
               " " HVD_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : HVD_F32(d)                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                 "r"(1))
#define HVD_WGMMA_RS_N128(TY, d, a, db)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
               " " HVD_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : HVD_F64(d)                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),    \
                 "r"(1))

// d (64 x 64) = A . B^T (+ d when scale_d), both K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_SS_N64("bf16", d, da, db, scale_d);
  } else {
    HVD_WGMMA_SS_N64("f16", d, da, db, scale_d);
  }
}

// d (64 x D) += A . B, A from registers and B MN-major.
template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      HVD_WGMMA_RS_N64("bf16", d, a, db);
    } else {
      HVD_WGMMA_RS_N64("f16", d, a, db);
    }
  } else {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      HVD_WGMMA_RS_N128("bf16", d, a, db);
    } else {
      HVD_WGMMA_RS_N128("f16", d, a, db);
    }
  }
}

// A score tile (an m64nN accumulator, N = 8 KSTEPS), rounded to the
// input type, in the wgmma A-fragment layout: k-step kk covers columns
// 16 kk .. 16 kk + 15, accumulator blocks 2 kk and 2 kk + 1.
template <typename T, int KSTEPS>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[KSTEPS][4],
                                       const float (&sc)[8 * KSTEPS]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack2<T>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// ---------------------------------------------------------------------------
// launch helpers (host)
// ---------------------------------------------------------------------------

// Raises a kernel's dynamic shared-memory limit once per device (the
// attribute lives in the device's context), not on every launch.
template <typename K>
int allow_smem(K kernel, size_t bytes, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

// The current device's SM count, read once per device.
int sm_count(int* count) {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*count = counts[dev].load(std::memory_order_relaxed)))
    return cudaSuccess;
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64)
    counts[dev].store(*count, std::memory_order_relaxed);
  return err;
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up once through the runtime so that
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [bh, rows, D] tensor as a 3-D map (d, rows, bh) read in boxes of
// 64 columns x box_rows rows with the 128-byte swizzle that wgmma reads.
template <typename T, int D>
bool encode_bsd(CUtensorMap* map, const void* ptr, int bh, int rows,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)rows * D * sizeof(T)};
  const cuuint32_t box[3] = {kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
