// Fusion-buffer pack and unpack with scaling, hand-written CUDA C++ for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  On the TPU, XLA fuses the per-tensor
// prescale, the collective and the postscale of a fused response into
// one program (horovod_tpu/ops/xla_ops.py _allreduce_fn); the reference
// Horovod wrote the same data movement by hand for CUDA as
// batched_memcpy_k and scale_buffer_k / scale_buffer_half2_k
// (ops/cuda/cuda_kernels.cu).  This kernel is the port's counterpart:
// one launch copies up to kMaxEntries tensors of one dtype, each
// multiplied by one factor, between their own memory and one flat
// buffer.
//
// * Pack:   flat[o_i : o_i + n_i] = scale(t_i, prescale), and the
//           padding up to the next 16-byte offset set to zero.
// * Unpack: out_i = scale(flat[o_i : o_i + n_i], postscale).
//
// scale(x, f) is bit-equal to horovod_tpu_torch/ops/backend.py _scale
// for every dtype of common/message.py: the caller passes f already
// rounded to the dtype; fp16 and bf16 multiply in fp32 and round once
// (the product of two 16-bit floats is exact in fp32), fp32 and fp64 in
// their own type; integers multiply in fp64 and truncate toward zero
// through int64 (as PyTorch converts to uint8; the same value for every
// result in range); bool is "product != 0".  At f == 1 it is a pure copy
// of the bytes.
//
// Bound: bytes.  Each element is read once and written once, so the
// least time is 2 x bytes / 3.35 TB/s.  The design moves 16-byte vectors
// wherever source and destination are 16-byte aligned (the flat buffer's
// offsets are rounded up to 16 bytes for that) and single elements at
// ragged tails and for views at odd offsets.
//
// The entry table travels by value as a __grid_constant__ kernel
// parameter (like the reference's BatchedD2DParams): no host-to-device
// copy to order against the launch, no pinned buffer whose lifetime
// outlives the call.  Its size keeps the parameter block under 4 KB;
// the wrapper splits a longer list into several launches.  Each entry
// gets blocks in proportion to its bytes; a block finds its entry by a
// binary search over the table's prefix of block counts and strides
// over that entry.  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEntries = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// Bytes one block covers in one unrolled pass: 256 threads x 16 bytes x 4.
constexpr long long kBytesPerBlock = 16384;
constexpr int kMaxBlocksPerEntry = 2048;

struct Entry {
  const char* src;
  char* dst;
  long long n;      // elements to copy
  long long n_pad;  // elements written at dst: n, then zeros up to n_pad
};

struct Batch {
  Entry e[kMaxEntries];
  int block_start[kMaxEntries + 1];
  int count;
};

static_assert(sizeof(Batch) + 16 <= 4096,
              "the entry table must fit the 4 KB kernel parameter block");

// Unsigned storage of the element's size, for copies and zero fill.
template <int kSize> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };
template <> struct Bits<8> { using T = uint64_t; };

// The factor's type as the kernel multiplies in it.
template <typename T> struct Factor { using T_ = double; };
template <> struct Factor<float> { using T_ = float; };
template <> struct Factor<__half> { using T_ = float; };
template <> struct Factor<__nv_bfloat16> { using T_ = float; };

__device__ __forceinline__ float scale(float x, float f) {
  return __fmul_rn(x, f);
}
__device__ __forceinline__ double scale(double x, double f) {
  return __dmul_rn(x, f);
}
__device__ __forceinline__ __half scale(__half x, float f) {
  return __float2half_rn(__fmul_rn(__half2float(x), f));
}
__device__ __forceinline__ __nv_bfloat16 scale(__nv_bfloat16 x, float f) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), f));
}
__device__ __forceinline__ bool scale(bool x, double f) {
  return __dmul_rn(x ? 1.0 : 0.0, f) != 0.0;
}
template <typename I>
__device__ __forceinline__ I scale(I x, double f) {
  return static_cast<I>(static_cast<long long>(
      __dmul_rn(static_cast<double>(x), f)));
}

// Scales the kVec elements of one 16-byte vector in place.
template <typename T>
__device__ __forceinline__ void scale_vec(uint4& raw,
                                          typename Factor<T>::T_ f) {
  constexpr int kVec = 16 / sizeof(T);
  alignas(16) T v[kVec];
  *reinterpret_cast<uint4*>(v) = raw;
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = scale(v[j], f);
  raw = *reinterpret_cast<const uint4*>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scaled_copy_kernel(const __grid_constant__ Batch batch,
                       typename Factor<T>::T_ factor, int pure_copy) {
  using B = typename Bits<sizeof(T)>::T;
  const int b = blockIdx.x;
  int lo = 0, hi = batch.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Entry& e = batch.e[lo];
  const long long tid =
      static_cast<long long>(b - batch.block_start[lo]) * kThreads +
      threadIdx.x;
  const long long stride =
      static_cast<long long>(batch.block_start[lo + 1] -
                             batch.block_start[lo]) * kThreads;
  const long long n = e.n;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(e.src) |
        reinterpret_cast<uintptr_t>(e.dst)) & 15) == 0;
  // Elements before the ragged tail that 16-byte vectors cover.
  constexpr int kVec = 16 / sizeof(T);
  const long long head = aligned ? (n / kVec) * kVec : 0;

  // 16-byte vectors, kUnroll loads in flight per thread before their
  // stores.
  const uint4* sv = reinterpret_cast<const uint4*>(e.src);
  uint4* dv = reinterpret_cast<uint4*>(e.dst);
  const long long nvec = head / kVec;
  long long i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = sv[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!pure_copy) scale_vec<T>(r[u], factor);
      dv[i + u * stride] = r[u];
    }
  }
  for (; i < nvec; i += stride) {
    uint4 r = sv[i];
    if (!pure_copy) scale_vec<T>(r, factor);
    dv[i] = r;
  }
  if (pure_copy) {
    const B* s = reinterpret_cast<const B*>(e.src);
    B* d = reinterpret_cast<B*>(e.dst);
    for (long long i = head + tid; i < n; i += stride) d[i] = s[i];
  } else {
    const T* s = reinterpret_cast<const T*>(e.src);
    T* d = reinterpret_cast<T*>(e.dst);
    for (long long i = head + tid; i < n; i += stride) d[i] = scale(s[i], factor);
  }
  B* d = reinterpret_cast<B*>(e.dst);
  for (long long i = n + tid; i < e.n_pad; i += stride) d[i] = B(0);
}

template <typename T>
int launch(const long long* table, int count, double factor, int pure_copy,
           cudaStream_t stream) {
  Batch batch;
  int blocks = 0, used = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = table[4 * i + 2], n_pad = table[4 * i + 3];
    if (n_pad <= 0) continue;
    Entry& e = batch.e[used];
    e.src = reinterpret_cast<const char*>(table[4 * i]);
    e.dst = reinterpret_cast<char*>(table[4 * i + 1]);
    e.n = n;
    e.n_pad = n_pad;
    long long want = (n_pad * static_cast<long long>(sizeof(T)) +
                      kBytesPerBlock - 1) / kBytesPerBlock;
    if (want > kMaxBlocksPerEntry) want = kMaxBlocksPerEntry;
    batch.block_start[used] = blocks;
    blocks += static_cast<int>(want);
    ++used;
  }
  if (used == 0) return -3;
  batch.block_start[used] = blocks;
  batch.count = used;
  scaled_copy_kernel<T><<<blocks, kThreads, 0, stream>>>(
      batch, static_cast<typename Factor<T>::T_>(factor), pure_copy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes (horovod_tpu_torch/ops/fusion_buffer.py _DTYPE_CODES):
// 0 uint8, 1 int8, 2 uint16, 3 int16, 4 int32, 5 int64, 6 float16,
// 7 float32, 8 float64, 9 bool, 10 bfloat16.
//
// `table` is `count` rows of four int64 on the host: source address,
// destination address, elements, elements written (the rest zeros).
// `factor` is already rounded to the dtype.  Returns 0 after a launch,
// a cudaError_t if the launch failed, -1 for an unknown dtype, -2 for
// more than kMaxEntries rows, -3 when every row is empty (nothing was
// launched).
extern "C" int hvd_fusion_scaled_copy(const long long* table, int count,
                                      int dtype, double factor,
                                      int pure_copy, void* stream) {
  if (count > kMaxEntries) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<uint8_t>(table, count, factor, pure_copy, s);
    case 1: return launch<int8_t>(table, count, factor, pure_copy, s);
    case 2: return launch<uint16_t>(table, count, factor, pure_copy, s);
    case 3: return launch<int16_t>(table, count, factor, pure_copy, s);
    case 4: return launch<int32_t>(table, count, factor, pure_copy, s);
    case 5: return launch<long long>(table, count, factor, pure_copy, s);
    case 6: return launch<__half>(table, count, factor, pure_copy, s);
    case 7: return launch<float>(table, count, factor, pure_copy, s);
    case 8: return launch<double>(table, count, factor, pure_copy, s);
    case 9: return launch<bool>(table, count, factor, pure_copy, s);
    case 10: return launch<__nv_bfloat16>(table, count, factor, pure_copy, s);
    default: return -1;
  }
}

extern "C" int hvd_fusion_max_entries() { return kMaxEntries; }

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
