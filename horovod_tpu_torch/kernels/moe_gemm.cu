// Grouped GEMM over the experts of a mixture-of-experts layer, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no TPU kernel: the JAX package's expert layer
// (horovod_tpu/parallel/moe.py) holds one expert per rank and runs it as
// one dense product over a fixed-capacity bucket.  It was added for the
// dropless top-k layer of horovod_tpu_torch/parallel/moe.py, whose held
// experts each take a number of rows that only the device knows: a
// per-expert loop of library products would need the counts on the host
// (one synchronisation per layer and pass), and padding every expert to
// a fixed capacity would multiply the products.
//
// What it computes, in bf16 with fp32 sums, C = A . B^T per expert,
// both operands K-major (rows of K contiguous values):
//
// * moe_gemm_rows (mode 0): a [rows, K] holds every expert's rows, expert
//   e's in rows offsets[e] .. offsets[e+1]; b [E, N, K] holds the
//   experts' matrices.  c[r] = a[r] . b[e]^T for each r of expert e,
//   c [rows, N].  The forward's Y = X W^T, and the backward's dX = dY W
//   with b the transposed weights.
// * moe_gemm_k (mode 1): a [M, R] and b [N, R] hold the experts' columns
//   side by side, expert e's in columns offsets[e] .. offsets[e+1].
//   c[e] = a[:, seg e] . b[:, seg e]^T, c [E, M, N]: the backward's
//   dW = dY^T X, whose K is the expert's row count (0 writes zeros).
//
// The offsets live on the device and are read by the kernel: one launch
// covers every expert, and the host never learns the counts.  They must
// start at 0, rise, and be multiples of 128 (the caller pads each
// expert's rows with zero rows to a whole tile), so that a 128-row tile
// never spans two experts and every 64-column K step of mode 1 lies
// inside one expert.  Rows of a outside every segment are not read and
// rows of c outside every segment are not written.
//
// Bound: at the training shape of the lfm2_8b_a1b cell (8 experts of
// 2048 x 1792, about 8,192 rows a layer) the three products of one
// weight are 2 x 3 x 8192 x 2048 x 1792 FLOPs (0.18 TFLOP, 183 us at the
// bf16 peak) against about 0.3 GB of operands (90 us at 3.35 TB/s): the
// tensor cores bound it.
//
// Design: the flash kernels' frame (hopper.cuh).  One persistent CTA per
// SM walks the 128 x 128 output tiles in a grid-stride loop, reading the
// offsets into shared memory once.  Warpgroup 0's one elected thread
// streams the A and B tiles of each 64-column K step into a ring of
// kStages shared-memory stages by TMA (2-D tensor maps, 64 x 128 boxes,
// 128-byte swizzle, edges zero-filled by the hardware), with full/empty
// mbarriers; the ring runs on from one tile to the next.  Warpgroups 1
// and 2 each own 64 rows of the tile and run m64n128k16 wgmma from
// shared memory, both operands K-major, keeping one K step's products in
// flight while the next is issued; the epilogue writes bf16 pairs.

#include "hopper.cuh"

namespace {

constexpr int kTile = 128;     // rows and columns of an output tile
constexpr int kStages = 4;     // K steps of 64 columns in flight
constexpr int kThreads = 384;  // one producer and two consumer warpgroups
constexpr int kMaxExperts = 256;
constexpr uint32_t kBoxBytes = kTile * kBox * 2;  // one operand's K step
constexpr uint32_t kStageUnits = kBoxBytes / 16;  // in descriptor units
constexpr size_t kSmemBytes = 2 * kStages * kBoxBytes + 1024;
constexpr int kUnsupported = -1, kEncodeFailed = -2, kNoLaunch = -3;

using T = __nv_bfloat16;

// One box of a 2-D tensor map (cols, rows) into shared memory; the
// completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// One output tile: where its operands start, how many K steps it takes,
// where it is written and how much of it is inside c.
struct Tile {
  int a_row, b_row, k0, k_steps, rows, cols;
  size_t c_off;
};

// Tile t of a launch.  Mode 0: tiles of 128 rows of a (consecutive tiles
// share them) by 128 columns of c; the row's segment names the expert,
// whose matrix is rows e n .. e n + n - 1 of b.  Mode 1: expert-major,
// then 128 rows of c by 128 columns; K runs over the expert's columns.
template <int kMode>
__device__ __forceinline__ Tile tile_of(int t, const int* off, int m, int n,
                                        int k) {
  const int tiles_n = (n + kTile - 1) / kTile;
  Tile w;
  if constexpr (kMode == 0) {
    const int row0 = (t / tiles_n) * kTile;
    const int col0 = (t % tiles_n) * kTile;
    int e = 0;
    while (off[e + 1] <= row0) ++e;
    w.a_row = row0;
    w.b_row = e * n + col0;
    w.k0 = 0;
    w.k_steps = (k + kBox - 1) / kBox;
    w.rows = kTile;
    w.cols = min(kTile, n - col0);
    w.c_off = (size_t)row0 * n + col0;
  } else {
    const int tiles_m = (m + kTile - 1) / kTile;
    const int e = t / (tiles_m * tiles_n);
    const int rest = t % (tiles_m * tiles_n);
    const int row0 = (rest / tiles_n) * kTile;
    const int col0 = (rest % tiles_n) * kTile;
    w.a_row = row0;
    w.b_row = col0;
    w.k0 = off[e];
    w.k_steps = (off[e + 1] - off[e]) / kBox;
    w.rows = min(kTile, m - row0);
    w.cols = min(kTile, n - col0);
    w.c_off = (size_t)e * m * n + (size_t)row0 * n + col0;
  }
  return w;
}

template <int kMode>
__device__ __forceinline__ void gemm(const CUtensorMap* amap,
                                     const CUtensorMap* bmap, T* c,
                                     const int* offsets, int experts, int m,
                                     int n, int k) {
  extern __shared__ __align__(16) unsigned char moe_smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ int off[kMaxExperts + 1];
  const uint32_t raw = smem_u32(moe_smem);
  T* as = reinterpret_cast<T*>(moe_smem + ((1024u - (raw & 1023u)) & 1023u));
  T* bs = as + kStages * kTile * kBox;  // stage s: as / bs + s 128 x 64
  const int tid = threadIdx.x;

  for (int i = tid; i <= experts; i += kThreads) off[i] = offsets[i];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one release per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles_n = (n + kTile - 1) / kTile;
  const int total = kMode == 0
                        ? (off[experts] / kTile) * tiles_n
                        : experts * ((m + kTile - 1) / kTile) * tiles_n;

  if (tid < 128) {
    // Producer: one thread starts every load.
    if (tid == 0) {
      int it = 0;  // K steps loaded so far, over all tiles
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile w = tile_of<kMode>(t, off, m, n, k);
        for (int kt = 0; kt < w.k_steps; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * kBoxBytes);
          const int col = w.k0 + kt * kBox;
          tma_load_2d(as + s * kTile * kBox, amap, &full[s], col, w.a_row);
          tma_load_2d(bs + s * kTile * kBox, bmap, &full[s], col, w.b_row);
        }
      }
    }
    return;
  }

  const int cw = tid / 128 - 1;  // consumer 0 or 1: rows 64 cw ..
  const int wtid = tid % 128;
  const int lane = tid & 31;
  const int tq = lane & 3;
  const bool leader = wtid == 0;  // releases stages for its warpgroup
  // Accumulator element i sits at row 64 cw + rr + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + 2 tq + (i & 1).
  const int rr = 16 * (wtid >> 5) + (lane >> 2);
  // Descriptors of stage 0 at k-step 0; a k-step of 16 moves 32 bytes
  // along the swizzled 128-byte row, a stage kStageUnits.
  const uint64_t da = sw128_desc(as + 64 * cw * kBox, 16, 1024);
  const uint64_t db = sw128_desc(bs, 16, 1024);
  float acc[64];
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile w = tile_of<kMode>(t, off, m, n, k);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < w.k_steps; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        const uint64_t step = s * kStageUnits + 2 * kk;
        HVD_WGMMA_SS_N128("bf16", acc, da + step, db + step, 1);
      }
      wgmma_commit();
      // The step before is done: its stage goes back to the producer.
      wgmma_wait<1>();
      mbar_arrive_if(&empty[(it + kStages - 1) % kStages], leader && kt > 0);
    }
    wgmma_wait<0>();
    pin(acc);
    mbar_arrive_if(&empty[(it + kStages - 1) % kStages],
                   leader && w.k_steps > 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * cw + rr + 8 * r;
      if (row < w.rows) {
        T* crow = c + w.c_off + (size_t)row * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * tq;  // n is even: col + 1 fits too
          if (col < w.cols)
            *reinterpret_cast<uint32_t*>(crow + col) =
                pack2<T>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// A [rows, cols] bf16 matrix as a 2-D map (cols, rows) read in boxes of
// 64 columns x 128 rows with the 128-byte swizzle that wgmma reads.
bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {kBox, kTile};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1)
    moe_gemm_rows(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, T* c,
                  const int* offsets, int experts, int n, int k) {
  gemm<0>(&amap, &bmap, c, offsets, experts, 0, n, k);
}

__global__ void __launch_bounds__(kThreads, 1)
    moe_gemm_k(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap bmap, T* c,
               const int* offsets, int experts, int m, int n) {
  gemm<1>(&amap, &bmap, c, offsets, experts, m, n, 0);
}

// Plain C entry point, loaded with ctypes; bf16 operands, contiguous and
// 16-byte aligned.  Mode 0 (moe_gemm_rows): a [a_rows, cols], b
// [experts n, cols], c [a_rows, n], offsets over a's rows.  Mode 1
// (moe_gemm_k): a [m, cols], b [n, cols], c [experts, m, n], offsets over
// the columns.  offsets [experts + 1] on the device: from 0, rising, in
// multiples of 128.  Returns the cudaError_t of the launch (0 on
// success), -1 for sizes the kernel does not take (cols or n not a
// multiple of 8, more than 256 experts, an unknown mode), -2 if a tensor
// map cannot be encoded, -3 where there is no tile to launch.
extern "C" int hvd_moe_gemm(const void* a, const void* b, void* c,
                            const int* offsets, int mode, int experts,
                            int a_rows, int cols, int m, int n,
                            void* stream) {
  if (experts < 1 || experts > kMaxExperts || cols % 8 != 0 || n % 8 != 0 ||
      (mode != 0 && mode != 1))
    return kUnsupported;
  const int tiles_n = (n + kTile - 1) / kTile;
  const long long most =
      mode == 0 ? (long long)((a_rows + kTile - 1) / kTile) * tiles_n
                : (long long)experts * ((m + kTile - 1) / kTile) * tiles_n;
  if (most == 0 || cols == 0) return kNoLaunch;
  CUtensorMap amap, bmap;
  const int b_rows = mode == 0 ? experts * n : n;
  if (!encode_2d(&amap, a, mode == 0 ? a_rows : m, cols) ||
      !encode_2d(&bmap, b, b_rows, cols))
    return kEncodeFailed;
  static std::atomic<uint64_t> ready_rows{0}, ready_k{0};
  int err = mode == 0 ? allow_smem(moe_gemm_rows, kSmemBytes, ready_rows)
                      : allow_smem(moe_gemm_k, kSmemBytes, ready_k);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = most < sms ? (int)most : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* out = static_cast<T*>(c);
  if (mode == 0)
    moe_gemm_rows<<<grid, kThreads, kSmemBytes, s>>>(amap, bmap, out, offsets,
                                                    experts, n, cols);
  else
    moe_gemm_k<<<grid, kThreads, kSmemBytes, s>>>(amap, bmap, out, offsets,
                                                 experts, m, n);
  return cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
