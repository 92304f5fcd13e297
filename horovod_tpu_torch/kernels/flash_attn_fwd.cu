// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/pallas_attention.py
// (_attn_kernel, launched by pl.pallas_call in _flash_fwd).  It computes
// the same function: s = (q . k^T) * scale in fp32, top-left causal mask
// (qpos >= kpos), keys past Skv masked, finite mask value -1e30, an
// online softmax carried in fp32 (m, l, acc), l == 0 -> 1 for rows that
// saw no key, output cast to the input type.
//
// Layout: q [BH, Sq, D], k and v [BH, Skv, D], o [BH, Sq, D], all
// contiguous and 16-byte aligned.  Sq and Skv are arbitrary: loads are
// predicated or zero-filled and the tail is masked, so the host pads
// nothing.
//
// Design.  On the TPU the kv-block grid axis runs in order and carries
// m/l/acc in VMEM scratch between grid steps.  Here blocks run in no
// order, so one CTA owns one (bh, q tile) and walks the kv tiles in a
// loop, keeping m/l/acc in registers.  Causal runs stop at the last kv
// tile that holds a key <= the tile's last query row, as the TPU kernel
// skips fully masked blocks.  Three bodies share that frame; the caller
// picks one (hvd_flash_attn_fwd's `body`):
//
// * 2, wgmma (bf16 / fp16, D 64 or 128; the training path): 128-row q
//   tiles against 128-key kv tiles, 384 threads in three warpgroups,
//   one persistent CTA per SM walking the (bh, q tile) items heaviest
//   first.  The producer warpgroup's one elected thread loads each
//   item's Q into one of two buffers and its K and V tiles into rings of
//   two shared-memory stages by TMA (3-D tensor
//   maps over [BH, S, D], 128-byte swizzle, the tail zero-filled by the
//   hardware), with full/empty mbarriers and no __syncthreads() in the
//   loop; the rings run on from one item to the next.  Two consumer
//   warpgroups own 64 rows each and run both products as asynchronous
//   wgmma: S = Q.K^T from shared memory (m64n128k16), O += P.V with P
//   from registers and V read as the transposed B operand (m64nDk16).
//   A consumer walks all its items' tiles as one sequence, and the
//   softmax of one tile runs while P.V of the one before is on the
//   tensor cores; the two consumers take turns to start theirs (ping-pong), so
//   one's softmax also overlaps the other's products.  setmaxnreg moves
//   registers from the producer to the consumers.  Softmax runs in the
//   log2 domain (scale . log2 e folded into the exponent's FMA, ex2) and
//   masks only the tiles that cross the diagonal or Skv.
// * 1, mma.sync (bf16 / fp16, any D): 64 x 64 tiles, four warps, 16
//   query rows each.  Both products run on the tensor cores as mma.sync
//   m16n8k16 with fp32 accumulators.  A warp keeps its Q fragments in
//   registers for the whole kv loop.  K and V tiles arrive by cp.async
//   into two stages of shared memory, the next tile's copy in flight
//   while this one computes; rows are padded by 16 bytes so fragment
//   loads hit 32 banks.  K as [key][d] is the column-major B operand of
//   Q.K^T; V's B fragments come from the same [key][d] layout by a
//   transposing ldmatrix.  The score accumulators' layout is the A
//   layout of P.V, so P goes from registers (rounded to the input type)
//   straight into the second mma.  A row's four owners are one lane
//   quad: row max and row sum are two xor-shuffles.  It serves D 16 and
//   32 and is the yardstick the wgmma body is timed against.
// * 0, fp32: the products stay in fp32 (the reference's precision) as
//   scalar FMAs from shared memory, 256 threads on a 16 x 16 grid.
//
// Bound: at the GPT-2-small training shape (BH = 96, S = 1024, D = 64,
// bf16, causal) the least time is set by bytes: q, k, v read once and o
// written once are 50 MB, 15 us at 3.35 TB/s, against 12.9 GFLOP, 13 us
// at the bf16 tensor-core peak.  The wgmma body's 128 x 128 tiles halve
// the K/V re-reads from L2 against 64 x 64 tiles (36 tile pairs of
// 32 KB per causal head instead of 136 of 16 KB), and a persistent CTA
// keeps them streaming across work items.  What keeps it above the
// bound is the softmax: at D = 64 its ex2 work (16 per clock per SM)
// takes as long as both products, and its other instructions take as
// many dispatch slots, with only two consumer warps per SM sub-partition
// to hide their latency.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per kv tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------
constexpr int kScalarThreads = 256;  // 16 x 16

template <int D>
constexpr size_t scalar_smem_bytes() {
  // qs [BQ][D+1], ks [BK][D+1], vs [BK][D], ps [BQ][BK+1]
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kScalarThreads)
    flash_fwd_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int nq_tiles, int sq, int skv, float scale,
                          int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * DP;
  float* vs = ks + kBK * DP;
  float* ps = vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x / nq_tiles;
  // Heaviest causal tiles (last rows) are scheduled first.
  const int qt = nq_tiles - 1 - (blockIdx.x % nq_tiles);
  const int q0 = qt * kBQ;
  const float* qb = q + (size_t)bh * sq * D;
  const float* kb = k + (size_t)bh * skv * D;
  const float* vb = v + (size_t)bh * skv * D;
  float* ob = o + (size_t)bh * sq * D;

  for (int idx = tid; idx < kBQ * D; idx += kScalarThreads) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    qs[r * DP + c] = qr < sq ? qb[(size_t)qr * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int idx = tid; idx < kBK * D; idx += kScalarThreads) {
      const int r = idx / D, c = idx % D;
      const int kr = k0 + r;
      const bool in = kr < skv;
      ks[r * DP + c] = in ? kb[(size_t)kr * D + c] : 0.f;
      vs[r * D + c] = in ? vb[(size_t)kr * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= skv || (causal && qpos < kpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) w[cc] = vs[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
          acc[i][cc] = fmaf(p[i], w[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr < sq) {
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        ob[(size_t)qr * D + tx + 16 * cc] = acc[i][cc] / li;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // four warps x 16 query rows

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

// c += a . b for one m16n8k16 tile (A row-major, B column-major).
template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float c[4],
                                                        const uint32_t a[4],
                                                        const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float c[4],
                                                 const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 16-bit matrices from shared memory, transposed: lane i gives
// the address of row (i & 7) of matrix (i >> 3).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // qs [BQ][D+8], then two stages of ks [BK][D+8] and vs [BK][D+8],
  // 16-bit elements; the 16-byte row pad spreads rows over the banks.
  return 2 * (kBQ + 4 * kBK) * (D + 8);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int nq_tiles, int sq, int skv, float scale,
                         int causal) {
  constexpr int RS = D + 8;  // elements per shared-memory row
  constexpr int KSTEPS = D / 16;
  constexpr int DTILES = D / 8;
  constexpr int NTILES = kBK / 8;
  constexpr int VEC = 8;  // 16-bit elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kvs = qs + kBQ * RS;  // stage st: ks at kvs + 2 st BK RS, vs after

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and B column) group
  const int tq = lane & 3;  // thread in group
  const int bh = blockIdx.x / nq_tiles;
  const int qt = nq_tiles - 1 - (blockIdx.x % nq_tiles);
  const int q0 = qt * kBQ;
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * skv * D;
  const T* vb = v + (size_t)bh * skv * D;
  T* ob = o + (size_t)bh * sq * D;

  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  // Rows past the sequence are zero-filled (their source address is
  // clamped to row 0, which is never read).
  auto load_rows = [&](T* dst, const T* src, int row0, int rows, int n) {
    for (int idx = tid; idx < rows * D / VEC; idx += kMmaThreads) {
      const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
      const bool in = row0 + r < n;
      cp_async16(dst + r * RS + c, src + (in ? (size_t)(row0 + r) * D + c : 0),
                 in);
    }
  };
  load_rows(qs, qb, q0, kBQ, sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows(kvs, kb, 0, kBK, skv);
    load_rows(kvs + kBK * RS, vb, 0, kBK, skv);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // This warp's Q rows as A fragments, one per 16-wide slice of D.
  const int wr = warp * 16 + g;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const T* p = qs + wr * RS + kk * 16 + 2 * tq;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * RS);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * RS + 8);
  }

  // Fragment rows g and g + 8 of this warp's slice: index 0 and 1.
  const int qpos[2] = {q0 + wr, q0 + wr + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // Prefetch the next tile into the other stage while this one runs.
    if (t + 1 < n_tiles) {
      T* nxt = kvs + ((t + 1) & 1) * 2 * kBK * RS;
      load_rows(nxt, kb, k0 + kBK, kBK, skv);
      load_rows(nxt + kBK * RS, vb, k0 + kBK, kBK, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = kvs + (t & 1) * 2 * kBK * RS;
    const T* vs = ks + kBK * RS;

    // S = Q . K^T for this warp's 16 rows x 64 keys; K as [key][d] is
    // the column-major B operand.
    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const T* p = ks + (nt * 8 + g) * RS + kk * 16 + 2 * tq;
        const uint32_t b[2] = {ld32(p), ld32(p + 8)};
        mma16816<T>(s[nt], qf[kk], b);
      }
    }

    // Accumulator element e sits at row (e >> 1) (g or g + 8), column
    // nt * 8 + 2 * tq + (e & 1).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + 2 * tq + (e & 1);
        float x = s[nt][e] * scale;
        if (kpos >= skv || (causal && qpos[e >> 1] < kpos)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e >> 1];

    // acc += P . V: P from the score registers, V's B fragments (two
    // d-tiles at a time) by a transposing ldmatrix from [key][d].
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]),
          pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DTILES; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vs + (kk * 16 + (lane & 15)) * RS + (dt + (lane >> 4)) * 8);
        mma16816<T>(acc[dt], a, b);
        mma16816<T>(acc[dt + 1], a, b + 2);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < sq) {
      const float li = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt)
        *reinterpret_cast<uint32_t*>(ob + (size_t)qpos[r] * D + dt * 8 +
                                     2 * tq) =
            pack2<T>(acc[dt][2 * r] / li, acc[dt][2 * r + 1] / li);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 on Hopper: TMA loads, wgmma products, warp-specialised
// ---------------------------------------------------------------------------
constexpr int kWgTile = 128;     // query rows per CTA, and keys per kv tile
constexpr int kWgThreads = 384;  // one producer and two consumer warpgroups
constexpr int kBox = 64;         // columns per TMA box: one 128-byte row
constexpr float kLog2e = 1.4426950408889634f;
// K/V stages of the shared-memory ring.  One CTA per SM already has the
// next tile's loads in flight with two; at D = 128 a third would not fit
// beside the two Q buffers.
constexpr int kWgStages = 2;

template <int D>
constexpr size_t wg_smem_bytes() {
  // 1 KB of slack to start the tiles on the 1024-byte swizzle period,
  // then two Q buffers and kWgStages x (K, V), each 128 rows x D 16-bit
  // values.
  return 1024 + (size_t)(2 + 2 * kWgStages) * kWgTile * D * 2;
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
__device__ __forceinline__ void pin(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma
// launches: a warpgroup waits for its turn on its own barrier and hands
// the turn to the other one (128 threads sync, 128 arrive).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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

// d (64 x 128, fp32) = A . B (+ d when scale_d), A and B K-major in
// shared memory.
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

template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_SS_N128("bf16", d, da, db, scale_d);
  } else {
    HVD_WGMMA_SS_N128("f16", d, da, db, scale_d);
  }
}

template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
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

// One online-softmax step on a 64 x 128 score tile held as an m64n128
// accumulator: element i sits at row `row` + 8 ((i >> 1) & 1), key
// k0 + 8 (i >> 2) + 2 tq + (i & 1).  Scores go to the log2 domain
// (scale . log2 e folded into one multiply, ex2 below); the causal and
// Skv masks run only when `masked`, which a negative scale must set.
// Leaves the probabilities in sc, updates the row max m and row sum l,
// and returns in corr the factor that the accumulators of earlier tiles
// must take.  Row maxima and sums run over four partials each, which
// shortens their dependency chains.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool masked, int k0, int row,
                                             int tq, int skv, int causal,
                                             float scale_log2) {
  float mx[2][4], rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[r][j] = kNegInf;
      rs[r][j] = 0.f;
    }
  if (masked) {
    // Key column c of the tile is kept for a row iff c < lim: before
    // Skv and, when causal, at or before the row's own position.  The
    // thread's columns are 8 (i >> 2) + (i & 1) past 2 tq.
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lim[r] = (causal ? min(skv - k0, row + 8 * r - k0 + 1) : skv - k0) -
               2 * tq;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float x = sc[i] * scale_log2;
      sc[i] = 8 * (i >> 2) + (i & 1) < lim[(i >> 1) & 1] ? x : kNegInf;
    }
  }
  // Unmasked, the scale (>= 0 there) is applied after the max and
  // inside the exponent's FMA, which saves a multiply per score.
  const float unit = masked ? 1.f : scale_log2;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x * unit);
    corr[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], unit, -m[(i >> 1) & 1]));
    rs[(i >> 1) & 1][(i >> 2) & 3] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = l[r] * corr[r] + x;
  }
}

// P, rounded to the input type, in the wgmma A-fragment layout: k-step
// kk covers keys 16 kk .. 16 kk + 15, score blocks 2 kk and 2 kk + 1.
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack2<T>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// A persistent CTA: grid-stride over the (bh, 128-row q tile) work items,
// heaviest (last q rows) first, in snake order (rounds of gridDim.x items,
// every other round handed out in reverse) so that the CTAs' causal work
// evens out.  Producer and consumers walk the same sequence; the first
// round without an item for this CTA ends it.
struct WorkItem {
  int bh, q0, n_tiles;
};

__device__ __forceinline__ bool work_item(int round, int bh_count,
                                          int nq_tiles, int skv, int causal,
                                          WorkItem& w) {
  const int g = gridDim.x;
  const int item = round * g + ((round & 1) ? g - 1 - (int)blockIdx.x
                                            : (int)blockIdx.x);
  if (item >= bh_count * nq_tiles) return false;
  w.bh = item % bh_count;
  w.q0 = (nq_tiles - 1 - item / bh_count) * kWgTile;
  const int kv_end = causal ? min(skv, w.q0 + kWgTile) : skv;
  w.n_tiles = (kv_end + kWgTile - 1) / kWgTile;
  return true;
}

// Warpgroup 0 is the producer: one thread loads each work item's Q into
// one of two Q buffers and streams its K and V tiles into rings of STAGES
// stages by TMA (full_* count the bytes, empty_* count the two consumers'
// releases; the rings run on across work items).  Warpgroups 1 and 2 each
// own 64 of the 128 rows and run S = Q.K^T and O += P.V on wgmma.  The
// consumers walk all their items' kv tiles as one sequence: each step
// starts S = Q.K^T of one tile and O += P.V of the tile before, waits for
// S only, runs the softmax while P.V is on the tensor cores, then waits
// for P.V.  When the tile before belongs to the previous item, that wait
// completes it and its epilogue runs; so only the CTA's very first tile
// runs without a product beside it.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           T* __restrict__ o, int bh_count, int nq_tiles,
                           int sq, int skv, float scale_log2, int causal) {
  constexpr int STAGES = kWgStages;
  constexpr int BOXES = D / kBox;      // TMA boxes per tile
  constexpr int BOX = kWgTile * kBox;  // elements per box
  constexpr int TILE = kWgTile * D;    // elements per Q, K or V tile
  constexpr uint32_t kTileBytes = TILE * sizeof(T);
  constexpr uint32_t kTileUnits = kTileBytes / 16;  // in descriptor units
  extern __shared__ __align__(16) unsigned char wg_smem[];
  __shared__ uint64_t q_full[2], q_empty[2], full_k[STAGES], full_v[STAGES],
      empty_k[STAGES], empty_v[STAGES];
  const uint32_t raw = smem_u32(wg_smem);
  T* qs = reinterpret_cast<T*>(wg_smem + ((1024u - (raw & 1023u)) & 1023u));
  T* ks = qs + 2 * TILE;       // Q buffer b at qs + b TILE; K of stage s
  T* vs = ks + STAGES * TILE;  // at ks + s TILE, V at vs + s TILE
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 2);  // one release per consumer warpgroup
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 2);
      mbar_init(&empty_v[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer: gives up registers; one thread starts every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int kv = 0;  // K/V tiles loaded so far
      WorkItem w;
      for (int n = 0; work_item(n, bh_count, nq_tiles, skv, causal, w);
           ++n) {
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], kTileBytes);
#pragma unroll
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(qs + qb * TILE + b * BOX, &qmap, &q_full[qb], b * kBox,
                      w.q0, w.bh);
        for (int t = 0; t < w.n_tiles; ++t, ++kv) {
          const int s = kv % STAGES;
          const int parity = ((kv / STAGES) & 1) ^ 1;
          if (kv >= STAGES) mbar_wait(&empty_k[s], parity);
          mbar_expect_tx(&full_k[s], kTileBytes);
#pragma unroll
          for (int b = 0; b < BOXES; ++b)
            tma_load_3d(ks + s * TILE + b * BOX, &kmap, &full_k[s],
                        b * kBox, t * kWgTile, w.bh);
          if (kv >= STAGES) mbar_wait(&empty_v[s], parity);
          mbar_expect_tx(&full_v[s], kTileBytes);
#pragma unroll
          for (int b = 0; b < BOXES; ++b)
            tma_load_3d(vs + s * TILE + b * BOX, &vmap, &full_v[s],
                        b * kBox, t * kWgTile, w.bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = tid / 128 - 1;  // consumer 0 or 1: rows 64 cw ..
    const int wtid = tid % 128;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const bool leader = wtid == 0;  // releases stages for its warpgroup
    // Accumulator element i of an m64nN product sits at row
    // q0 + 64 cw + rr + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tq + (i & 1).
    const int rr = 16 * (wtid >> 5) + (lane >> 2);
    float acc[D / 2], m[2], l[2], l_done[2], corr[2], sc[64];
    uint32_t pa[8][4];  // P in the A-fragment layout of P.V

    // Descriptors of Q buffer 0, K and V slot 0 at k-step 0; every other
    // operand is a constant number of 16-byte units away (the address
    // field is the descriptor's low bits and never carries).
    const uint64_t dq = sw128_desc(qs + 64 * cw * kBox, 16, 1024);
    const uint64_t dk = sw128_desc(ks, 16, 1024);
    const uint64_t dv = sw128_desc(vs, BOX * 2, 1024);
    // S = Q.K^T, 64 rows x 128 keys, Q from buffer qb and K from ring
    // slot j.  Q and K ([key][d]) are both K-major: a k-step of 16 moves
    // 32 bytes along the swizzled 128-byte row; columns 64..127 are the
    // second box.
    auto start_qk = [&](int j, int qb) {
      const uint32_t slot = (j % STAGES) * kTileUnits;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = ((kk / 4) * BOX + (kk % 4) * 16) * 2 / 16;
        wgmma_qk<T>(sc, dq + qb * kTileUnits + col, dk + slot + col, kk > 0);
      }
      wgmma_commit();
    };
    // O += P.V from ring slot j.  V as [key][d] is MN-major for B
    // (transpose flag): a k-step of 16 keys is 16 rows of 128 bytes,
    // 8-row groups are 1024 bytes apart, columns 64..127 the next box.
    auto start_pv = [&](int j) {
      const uint32_t slot = (j % STAGES) * kTileUnits;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<T, D>(acc, pa[kk], dv + slot + kk * 16 * kBox * 2 / 16);
      wgmma_commit();
    };
    // Only tiles that cross the diagonal or Skv need the masks (and a
    // negative scale takes the masked path).
    auto masked = [&](const WorkItem& w, int k0) {
      return k0 + kWgTile > skv ||
             (causal && k0 + kWgTile - 1 > w.q0 + 64 * cw) ||
             scale_log2 < 0.f;
    };
    auto epilogue = [&](const WorkItem& w, const float (&lr)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = w.q0 + 64 * cw + rr + 8 * r;
        if (qpos < sq) {
          const float inv = 1.f / (lr[r] == 0.f ? 1.f : lr[r]);
          T* orow = o + ((size_t)w.bh * sq + qpos) * D + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt)
            *reinterpret_cast<uint32_t*>(orow + 8 * nt) = pack2<T>(
                acc[4 * nt + 2 * r] * inv, acc[4 * nt + 2 * r + 1] * inv);
        }
      }
    };

    // Ping-pong: the two consumers take turns to start their products,
    // so one's softmax runs while the other's wgmma fills the tensor
    // cores.  Consumer 0 has the first turn.
    if (cw == 1) turn_pass(1);

    WorkItem cur;  // the item whose O is in acc
    if (!work_item(0, bh_count, nq_tiles, skv, causal, cur)) return;
    // The CTA's first tile: S, softmax, nothing to overlap.
    mbar_wait(&q_full[0], 0);
    mbar_wait(&full_k[0], 0);
    turn_wait(1 + cw);
    wgmma_fence();
    start_qk(0, 0);
    turn_pass(2 - cw);
    wgmma_wait<0>();
    pin(sc);
    mbar_arrive_if(&empty_k[0], leader);
    mbar_arrive_if(&q_empty[0], leader && cur.n_tiles == 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    softmax_tile(sc, m, l, corr, masked(cur, 0), 0, cur.q0 + 64 * cw + rr,
                 tq, skv, causal, scale_log2);
    pack_p<T>(pa, sc);

    // One step: S of tile t of item w (ring slot kv, Q buffer qb) and
    // P.V of the tile before.  Between the start and the wait for P.V
    // the code must not branch, or ptxas waits for every wgmma before the
    // branch: the mask is a template argument (only an item's last tile
    // can need it), a fresh item's reset is a select and the releases
    // are predicated.
    WorkItem w = cur;
    int n = 0, t = 1, kv = 1;  // w is item n of this CTA
    auto step = [&](auto mask, bool fresh) {
      const int qb = n & 1;
      mbar_wait(&full_k[kv % STAGES], (kv / STAGES) & 1);
      mbar_wait(&full_v[(kv - 1) % STAGES], ((kv - 1) / STAGES) & 1);
      pin(acc);
      pin(pa);
      turn_wait(1 + cw);
      wgmma_fence();
      start_qk(kv, qb);
      start_pv(kv - 1);
      turn_pass(2 - cw);
      wgmma_wait<1>();  // S is in; the P.V before may still run
      pin(sc);
      mbar_arrive_if(&empty_k[kv % STAGES], leader);
      mbar_arrive_if(&q_empty[qb], leader && t == w.n_tiles - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_done[r] = fresh ? l[r] : l_done[r];
        m[r] = fresh ? kNegInf : m[r];
        l[r] = fresh ? 0.f : l[r];
      }
      softmax_tile(sc, m, l, corr, decltype(mask)::value, t * kWgTile,
                   w.q0 + 64 * cw + rr, tq, skv, causal, scale_log2);
      pin(sc);  // keeps the softmax above the wait at the source level
      pin(corr);
      pin(l);
      wgmma_wait<0>();
      pin(acc);
      pin(pa);
      mbar_arrive_if(&empty_v[(kv - 1) % STAGES], leader);
    };
    for (;; ++t, ++kv) {
      bool fresh = false;
      if (t == w.n_tiles) {  // on to the next item
        if (!work_item(n + 1, bh_count, nq_tiles, skv, causal, w)) break;
        ++n;
        t = 0;
        fresh = true;
        mbar_wait(&q_full[n & 1], (n >> 1) & 1);
      }
      if (masked(w, t * kWgTile))
        step(std::true_type{}, fresh);
      else
        step(std::false_type{}, fresh);
      if (fresh) {
        epilogue(cur, l_done);
        cur = w;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      }
      pack_p<T>(pa, sc);
    }
    // The last tile's P.V.
    mbar_wait(&full_v[(kv - 1) % STAGES], ((kv - 1) / STAGES) & 1);
    pin(acc);
    pin(pa);
    turn_wait(1 + cw);
    wgmma_fence();
    start_pv(kv - 1);
    turn_pass(2 - cw);
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
    epilogue(cur, l);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
constexpr int kUnsupported = -1;   // body, dtype and head dim do not match
constexpr int kEncodeFailed = -2;  // cuTensorMapEncodeTiled refused a map
constexpr int kNoLaunch = -3;      // nothing to compute: no kernel started

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

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, float scale, int causal,
                cudaStream_t stream) {
  const int nq_tiles = (sq + kBQ - 1) / kBQ;
  if (bh == 0 || nq_tiles == 0) return kNoLaunch;
  constexpr size_t smem = scalar_smem_bytes<D>();
  static std::atomic<uint64_t> ready{0};
  const int err = allow_smem(flash_fwd_fp32_kernel<D>, smem, ready);
  if (err != cudaSuccess) return err;
  flash_fwd_fp32_kernel<D>
      <<<dim3((unsigned)bh * nq_tiles), kScalarThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), nq_tiles, sq,
          skv, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
               int sq, int skv, float scale, int causal,
               cudaStream_t stream) {
  const int nq_tiles = (sq + kBQ - 1) / kBQ;
  if (bh == 0 || nq_tiles == 0) return kNoLaunch;
  constexpr size_t smem = mma_smem_bytes<D>();
  static std::atomic<uint64_t> ready{0};
  const int err = allow_smem(flash_fwd_mma_kernel<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<T, D>
      <<<dim3((unsigned)bh * nq_tiles), kMmaThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), nq_tiles, sq, skv,
          scale, causal);
  return cudaGetLastError();
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
// 64 columns x 128 rows with the 128-byte swizzle that wgmma reads.
template <typename T, int D>
bool encode_bsd(CUtensorMap* map, const void* ptr, int bh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)rows * D * sizeof(T)};
  const cuuint32_t box[3] = {kBox, kWgTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int bh, int sq, int skv, float scale, int causal,
                 cudaStream_t stream) {
  const int nq_tiles = (sq + kWgTile - 1) / kWgTile;
  if (bh == 0 || nq_tiles == 0) return kNoLaunch;
  // No key at all: every row's l is 0, so every output is 0.
  if (skv == 0) {
    const cudaError_t err =
        cudaMemsetAsync(o, 0, (size_t)bh * sq * D * sizeof(T), stream);
    return err == cudaSuccess ? kNoLaunch : err;
  }
  // The maps are encoded on every call (a few microseconds on the host)
  // and not cached: they hold the tensors' addresses, which change from
  // call to call.
  CUtensorMap qmap, kmap, vmap;
  if (!encode_bsd<T, D>(&qmap, q, bh, sq) ||
      !encode_bsd<T, D>(&kmap, k, bh, skv) ||
      !encode_bsd<T, D>(&vmap, v, bh, skv))
    return kEncodeFailed;
  constexpr size_t smem = wg_smem_bytes<D>();
  static_assert(smem <= 232448, "more shared memory than a block may use");
  static std::atomic<uint64_t> ready{0};
  int err = allow_smem(flash_fwd_wgmma_kernel<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // Persistent: one CTA per SM (its registers fill the SM), or
  // one per work item when there are fewer.
  const int grid = bh * nq_tiles < sms ? bh * nq_tiles : sms;
  flash_fwd_wgmma_kernel<T, D><<<grid, kWgThreads, smem, stream>>>(
          qmap, kmap, vmap, static_cast<T*>(o), bh, nq_tiles, sq, skv,
          scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_body(int body, const void* q, const void* k, const void* v,
                void* o, int bh, int sq, int skv, float scale, int causal,
                cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (body == 0)
      return launch_fp32<D>(q, k, v, o, bh, sq, skv, scale, causal, stream);
  } else {
    if (body == 1)
      return launch_mma<T, D>(q, k, v, o, bh, sq, skv, scale, causal,
                              stream);
    if constexpr (D == 64 || D == 128) {
      if (body == 2)
        return launch_wgmma<T, D>(q, k, v, o, bh, sq, skv, scale, causal,
                                  stream);
    }
  }
  return kUnsupported;
}

template <typename T>
int dispatch_dim(int body, const void* q, const void* k, const void* v,
                 void* o, int bh, int sq, int skv, int head_dim, float scale,
                 int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_body<T, 16>(body, q, k, v, o, bh, sq, skv, scale, causal,
                                stream);
    case 32:
      return launch_body<T, 32>(body, q, k, v, o, bh, sq, skv, scale, causal,
                                stream);
    case 64:
      return launch_body<T, 64>(body, q, k, v, o, bh, sq, skv, scale, causal,
                                stream);
    case 128:
      return launch_body<T, 128>(body, q, k, v, o, bh, sq, skv, scale,
                                 causal, stream);
    default:
      return kUnsupported;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 fp32, 1 fp16,
// 2 bf16.  body: 0 the fp32 scalar body, 1 mma.sync, 2 wgmma.  Returns
// the cudaError_t of the launch (0 on success), -1 for a body that does
// not take this dtype and head dim, -2 if a tensor map cannot be encoded,
// -3 if the output was complete without a kernel (it is empty, or has no
// key and was zeroed).
extern "C" int hvd_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, int bh, int sq, int skv,
                                  int head_dim, int dtype, int body,
                                  float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(body, q, k, v, o, bh, sq, skv, head_dim,
                                 scale, causal, s);
    case 1:
      return dispatch_dim<__half>(body, q, k, v, o, bh, sq, skv, head_dim,
                                  scale, causal, s);
    case 2:
      return dispatch_dim<__nv_bfloat16>(body, q, k, v, o, bh, sq, skv,
                                         head_dim, scale, causal, s);
    default:
      return kUnsupported;
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
