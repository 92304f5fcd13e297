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
// predicated and the tail is masked, so the host pads nothing.
//
// Design.  On the TPU the kv-block grid axis runs in order and carries
// m/l/acc in VMEM scratch between grid steps.  Here blocks run in no
// order, so one CTA owns one (bh, 64-row q tile) and walks the 64-key
// kv tiles in a loop, keeping m/l/acc in registers.  Causal runs stop at
// the last kv tile that holds a key <= the tile's last query row, as the
// TPU kernel skips fully masked blocks.  Two bodies share that frame:
//
// * bf16 / fp16 (the training path): four warps, 16 query rows each.
//   Both products run on the tensor cores as mma.sync m16n8k16 with fp32
//   accumulators.  A warp keeps its Q fragments in registers for the
//   whole kv loop.  K and V tiles arrive by cp.async into two stages of
//   shared memory, the next tile's copy in flight while this one
//   computes; rows are padded by 16 bytes so fragment loads hit 32
//   banks.  K as [key][d] is the column-major B operand of Q.K^T; V's B
//   fragments come from the same [key][d] layout by a transposing
//   ldmatrix.  The score accumulators' layout is the A layout of P.V,
//   so P goes from registers (rounded to the input type) straight into
//   the second mma.  A row's four owners are one lane quad: row max and
//   row sum are two xor-shuffles.
// * fp32: the products stay in fp32 (the reference's precision) as
//   scalar FMAs from shared memory, 256 threads on a 16 x 16 grid.
//
// Bound: at the GPT-2-small training shape (BH = 96, S = 1024, D = 64,
// bf16, causal) the least time is set by bytes: q, k, v read once and o
// written once are 50 MB, 15 us at 3.35 TB/s, against 12.9 GFLOP, 13 us
// at the bf16 tensor-core peak.  This kernel re-reads K and V once per
// q tile (from L2), keeps one CTA's warps in lock step at each tile's
// barrier, and uses neither TMA nor wgmma, so it sits above that bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// launch
// ---------------------------------------------------------------------------
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int skv, float scale, int causal,
                   cudaStream_t stream) {
  const int nq_tiles = (sq + kBQ - 1) / kBQ;
  if (bh == 0 || nq_tiles == 0) return cudaSuccess;
  const dim3 grid((unsigned)bh * nq_tiles);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    constexpr size_t smem = scalar_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_fp32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_fp32_kernel<D><<<grid, kScalarThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), nq_tiles, sq,
        skv, scale, causal);
  } else {
    constexpr size_t smem = mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_mma_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), nq_tiles, sq, skv,
        scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o, int bh,
                 int sq, int skv, int head_dim, float scale, int causal,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, bh, sq, skv, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, bh, sq, skv, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, skv, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, skv, scale, causal, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 fp32, 1 fp16,
// 2 bf16.  Returns the cudaError_t of the launch (0 on success), or -1
// for a head dim or dtype the kernel is not built for.
extern "C" int hvd_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, int bh, int sq, int skv,
                                  int head_dim, int dtype, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(q, k, v, o, bh, sq, skv, head_dim, scale,
                                 causal, s);
    case 1:
      return dispatch_dim<__half>(q, k, v, o, bh, sq, skv, head_dim, scale,
                                  causal, s);
    case 2:
      return dispatch_dim<__nv_bfloat16>(q, k, v, o, bh, sq, skv, head_dim,
                                         scale, causal, s);
    default:
      return -1;
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
