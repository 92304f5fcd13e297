// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no TPU kernel: the JAX package's backward is plain XLA
// (horovod_tpu/ops/pallas_attention.py:160-171, _flash_vjp_bwd), which
// recomputes the whole S x S probability matrix in fp32 and runs five
// fp32 products over it.  It was added because that recompute, ported as
// plain PyTorch, held half of a GPT-2 training step on the card: fp32
// SIMT matmuls and a dozen passes over 604 MB score tensors per layer.
//
// What it computes, for q [BH, Sq, D], k and v [BH, Skv, D], the output
// gradient do [BH, Sq, D] and the forward's log-sum-exp lse [BH, Sq]
// (fp32, natural log of the scaled scores, written by the wgmma body of
// flash_attn_fwd.cu): with s = q . k^T, P = exp(scale s - lse) under the
// forward's top-left causal mask and keys past Skv masked,
//   dP = do . v^T,  Delta = rowsum(P o dP),  dS = P o (dP - Delta),
//   dq = scale dS . k,  dk = scale dS^T . q,  dv = P^T . do,
// and Delta itself ([BH, Sq], fp32).  Delta comes from P o dP, so the
// forward's output is never saved.  P and dS are rounded to the input
// type as wgmma operands, as the forward rounds P before P.V; every sum
// is fp32.  No atomics: each output element is written by one thread,
// so two calls give the same bits.
//
// Bound: per call the least work is q, k, v, do read and dq, dk, dv
// written (7 BH S D 16-bit values: 132 MB, 39 us at 3.35 TB/s at the
// GPT-2 shape BH 144, S 1024, D 64) against the five products of the
// causal half (2.5 times the forward's FLOPs: 48.4 GFLOP, 49 us at the
// bf16 peak), so the tensor cores bound it.  This design runs nine
// products (P and dP are recomputed in each kernel, and twice in the dq
// kernel), 87 GFLOP, and keeps every S x S tile in registers: nothing of
// size S x S reaches device memory.
//
// Design: two kernels on the caller's stream, each one CTA per work item
// with the forward's warp specialisation.  Warpgroup 0's one elected
// thread loads the item's two resident 128-row tiles once and streams
// 64-row tiles through a ring of kStages shared-memory stages by TMA
// (3-D tensor maps over [BH, S, D] in 64 x 64 boxes with the 128-byte
// swizzle, the tail zero-filled by the hardware; full/empty mbarriers).
// Warpgroups 1 and 2 each own 64 resident rows and run every product as
// wgmma with fp32 accumulators in registers: the two score products from
// shared memory (m64n64k16, both K-major), the gradient products with
// P or dS from registers and the streamed tile as the transposed B
// operand (m64nDk16).  Each consumer waits for its products before it
// touches their registers; the other consumer's products overlap its
// elementwise work.
// * flash_bwd_dq_kernel: a 128-row q tile (resident q, do) walks its kv
//   tiles twice.  The first sweep recomputes P and dP and sums Delta;
//   the second forms dS and accumulates dq.  It writes dq and Delta.
// * flash_bwd_dkdv_kernel: a 128-key kv tile (resident k, v) walks the q
//   tiles that see it, in the transposed orientation: S^T = k . q^T and
//   dP^T = v . do^T put a key in each accumulator row, so P^T and dS^T
//   are A operands of dv += P^T . do and dk += dS^T . q as they stand.
//   Each q tile's lse and Delta reach shared memory through the
//   consumer's own threads, fetched one tile ahead.  Causal items run
//   heaviest first: kv tile 0 sees every q tile.
// Padded q rows (past Sq) read lse +inf and Delta 0, so their P and dS
// are 0 and they add nothing to dk and dv; padded keys are masked in the
// dq kernel and never stored by the dkdv kernel.

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // streamed rows, and resident rows a consumer
constexpr int kRes = 128;      // resident rows of a work item
constexpr int kThreads = 384;  // one producer and two consumer warpgroups
constexpr int kStages = 3;     // ring stages of streamed tile pairs
constexpr int kBoxElems = kTile * kBox;  // one 64 x 64 TMA box

template <int D>
constexpr size_t bwd_smem_bytes() {
  // 1 KB of slack to start the tiles on the 1024-byte swizzle period,
  // then the two resident tensors' 128 rows and kStages pairs of 64-row
  // tiles, D 16-bit values a row.
  return 1024 + (size_t)(4 + 2 * kStages) * kTile * D * 2;
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// S = A0 . X^T and dP = A1 . Y^T (64 x 64 each): A0, A1 a consumer's
// resident 64-row sub-tiles, X, Y a ring stage's tiles, all K-major
// over D.  A k-step of 16 moves 32 bytes along the swizzled 128-byte
// row; columns 64..127 are the second box.
template <typename T, int D>
__device__ __forceinline__ void start_scores(float (&s)[32], float (&dp)[32],
                                             uint64_t da0, uint64_t da1,
                                             uint64_t dx, uint64_t dy) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = ((kk / 4) * kBoxElems + (kk % 4) * 16) * 2 / 16;
    wgmma_ss64<T>(s, da0 + col, dx + col, kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = ((kk / 4) * kBoxElems + (kk % 4) * 16) * 2 / 16;
    wgmma_ss64<T>(dp, da1 + col, dy + col, kk > 0);
  }
  wgmma_commit();
}

// acc (64 x D) += A . B: A a 64 x 64 tile in registers, B a stage's
// 64-row tile read MN-major (transpose flag): a k-step of 16 rows is
// 2048 bytes, 8-row groups 1024 bytes apart, columns 64..127 the next box.
template <typename T, int D>
__device__ __forceinline__ void start_grad(float (&acc)[D / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<T, D>(acc, pa[kk], db + kk * 16 * kBox * 2 / 16);
  wgmma_commit();
}

// Writes a consumer's 64 x D accumulator, times `mul`, to rows
// row0 + rr (+ 8) of a [.., D] tensor, rows at or past `rows` left out.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 2],
                                           float mul, int row0, int rr,
                                           int tq, int rows) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + rr + 8 * r;
    if (row < rows) {
      T* orow = out + (size_t)row * D + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<uint32_t*>(orow + 8 * nt) = pack2<T>(
            acc[4 * nt + 2 * r] * mul, acc[4 * nt + 2 * r + 1] * mul);
    }
  }
}

// dq and Delta for one (bh, 128-row q tile): resident q and do, the kv
// tiles streamed twice (sweep 1: Delta; sweep 2: dq).  Accumulator
// element i of a consumer's 64 x 64 score tile sits at row
// row0 + rr + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 tq + (i & 1).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta, int bh_count,
                        int nq_tiles, int sq, int skv, float scale,
                        int causal) {
  constexpr int BOXES = D / kBox;
  constexpr int TILE = kTile * D;  // elements of a 64-row tile
  constexpr uint32_t kTileBytes = TILE * sizeof(T);
  constexpr uint32_t kStageUnits = 2 * kTileBytes / 16;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __shared__ uint64_t res_full, full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(bwd_smem);
  // q sub-tile c at res + c TILE, do at res + (2 + c) TILE; stage s holds
  // k at ring + 2 s TILE and v after it.
  T* res = reinterpret_cast<T*>(bwd_smem + ((1024u - (raw & 1023u)) & 1023u));
  T* ring = res + 4 * TILE;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (nq_tiles - 1 - (int)blockIdx.x / bh_count) * kRes;
  const int kv_end = causal ? min(skv, q0 + kRes) : skv;
  const int n = (kv_end + kTile - 1) / kTile;  // kv tiles of one sweep
  const int halves = q0 + kTile < sq ? 2 : 1;  // 64-row halves inside Sq

  if (tid == 0) {
    mbar_init(&res_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one release per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(&res_full, 2 * halves * kTileBytes);
      for (int c = 0; c < halves; ++c)
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          tma_load_3d(res + c * TILE + b * kBoxElems, &qmap, &res_full,
                      b * kBox, q0 + c * kTile, bh);
          tma_load_3d(res + (2 + c) * TILE + b * kBoxElems, &domap,
                      &res_full, b * kBox, q0 + c * kTile, bh);
        }
      for (int u = 0; u < 2 * n; ++u) {
        const int s = u % kStages;
        const int j = u < n ? u : u - n;
        if (u >= kStages) mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          tma_load_3d(ring + 2 * s * TILE + b * kBoxElems, &kmap, &full[s],
                      b * kBox, j * kTile, bh);
          tma_load_3d(ring + (2 * s + 1) * TILE + b * kBoxElems, &vmap,
                      &full[s], b * kBox, j * kTile, bh);
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
    const int rr = 16 * (wtid >> 5) + (lane >> 2);
    const int row0 = q0 + kTile * cw;
    // The kv tiles this consumer's rows see; none when they lie past Sq.
    const int n_mine =
        row0 >= sq ? 0
                   : causal ? (min(skv, row0 + kTile) + kTile - 1) / kTile : n;
    const float scale_log2 = scale * kLog2e;
    float lse2[2], dsum[2] = {0.f, 0.f}, acc[D / 2], s[32], dp[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + rr + 8 * r;
      lse2[r] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint64_t da0 = sw128_desc(res + cw * TILE, 16, 1024);
    const uint64_t da1 = sw128_desc(res + (2 + cw) * TILE, 16, 1024);
    const uint64_t dk_kmajor = sw128_desc(ring, 16, 1024);
    const uint64_t dv_kmajor = sw128_desc(ring + TILE, 16, 1024);
    const uint64_t dk_mnmajor = sw128_desc(ring, kBoxElems * 2, 1024);
    if (n_mine > 0) mbar_wait(&res_full, 0);

    for (int u = 0; u < 2 * n; ++u) {
      const int st = u % kStages;
      const int j = u < n ? u : u - n;
      const bool sweep1 = u < n;
      mbar_wait(&full[st], (u / kStages) & 1);
      if (j < n_mine) {
        const uint32_t slot = st * kStageUnits;
        wgmma_fence();
        start_scores<T, D>(s, dp, da0, da1, dk_kmajor + slot,
                           dv_kmajor + slot);
        wgmma_wait<0>();
        pin(s);
        pin(dp);
        // The first sweep is done with the stage once its scores are in.
        mbar_arrive_if(&empty[st], leader && sweep1);
        const int k0 = j * kTile;
        if (k0 + kTile > skv || (causal && k0 + kTile - 1 > row0)) {
          // Key column c of the tile is kept for a row iff c < lim: before
          // Skv and, when causal, at or before the row's own position.
          int lim[2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            lim[r] = (causal ? min(skv - k0, row0 + rr + 8 * r - k0 + 1)
                             : skv - k0) -
                     2 * tq;
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = 8 * (i >> 2) + (i & 1) < lim[(i >> 1) & 1]
                       ? exp2_approx(fmaf(s[i], scale_log2,
                                          -lse2[(i >> 1) & 1]))
                       : 0.f;
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = exp2_approx(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
        }
        if (sweep1) {
#pragma unroll
          for (int i = 0; i < 32; ++i) dsum[(i >> 1) & 1] += s[i] * dp[i];
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = s[i] * (dp[i] - dsum[(i >> 1) & 1]);
          pack_a<T, 4>(pa, s);
          wgmma_fence();
          start_grad<T, D>(acc, pa, dk_mnmajor + slot);
          wgmma_wait<0>();
          pin(acc);
          pin(pa);
          mbar_arrive_if(&empty[st], leader);
        }
      } else {
        mbar_arrive_if(&empty[st], leader);
      }
      if (u == n - 1) {
        // A row's four owners (one lane quad) hold its partial sums.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
          dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
        }
      }
    }
    store_rows<T, D>(dq + (size_t)bh * sq * D, acc, scale, row0, rr, tq, sq);
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + rr + 8 * r;
        if (row < sq) delta[(size_t)bh * sq + row] = dsum[r];
      }
    }
  }
}

// dk and dv for one (bh, 128-key kv tile): resident k and v, the q tiles
// that see it streamed once.  Accumulator element i of a consumer's
// 64 x 64 transposed score tile sits at key kc0 + rr + 8 ((i >> 1) & 1),
// query q0 + 8 (i >> 2) + 2 tq + (i & 1).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv,
                          int bh_count, int sq, int skv, float scale,
                          int causal) {
  constexpr int BOXES = D / kBox;
  constexpr int TILE = kTile * D;
  constexpr uint32_t kTileBytes = TILE * sizeof(T);
  constexpr uint32_t kStageUnits = 2 * kTileBytes / 16;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __shared__ uint64_t res_full, full[kStages], empty[kStages];
  // Per consumer, two buffers of a q tile's lse (log2 units) and Delta.
  __shared__ float rowvals[2][2][2 * kTile];
  const uint32_t raw = smem_u32(bwd_smem);
  // k sub-tile c at res + c TILE, v at res + (2 + c) TILE; stage s holds
  // q at ring + 2 s TILE and do after it.
  T* res = reinterpret_cast<T*>(bwd_smem + ((1024u - (raw & 1023u)) & 1023u));
  T* ring = res + 4 * TILE;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x % bh_count;
  const int k0 = ((int)blockIdx.x / bh_count) * kRes;
  const int nq = (sq + kTile - 1) / kTile;
  // The q tiles that see a key of this item: from its first key's on
  // when causal (top-left: query q sees keys 0..q).
  const int qt0 = causal ? k0 / kTile : 0;
  const int m = max(nq - qt0, 0);
  const int halves = k0 + kTile < skv ? 2 : 1;

  if (tid == 0) {
    mbar_init(&res_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0 && m > 0) {
      mbar_expect_tx(&res_full, 2 * halves * kTileBytes);
      for (int c = 0; c < halves; ++c)
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          tma_load_3d(res + c * TILE + b * kBoxElems, &kmap, &res_full,
                      b * kBox, k0 + c * kTile, bh);
          tma_load_3d(res + (2 + c) * TILE + b * kBoxElems, &vmap,
                      &res_full, b * kBox, k0 + c * kTile, bh);
        }
      for (int i = 0; i < m; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          tma_load_3d(ring + 2 * s * TILE + b * kBoxElems, &qmap, &full[s],
                      b * kBox, (qt0 + i) * kTile, bh);
          tma_load_3d(ring + (2 * s + 1) * TILE + b * kBoxElems, &domap,
                      &full[s], b * kBox, (qt0 + i) * kTile, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = tid / 128 - 1;  // consumer 0 or 1: keys 64 cw ..
    const int wtid = tid % 128;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const bool leader = wtid == 0;
    const int rr = 16 * (wtid >> 5) + (lane >> 2);
    const int kc0 = k0 + kTile * cw;
    const bool active = kc0 < skv;
    const float scale_log2 = scale * kLog2e;
    float acc_dk[D / 2], acc_dv[D / 2], s[32], dp[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    const uint64_t da0 = sw128_desc(res + cw * TILE, 16, 1024);
    const uint64_t da1 = sw128_desc(res + (2 + cw) * TILE, 16, 1024);
    const uint64_t dq_kmajor = sw128_desc(ring, 16, 1024);
    const uint64_t ddo_kmajor = sw128_desc(ring + TILE, 16, 1024);
    const uint64_t dq_mnmajor = sw128_desc(ring, kBoxElems * 2, 1024);
    const uint64_t ddo_mnmajor = sw128_desc(ring + TILE, kBoxElems * 2, 1024);
    // This thread's entry of q tile qt's row values: threads 0..63 the
    // lse in log2 units (+inf past Sq, so P is 0 there), 64..127 Delta.
    auto fetch = [&](int qt) {
      const int q = qt * kTile + (wtid & (kTile - 1));
      if (wtid < kTile)
        return q < sq ? lse[(size_t)bh * sq + q] * kLog2e
                    : __int_as_float(0x7f800000);  // +inf
      return q < sq ? delta[(size_t)bh * sq + q] : 0.f;
    };
    if (m > 0) {
      rowvals[cw][0][wtid] = fetch(qt0);
      warpgroup_sync(1 + cw);
      if (active) mbar_wait(&res_full, 0);
    }

    for (int i = 0; i < m; ++i) {
      const int st = i % kStages;
      const int q0 = (qt0 + i) * kTile;
      const float next = i + 1 < m ? fetch(qt0 + i + 1) : 0.f;
      mbar_wait(&full[st], (i / kStages) & 1);
      // A causal q tile that ends before this consumer's first key sees
      // none of its keys.
      if (active && !(causal && q0 + kTile <= kc0)) {
        const uint32_t slot = st * kStageUnits;
        const float* lv = rowvals[cw][i & 1];
        wgmma_fence();
        start_scores<T, D>(s, dp, da0, da1, dq_kmajor + slot,
                           ddo_kmajor + slot);
        wgmma_wait<0>();
        pin(s);
        pin(dp);
        if (causal && q0 < kc0 + kTile) {
          // The diagonal tile: query column c is kept for a key iff
          // q0 + c >= the key.
#pragma unroll
          for (int i2 = 0; i2 < 32; ++i2) {
            const int c = 8 * (i2 >> 2) + 2 * tq + (i2 & 1);
            const int key = kc0 + rr + 8 * ((i2 >> 1) & 1);
            s[i2] = q0 + c >= key
                        ? exp2_approx(fmaf(s[i2], scale_log2, -lv[c]))
                        : 0.f;
          }
        } else {
#pragma unroll
          for (int i2 = 0; i2 < 32; ++i2) {
            const int c = 8 * (i2 >> 2) + 2 * tq + (i2 & 1);
            s[i2] = exp2_approx(fmaf(s[i2], scale_log2, -lv[c]));
          }
        }
        pack_a<T, 4>(pa, s);
        wgmma_fence();
        start_grad<T, D>(acc_dv, pa, ddo_mnmajor + slot);  // dv += P^T . do
        wgmma_wait<0>();
        pin(acc_dv);
        pin(pa);
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) {
          const int c = 8 * (i2 >> 2) + 2 * tq + (i2 & 1);
          s[i2] = s[i2] * (dp[i2] - lv[kTile + c]);
        }
        pack_a<T, 4>(pa, s);
        wgmma_fence();
        start_grad<T, D>(acc_dk, pa, dq_mnmajor + slot);  // dk += dS^T . q
        wgmma_wait<0>();
        pin(acc_dk);
        pin(pa);
      }
      mbar_arrive_if(&empty[st], leader);
      if (i + 1 < m) {
        // Buffer (i + 1) & 1 was last read in tile i - 1, before the
        // barrier that ended it.
        rowvals[cw][(i + 1) & 1][wtid] = next;
        warpgroup_sync(1 + cw);
      }
    }
    if (active) {
      store_rows<T, D>(dk + (size_t)bh * skv * D, acc_dk, scale, kc0, rr, tq,
                       skv);
      store_rows<T, D>(dv + (size_t)bh * skv * D, acc_dv, 1.f, kc0, rr, tq,
                       skv);
    }
  }
}

constexpr int kUnsupported = -1;   // dtype and head dim not taken
constexpr int kEncodeFailed = -2;  // cuTensorMapEncodeTiled refused a map
constexpr int kNoLaunch = -3;      // an empty input: no kernel started

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* delta,
           int bh, int sq, int skv, float scale, int causal,
           cudaStream_t stream) {
  if (bh == 0 || sq == 0 || skv == 0) return kNoLaunch;
  // The maps hold the tensors' addresses, so they are encoded each call.
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_bsd<T, D>(&qmap, q, bh, sq, kTile) ||
      !encode_bsd<T, D>(&kmap, k, bh, skv, kTile) ||
      !encode_bsd<T, D>(&vmap, v, bh, skv, kTile) ||
      !encode_bsd<T, D>(&domap, dout, bh, sq, kTile))
    return kEncodeFailed;
  constexpr size_t smem = bwd_smem_bytes<D>();
  static_assert(smem + 2 * 2 * 2 * kTile * 4 <= 232448,
                "more shared memory than a block may use");
  static std::atomic<uint64_t> ready_dq{0}, ready_dkdv{0};
  int err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, ready_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem, ready_dkdv);
  if (err != cudaSuccess) return err;
  const int nq_tiles = (sq + kRes - 1) / kRes;
  const int nk_tiles = (skv + kRes - 1) / kRes;
  flash_bwd_dq_kernel<T, D><<<bh * nq_tiles, kThreads, smem, stream>>>(
      qmap, kmap, vmap, domap, lse, static_cast<T*>(dq), delta, bh,
      nq_tiles, sq, skv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<bh * nk_tiles, kThreads, smem, stream>>>(
      qmap, kmap, vmap, domap, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), bh, sq, skv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, void* dq, void* dk,
                 void* dv, float* delta, int bh, int sq, int skv,
                 int head_dim, float scale, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, dq, dk, dv, delta, bh, sq,
                           skv, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, dq, dk, dv, delta, bh, sq,
                            skv, scale, causal, stream);
    default:
      return kUnsupported;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 1 fp16, 2 bf16; head
// dim 64 or 128.  q, k, v, dout, dq, dk, dv are [bh, s, head_dim] in
// dtype, contiguous and 16-byte aligned; lse (the forward's) and delta
// are fp32 [bh, sq].  Launches the dq kernel, then the dkdv kernel, on
// `stream`.  Returns the cudaError_t of the launches (0 on success), -1
// for a dtype or head dim it does not take, -2 if a tensor map cannot be
// encoded, -3 if an input is empty and nothing was launched.
extern "C" int hvd_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  void* dq, void* dk, void* dv, float* delta,
                                  int bh, int sq, int skv, int head_dim,
                                  int dtype, float scale, int causal,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_dim<__half>(q, k, v, dout, lse, dq, dk, dv, delta, bh,
                                  sq, skv, head_dim, scale, causal, s);
    case 2:
      return dispatch_dim<__nv_bfloat16>(q, k, v, dout, lse, dq, dk, dv,
                                         delta, bh, sq, skv, head_dim, scale,
                                         causal, s);
    default:
      return kUnsupported;
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
