// BatchNorm over NCHW channels, forward and backward, hand-written CUDA
// C++ for Hopper (sm_90a): fp32 statistics, then normalise with the
// block's residual and ReLU fused in; the backward one pass of sums,
// then one of the input's gradient.
//
// Replaces no Pallas kernel.  The JAX package leaves flax's
// nn.BatchNorm to XLA, which fuses the statistics, the normalisation,
// the residual add and the ReLU of a ResNet block around its
// convolutions.  In eager PyTorch the same formula
// (horovod_tpu_torch/ops/batch_norm.py batch_norm_plain) runs as some
// twenty launches a layer forward and as many backward, each streaming
// the whole activation in fp32, and autograd keeps two fp32 copies of
// it.  This file is the layer as four kernels:
//
// * hvd_batchnorm_stats: per channel, sum x and sum x^2 in fp32; then,
//   once per channel, mean = S / M, var = max(E[x^2] - mean^2, 0)
//   (flax's formula, the clamp included), rstd = 1 / sqrt(var + eps),
//   and the running statistics updated in place with the momentum and
//   the biased variance.  Writes stats [3, C]: mean, rstd, and 1 where
//   the clamp passed E[x^2] - mean^2 (0 where it cut it off).
// * hvd_batchnorm_apply: y = act((x - mean) * a + beta [+ r]), a = rstd
//   * gamma, in fp32, rounded once to the output type; act is ReLU or
//   none.  In eval mode it reads the running statistics directly.
// * hvd_batchnorm_bwd_stats: g = dy * [y > 0] (the mask only where ReLU
//   was fused), per channel sum g (d beta) and rstd * sum g (x - mean)
//   (d gamma), written into the fp32 parameter gradients.
// * hvd_batchnorm_bwd_apply: dx = a (g - sum g / M - xhat sum g xhat /
//   M), the last term left out where the clamp was active (clamp_min
//   passes no gradient there), both batch terms left out in eval mode;
//   dr = g where the residual was fused.
//
// Bound: bytes.  The norm moves x in and y out forward, dy and x in and
// dx out backward: 10 bytes an element at 16 bits, about 14.2 GB a
// ResNet-50 step at batch 128, 4.25 ms at 3.35 TB/s.  The design reads
// x twice forward (statistics, then apply; small layers find it in the
// 50 MB L2 the second time) and dy, x and the saved output y twice
// backward, about 20 bytes an element.  Every pass streams whole
// channels: a block walks one channel's share of the N x HW values,
// kUnroll vector loads in flight a thread, 16 bytes a load where the
// row length HW allows it (12,544 to 784 in ResNet-50), 8 at HW 196, 2
// at HW 49.  A channel's N x HW values are split over as many blocks
// as fill the card once (C x splits = the SMs times the blocks each
// holds), so the stem's 64 channels of 1.6 M values and stage 4's 2,048
// of 6,272 both fill it.  Splits' partial sums go to a workspace and
// are added in split order by the channel's last block, which a ticket
// counter names (the counter is reset by that block): no floating-point
// atomics, so a call gives the same bits every time.  Nothing is read
// back to the host.
//
// The kernels allocate nothing and launch on the caller's stream; the
// wrapper (ops/batch_norm.py) owns the workspace, one per stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kUnsupported = -1;
constexpr int kNoLaunch = -3;

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of one row, loaded and stored as one access.
template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

// [N, C, HWv] in vectors; M values a channel.
struct Shape {
  int n, c, hwv;
  long long mv;   // vectors a channel: N x HWv
  float count;    // values a channel: N x HW
};

// One thread's walk over its channel's vectors lo + t, lo + t +
// kThreads, ... below hi: (image, vector in row), stepped without
// division.
struct Walk {
  long long n, row;   // image; C x HWv, the distance between images
  long long base;     // c x HWv
  int i, hwv, dn, di;
  int count;          // vectors this thread visits

  __device__ Walk(const Shape& s, int c, long long lo, long long hi) {
    const long long j = lo + threadIdx.x;
    count = j < hi ? static_cast<int>((hi - j + kThreads - 1) / kThreads) : 0;
    hwv = s.hwv;
    n = j / hwv;
    i = static_cast<int>(j - n * hwv);
    row = static_cast<long long>(s.c) * hwv;
    base = static_cast<long long>(c) * hwv;
    dn = kThreads / hwv;
    di = kThreads % hwv;
  }
  __device__ __forceinline__ long long offset() const {
    return n * row + base + i;
  }
  __device__ __forceinline__ void step() {
    i += di;
    n += dn;
    if (i >= hwv) {
      i -= hwv;
      ++n;
    }
  }
};

// Calls use(offset, load(offset)) for each vector of the walk, kUnroll
// loads issued before their uses.
template <typename Load, typename Use>
__device__ __forceinline__ void walk(Walk w, Load load, Use use) {
  using Loaded = decltype(load(0LL));
  int k = 0;
  for (; k + kUnroll <= w.count; k += kUnroll) {
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      off[u] = w.offset();
      w.step();
    }
    Loaded v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load(off[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) use(off[u], v[u]);
  }
  for (; k < w.count; ++k) {
    const long long o = w.offset();
    w.step();
    use(o, load(o));
  }
}

// This block's share [lo, hi) of its channel's vectors.
__device__ __forceinline__ void block_range(const Shape& s, int splits,
                                            long long* lo, long long* hi) {
  const long long chunk = (s.mv + splits - 1) / splits;
  *lo = blockIdx.x * chunk;
  *hi = min(s.mv, *lo + chunk);
}

// The block's sums of (a, b), in a fixed order; valid in thread 0.
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float2 warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t.x += warp_sums[w].x;
      t.y += warp_sums[w].y;
    }
  }
  return t;
}

// Thread 0 of every block: files the block's sums of channel c; returns
// true in the channel's last block, with the channel's sums, added in
// split order, in *total.  The last block resets the channel's ticket.
__device__ __forceinline__ bool channel_sum(float2 mine, int c, int splits,
                                            float2* partial,
                                            unsigned* tickets,
                                            float2* total) {
  if (splits == 1) {
    *total = mine;
    return true;
  }
  partial[static_cast<long long>(c) * splits + blockIdx.x] = mine;
  __threadfence();
  if (atomicAdd(&tickets[c], 1u) != static_cast<unsigned>(splits - 1))
    return false;
  __threadfence();
  float2 t = make_float2(0.f, 0.f);
  for (int k = 0; k < splits; ++k) {
    const float2 p = __ldcg(&partial[static_cast<long long>(c) * splits + k]);
    t.x += p.x;
    t.y += p.y;
  }
  tickets[c] = 0;
  *total = t;
  return true;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    hvd_batchnorm_stats(const T* __restrict__ x, Shape s, int splits,
                        float* __restrict__ stats, float* running_mean,
                        float* running_var, float momentum,
                        float one_minus_momentum, float eps,
                        float2* partial, unsigned* tickets) {
  const int c = blockIdx.y;
  long long lo, hi;
  block_range(s, splits, &lo, &hi);
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  float sum = 0.f, sq = 0.f;
  walk(Walk(s, c, lo, hi), [&](long long o) { return xv[o]; },
       [&](long long, const Vec<T, V>& v) {
#pragma unroll
         for (int k = 0; k < V; ++k) {
           const float f = to_f(v.v[k]);
           sum += f;
           sq = fmaf(f, f, sq);
         }
       });
  const float2 mine = block_sum(sum, sq);
  float2 t;
  if (threadIdx.x != 0 || !channel_sum(mine, c, splits, partial, tickets, &t))
    return;
  const float mean = __fdiv_rn(t.x, s.count);
  const float raw = __fsub_rn(__fdiv_rn(t.y, s.count), __fmul_rn(mean, mean));
  // NaN stays NaN, as clamp_min keeps it.
  const float var = raw < 0.f ? 0.f : raw;
  stats[c] = mean;
  stats[s.c + c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  stats[2 * s.c + c] = raw >= 0.f ? 1.f : 0.f;
  if (running_mean != nullptr) {
    running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], momentum),
                                __fmul_rn(mean, one_minus_momentum));
    running_var[c] = __fadd_rn(__fmul_rn(running_var[c], momentum),
                               __fmul_rn(var, one_minus_momentum));
  }
}

template <typename T, int V> struct Pair { Vec<T, V> a, b; };
template <typename T, int V> struct Triple { Vec<T, V> a, b, c; };

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    hvd_batchnorm_apply(const T* __restrict__ x, const T* __restrict__ r,
                        T* __restrict__ y, Shape s, int splits,
                        const float* __restrict__ mean,
                        const float* __restrict__ rs, int rs_is_var,
                        float eps, const float* __restrict__ gamma,
                        const float* __restrict__ beta, int relu) {
  const int c = blockIdx.y;
  long long lo, hi;
  block_range(s, splits, &lo, &hi);
  const float mu = mean[c];
  const float rstd =
      rs_is_var ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(rs[c], eps))) : rs[c];
  const float a = rstd * gamma[c];
  const float b = beta[c];
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  const Vec<T, V>* rv = reinterpret_cast<const Vec<T, V>*>(r);
  Vec<T, V>* yv = reinterpret_cast<Vec<T, V>*>(y);
  walk(Walk(s, c, lo, hi),
       [&](long long o) {
         Pair<T, V> p;
         p.a = xv[o];
         if (rv != nullptr) p.b = rv[o];
         return p;
       },
       [&](long long o, const Pair<T, V>& p) {
         Vec<T, V> out;
#pragma unroll
         for (int k = 0; k < V; ++k) {
           float f = (to_f(p.a.v[k]) - mu) * a + b;
           if (rv != nullptr) f += to_f(p.b.v[k]);
           if (relu && f < 0.f) f = 0.f;
           out.v[k] = from_f<T>(f);
         }
         yv[o] = out;
       });
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    hvd_batchnorm_bwd_stats(const T* __restrict__ dy, const T* __restrict__ y,
                            const T* __restrict__ x, Shape s, int splits,
                            const float* __restrict__ stats, float* dgamma,
                            float* dbeta, float2* partial,
                            unsigned* tickets) {
  const int c = blockIdx.y;
  long long lo, hi;
  block_range(s, splits, &lo, &hi);
  const float mu = stats[c];
  const Vec<T, V>* dyv = reinterpret_cast<const Vec<T, V>*>(dy);
  const Vec<T, V>* yv = reinterpret_cast<const Vec<T, V>*>(y);
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  float sg = 0.f, sgx = 0.f;
  walk(Walk(s, c, lo, hi),
       [&](long long o) {
         Triple<T, V> t;
         t.a = dyv[o];
         if (yv != nullptr) t.b = yv[o];
         t.c = xv[o];
         return t;
       },
       [&](long long, const Triple<T, V>& t) {
#pragma unroll
         for (int k = 0; k < V; ++k) {
           float g = to_f(t.a.v[k]);
           if (yv != nullptr && !(to_f(t.b.v[k]) > 0.f)) g = 0.f;
           sg += g;
           sgx = fmaf(g, to_f(t.c.v[k]) - mu, sgx);
         }
       });
  const float2 mine = block_sum(sg, sgx);
  float2 total;
  if (threadIdx.x != 0 ||
      !channel_sum(mine, c, splits, partial, tickets, &total))
    return;
  dbeta[c] = total.x;
  dgamma[c] = total.y * stats[s.c + c];
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    hvd_batchnorm_bwd_apply(const T* __restrict__ dy, const T* __restrict__ y,
                            const T* __restrict__ x, T* __restrict__ dx,
                            T* __restrict__ dr, Shape s, int splits,
                            const float* __restrict__ stats,
                            const float* __restrict__ gamma,
                            const float* __restrict__ dgamma,
                            const float* __restrict__ dbeta, int train) {
  const int c = blockIdx.y;
  long long lo, hi;
  block_range(s, splits, &lo, &hi);
  const float mu = stats[c], rstd = stats[s.c + c];
  const bool keep = stats[2 * s.c + c] != 0.f;
  const float a = rstd * gamma[c];
  const float inv_m = 1.f / s.count;
  // dx = a g - c_g - c_x (x - mean)
  const float c_g = train ? a * dbeta[c] * inv_m : 0.f;
  const float c_x = train && keep ? a * rstd * dgamma[c] * inv_m : 0.f;
  const Vec<T, V>* dyv = reinterpret_cast<const Vec<T, V>*>(dy);
  const Vec<T, V>* yv = reinterpret_cast<const Vec<T, V>*>(y);
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  Vec<T, V>* dxv = reinterpret_cast<Vec<T, V>*>(dx);
  Vec<T, V>* drv = reinterpret_cast<Vec<T, V>*>(dr);
  walk(Walk(s, c, lo, hi),
       [&](long long o) {
         Triple<T, V> t;
         t.a = dyv[o];
         if (yv != nullptr) t.b = yv[o];
         t.c = xv[o];
         return t;
       },
       [&](long long o, const Triple<T, V>& t) {
         Vec<T, V> gx, gr;
#pragma unroll
         for (int k = 0; k < V; ++k) {
           float g = to_f(t.a.v[k]);
           if (yv != nullptr && !(to_f(t.b.v[k]) > 0.f)) g = 0.f;
           gx.v[k] = from_f<T>(a * g - c_g - c_x * (to_f(t.c.v[k]) - mu));
           gr.v[k] = from_f<T>(g);
         }
         dxv[o] = gx;
         if (drv != nullptr) drv[o] = gr;
       });
}

// Streaming multiprocessors of the current device, read once a device.
int sm_count(int* count) {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return kUnsupported;
  int n = counts[dev].load();
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    counts[dev].store(n);
  }
  *count = n;
  return cudaSuccess;
}

// Blocks of kThreads one SM holds of kernel K, read once an instance.
template <typename K>
int blocks_per_sm(K kernel, std::atomic<int>& cache, int* out) {
  int b = cache.load();
  if (b == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (b < 1) b = 1;
    cache.store(b);
  }
  *out = b;
  return cudaSuccess;
}

// Splits of each channel: as many blocks in all as the card holds at
// once, each thread with at least two vectors, no more than the
// workspace has room for (most: its pairs, or -1 for no limit).
template <typename K>
int launch_grid(K kernel, std::atomic<int>& cache, const Shape& s,
                long long most, int* splits) {
  int sms = 0, per_sm = 0;
  int err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm(kernel, cache, &per_sm);
  if (err != cudaSuccess) return err;
  long long n = static_cast<long long>(sms) * per_sm / s.c;
  const long long useful = (s.mv + 2 * kThreads - 1) / (2 * kThreads);
  if (n > useful) n = useful;
  if (most >= 0 && n * s.c > most) n = most / s.c;
  *splits = n < 1 ? 1 : static_cast<int>(n);
  return cudaSuccess;
}

// The widest vector of V values, of 16, 8 or the element's own bytes,
// that divides the row and every pointer's alignment.
template <typename T>
int vector_width(int hw, uintptr_t ptrs) {
  constexpr int wide = 16 / sizeof(T);
  for (int v : {wide, 8 / static_cast<int>(sizeof(T))})
    if (hw % v == 0 && (ptrs % (v * sizeof(T))) == 0) return v;
  return 1;
}

template <typename F>
int with_type(int dtype, F&& f) {
  switch (dtype) {
    case kF32: return f(float{});
    case kF16: return f(__half{});
    case kBF16: return f(__nv_bfloat16{});
  }
  return kUnsupported;
}

// Calls f with std::integral_constant<int, V> for the widths compiled:
// 16 and 8 bytes, and one value.
template <typename T, typename F>
int with_width(int v, F&& f) {
  constexpr int wide = 16 / sizeof(T), half = 8 / sizeof(T);
  if (v == wide) return f(std::integral_constant<int, wide>{});
  if (v == half) return f(std::integral_constant<int, half>{});
  if (v == 1) return f(std::integral_constant<int, 1>{});
  return kUnsupported;
}

int make_shape(int n, int c, int hw, int v, Shape* s) {
  if (n < 0 || c < 0 || hw < 0 || c > 65535) return kUnsupported;
  if (n == 0 || c == 0 || hw == 0) return kNoLaunch;
  s->n = n;
  s->c = c;
  s->hwv = hw / v;
  s->mv = static_cast<long long>(n) * s->hwv;
  s->count = static_cast<float>(static_cast<double>(n) * hw);
  return 0;
}

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

// Launches one kernel of kernels K<T, V> on `stream`, with V the widest
// vector the row and the pointers `ptrs` allow: make(K<T, V>, shape,
// &splits) returns 0 after choosing the splits, launch(K<T, V>, shape,
// splits) enqueues it.
template <typename T, typename Make, typename Launch>
int launch_widest(int n, int c, int hw, uintptr_t ptrs, Make&& make,
                  Launch&& launch) {
  return with_width<T>(vector_width<T>(hw, ptrs), [&](auto width) {
    constexpr int V = decltype(width)::value;
    Shape s;
    int err = make_shape(n, c, hw, V, &s);
    if (err != 0) return err;
    int splits = 1;
    err = make(width, s, &splits);
    if (err != cudaSuccess) return err;
    launch(width, s, splits);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Each entry enqueues a pass of the layer on `stream` and returns 0, a
// CUDA error (> 0), -1 for what it does not take, or -3 where there is
// nothing to do.  dtype: 0 fp32, 1 fp16, 2 bf16.  workspace: `pairs`
// float2 partial sums, then `pairs` unsigned tickets, zero between calls
// (pairs >= c).  Null pointers: r (no residual), running_mean and
// running_var in training (no update), y in the backward (no ReLU was
// fused), dr (no residual was fused).

// The forward: in training hvd_batchnorm_stats (stats [3, C] written,
// the running statistics updated), then hvd_batchnorm_apply from stats;
// otherwise hvd_batchnorm_apply alone, from the running statistics.
extern "C" int hvd_bn_forward(const void* x, const void* r, void* y,
                              int dtype, int n, int c, int hw, int train,
                              float* stats, float* running_mean,
                              float* running_var, float momentum,
                              float one_minus_momentum, float eps,
                              const float* gamma, const float* beta,
                              int relu, float* workspace, int pairs,
                              void* stream) {
  if (pairs < c) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* partial = reinterpret_cast<float2*>(workspace);
  unsigned* tickets = reinterpret_cast<unsigned*>(workspace + 2 * pairs);
  return with_type(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (train) {
      int err = launch_widest<T>(
          n, c, hw, addr(x),
          [&](auto w, const Shape& s, int* splits) {
            static std::atomic<int> cache{0};
            return launch_grid(hvd_batchnorm_stats<T, decltype(w)::value>,
                               cache, s, pairs, splits);
          },
          [&](auto w, const Shape& s, int splits) {
            hvd_batchnorm_stats<T, decltype(w)::value>
                <<<dim3(splits, c), kThreads, 0, st>>>(
                    static_cast<const T*>(x), s, splits, stats,
                    running_mean, running_var, momentum, one_minus_momentum,
                    eps, partial, tickets);
          });
      if (err != 0) return err;
    }
    const float* mean = train ? stats : running_mean;
    const float* rs = train ? stats + c : running_var;
    return launch_widest<T>(
        n, c, hw, addr(x) | addr(r) | addr(y),
        [&](auto w, const Shape& s, int* splits) {
          static std::atomic<int> cache{0};
          return launch_grid(hvd_batchnorm_apply<T, decltype(w)::value>,
                             cache, s, -1, splits);
        },
        [&](auto w, const Shape& s, int splits) {
          hvd_batchnorm_apply<T, decltype(w)::value>
              <<<dim3(splits, c), kThreads, 0, st>>>(
                  static_cast<const T*>(x), static_cast<const T*>(r),
                  static_cast<T*>(y), s, splits, mean, rs, !train, eps,
                  gamma, beta, relu);
        });
  });
}

// The backward: hvd_batchnorm_bwd_stats (dgamma and dbeta written), then
// hvd_batchnorm_bwd_apply (dx, and dr where given).  stats [3, C] as the
// forward wrote it, or in eval mode the running mean, the running rstd
// and zeros.
extern "C" int hvd_bn_backward(const void* dy, const void* y, const void* x,
                               void* dx, void* dr, int dtype, int n, int c,
                               int hw, int train, const float* stats,
                               const float* gamma, float* dgamma,
                               float* dbeta, float* workspace, int pairs,
                               void* stream) {
  if (pairs < c) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* partial = reinterpret_cast<float2*>(workspace);
  unsigned* tickets = reinterpret_cast<unsigned*>(workspace + 2 * pairs);
  return with_type(dtype, [&](auto tag) {
    using T = decltype(tag);
    const uintptr_t in = addr(dy) | addr(y) | addr(x);
    int err = launch_widest<T>(
        n, c, hw, in,
        [&](auto w, const Shape& s, int* splits) {
          static std::atomic<int> cache{0};
          return launch_grid(hvd_batchnorm_bwd_stats<T, decltype(w)::value>,
                             cache, s, pairs, splits);
        },
        [&](auto w, const Shape& s, int splits) {
          hvd_batchnorm_bwd_stats<T, decltype(w)::value>
              <<<dim3(splits, c), kThreads, 0, st>>>(
                  static_cast<const T*>(dy), static_cast<const T*>(y),
                  static_cast<const T*>(x), s, splits, stats, dgamma, dbeta,
                  partial, tickets);
        });
    if (err != 0) return err;
    return launch_widest<T>(
        n, c, hw, in | addr(dx) | addr(dr),
        [&](auto w, const Shape& s, int* splits) {
          static std::atomic<int> cache{0};
          return launch_grid(hvd_batchnorm_bwd_apply<T, decltype(w)::value>,
                             cache, s, -1, splits);
        },
        [&](auto w, const Shape& s, int splits) {
          hvd_batchnorm_bwd_apply<T, decltype(w)::value>
              <<<dim3(splits, c), kThreads, 0, st>>>(
                  static_cast<const T*>(dy), static_cast<const T*>(y),
                  static_cast<const T*>(x), static_cast<T*>(dx),
                  static_cast<T*>(dr), s, splits, stats, gamma, dgamma,
                  dbeta, train);
        });
  });
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
