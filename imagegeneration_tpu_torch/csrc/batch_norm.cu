// BatchNorm over every axis but the channels, with the activation that
// follows it fused, forward and backward, over a (rows, C) row-major matrix:
// a (B, features) input, or a channels_last (NHWC) map as its N*H*W rows.
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm and the
// ReLU / LeakyReLU after it to XLA, which fuses them. In eager PyTorch the
// same arithmetic ran as ~30 float32 ops forward and ~40 backward a site,
// moving ~200 bytes an element (PERF.md §6). ops/batch_norm.py holds the
// plain version and the arithmetic:
//
//   statistics: s1 = sum x, s2 = sum x^2 per channel (float32; each x^2
//               rounded before it is added, as the plain version's)
//   apply:      mean = s1 / N, var = max(s2 / N - mean^2, 0) (flax's fast
//               variance), or the running statistics; rstd = rsqrt(var + eps),
//               mul = rstd * scale; t = round((x - mean) * mul + bias);
//               y = t, or t > 0 ? t : (slope == 0 ? 0 : round(t * slope));
//               the running statistics momentum * r + (1 - momentum) * v
//   reduce:     g = dy through the activation's mask (t rebuilt from x and
//               the saved mean and rstd); xhat = (x - mean) * rstd;
//               sums [sum g, sum g * xhat] (dbias, dscale)
//   apply back: dx = mul * (g - sum g / N - xhat * sum g xhat / N), or
//               mul * g with the running statistics
//
// Bound on the H100: device-memory bandwidth. The work reads x and writes y
// forward, reads x and dy and writes dx backward: 10 bytes an element in
// bfloat16. Statistics over N elements a channel have to be complete before
// any element is normalised, and N spans the whole matrix (millions of
// rows at the SNDCGAN generator's maps), so each direction is two passes:
// one that reduces (reads x; reads x and dy) and one that applies (reads x,
// writes y; reads x and dy, writes dx): 16 bytes an element, at best 62%
// of the work's bound. Between the passes the caller may all-reduce the
// sums over ranks (data parallelism). What the design does about the bytes:
//
// - 16-byte loads and stores, neighbouring lanes on neighbouring channels:
//   a CTA's row segment is one or two 128-byte lines (up to 128 bfloat16 or
//   64 float32 channels), so a warp reads whole lines of whole rows, and a
//   thread has kUnroll = 8 loads in flight before it uses any: 8 rows of x,
//   or 4 rows of x and 4 of dy. (8 rows of each held 224 registers a thread,
//   one CTA an SM, and the reduce took 0.58 ms at the largest SNDCGAN site
//   against 0.44 with 4; 16 loads in flight were slower in three of the
//   four kernels: tools/bn_times.py --sweep, PERF.md §6.)
// - One grid for the four kernels (`launch_plan`): channel blocks by row
//   chunks, about two CTAs an SM. A wide matrix of few rows (the stem's
//   294,912 channels of 128 rows) is hundreds of wider channel blocks of one
//   chunk each, whose CTA writes its block's sums itself; a narrow one (C
//   64-256, millions of rows) is one or two blocks of 132-264 chunks.
// - No float atomics: a chunk's CTA writes its partial row, takes a ticket
//   (atomicInc after a release fence, which wraps the counter back to 0),
//   and the last CTA of the block adds the chunks' rows in chunk order, so
//   two calls give the same bits. The applies recompute mean, rstd and mul
//   per thread from the sums (a few operations per channel), and the CTAs
//   of chunk 0 write the saved mean and rstd and the running statistics.
// - The backward saves no y and no float32 copy of x: it rebuilds t, and so
//   the activation's mask, from x and the saved statistics with the same
//   explicitly rounded operations (no FMA contraction) as the forward, so
//   the mask is the forward's bit for bit.
//
// C interface: raw pointers, the plan and the CUDA stream; the plan is
// checked (cudaErrorInvalidValue if it is not one this source can run) and
// every entry point returns the launch's error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte loads a thread has in flight
constexpr int kMaxBlocks = 65535;

// Launch plan, computed by ops/batch_norm.py::launch_plan.
struct Plan {
  int rows;        // rows of the matrix
  int c;           // channels (row length)
  int vec;         // channels a lane moves per load: 16 bytes, or 1
  int lanes;       // vector lanes of a CTA (a power of two <= kThreads)
  int chunks;      // row chunks (grid x)
  int chunk_rows;  // rows of a chunk, the last one possibly fewer
};

__host__ __device__ inline int blocks_of(const Plan& p) {
  return (p.c / p.vec + p.lanes - 1) / p.lanes;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

// v rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  T t;
  from_f32(t, v);
  return to_f32(t);
}

// The pre-activation value in float32: (x - mean) * mul + bias.
__device__ __forceinline__ float affine(float x, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

// t = z rounded to T, then the activation (act 0: none).
template <typename T>
__device__ __forceinline__ float activate(float z, int act, float slope) {
  const float t = rounded<T>(z);
  if (!act || t > 0.f) return t;
  return slope == 0.f ? 0.f : rounded<T>(__fmul_rn(t, slope));
}

// dy through the activation at z: its gradient as the plain activation's
// backward gives it (dy * slope rounded to T).
template <typename T>
__device__ __forceinline__ float act_grad(float z, float d, int act, float slope) {
  if (!act || rounded<T>(z) > 0.f) return d;
  return slope == 0.f ? 0.f : rounded<T>(__fmul_rn(d, slope));
}

// Where this thread works: lane `lane` (channels ch .. ch + V - 1) of its
// CTA's channel block, rows row0 + slot, + slots, ... below row1.
struct Geom {
  int lane, slot, slots, ch;
  bool active;  // holds channels < C
  int row0, row1;
};

template <int V>
__device__ __forceinline__ Geom geom(const Plan& p) {
  Geom g;
  g.lane = threadIdx.x % p.lanes;
  g.slot = threadIdx.x / p.lanes;
  g.slots = kThreads / p.lanes;
  g.ch = (blockIdx.y * p.lanes + g.lane) * V;
  g.active = g.ch < p.c;
  g.row0 = blockIdx.x * p.chunk_rows;
  g.row1 = min(p.rows, g.row0 + p.chunk_rows);
  return g;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// f(offset, pack of x[, pack of dy]) for each of the thread's rows, in row
// order, with U rows' loads issued before any is used.
template <typename T, int V, int U, typename F>
__device__ __forceinline__ void each_row(const Geom& g, const Plan& p, const T* __restrict__ x,
                                         F&& f) {
  if (!g.active) return;
  for (int r = g.row0 + g.slot; r < g.row1; r += U * g.slots) {
    Pack<T, V> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ru = r + u * g.slots;
      if (ru < g.row1) v[u] = load_pack<T, V>(x + static_cast<int64_t>(ru) * p.c + g.ch);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ru = r + u * g.slots;
      if (ru < g.row1) f(static_cast<int64_t>(ru) * p.c + g.ch, v[u]);
    }
  }
}

template <typename T, int V, int U, typename F>
__device__ __forceinline__ void each_row2(const Geom& g, const Plan& p, const T* __restrict__ x,
                                          const T* __restrict__ dy, F&& f) {
  if (!g.active) return;
  for (int r = g.row0 + g.slot; r < g.row1; r += U * g.slots) {
    Pack<T, V> v[U], d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ru = r + u * g.slots;
      if (ru < g.row1) {
        const int64_t at = static_cast<int64_t>(ru) * p.c + g.ch;
        v[u] = load_pack<T, V>(x + at);
        d[u] = load_pack<T, V>(dy + at);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ru = r + u * g.slots;
      if (ru < g.row1) f(static_cast<int64_t>(ru) * p.c + g.ch, v[u], d[u]);
    }
  }
}

// The channel block's two sums from each thread's accumulators acc[stat][j]:
// the CTA's, over its row slots in slot order; with one chunk written to
// out (2, C) as they are; else as this chunk's partial row (chunks, 2, C),
// and the last CTA of the block to take a ticket adds the chunks' rows in
// chunk order (split over `groups` thread groups where the block has fewer
// than kThreads values, their totals then added in group order).
template <int V>
__device__ __forceinline__ void block_sums(const float (&acc)[2][V], const Geom& g,
                                           const Plan& p, float* __restrict__ out,
                                           float* __restrict__ partials,
                                           unsigned int* __restrict__ tickets) {
  __shared__ float red[2 * kThreads * V];
  __shared__ unsigned int ticket;
  const int cb = p.lanes * V, nv = 2 * cb;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[(s * g.slots + g.slot) * cb + g.lane * V + j] = acc[s][j];
  }
  __syncthreads();
  const bool one = p.chunks == 1;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const int s = i / cb, lc = i % cb, ch = blockIdx.y * cb + lc;
    float t = 0.f;
    for (int k = 0; k < g.slots; ++k) t += red[(s * g.slots + k) * cb + lc];
    if (ch < p.c) {
      if (one) {
        out[s * p.c + ch] = t;
      } else {
        partials[(static_cast<int64_t>(blockIdx.x) * 2 + s) * p.c + ch] = t;
      }
    }
  }
  if (one) return;
  __threadfence();  // this CTA's partial row is visible before its ticket
  __syncthreads();
  const unsigned int last = static_cast<unsigned int>(p.chunks - 1);
  if (threadIdx.x == 0) ticket = atomicInc(&tickets[blockIdx.y], last);
  __syncthreads();
  if (ticket != last) return;
  __threadfence();

  const int64_t pitch = 2 * static_cast<int64_t>(p.c);  // between chunks' rows
  if (nv >= kThreads) {
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const int s = i / cb, ch = blockIdx.y * cb + i % cb;
      if (ch >= p.c) continue;
      const float* q = partials + static_cast<int64_t>(s) * p.c + ch;
      float t = 0.f;
#pragma unroll 8
      for (int k = 0; k < p.chunks; ++k) t += __ldcg(q + k * pitch);
      out[s * p.c + ch] = t;
    }
    return;
  }
  const int groups = kThreads / nv, i = threadIdx.x % nv, gi = threadIdx.x / nv;
  const int s = i / cb, ch = blockIdx.y * cb + i % cb;
  float t = 0.f;
  if (ch < p.c) {
    const float* q = partials + static_cast<int64_t>(s) * p.c + ch;
#pragma unroll 8
    for (int k = gi; k < p.chunks; k += groups) t += __ldcg(q + k * pitch);
  }
  red[threadIdx.x] = t;  // every thread read red before the ticket
  __syncthreads();
  if (threadIdx.x < nv && ch < p.c) {
    float u = 0.f;
    for (int k = 0; k < groups; ++k) u += red[k * nv + threadIdx.x];
    out[s * p.c + ch] = u;
  }
}

// ------------------------------------------------------------------ kernels
// Statistics: sums (2, C) = per channel sum x, sum x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_stats_kernel(const T* __restrict__ x, float* __restrict__ sums,
                        float* __restrict__ partials, unsigned int* __restrict__ tickets,
                        Plan p) {
  const Geom g = geom<V>(p);
  float acc[2][V] = {};
  each_row<T, V, kUnroll>(g, p, x, [&](int64_t, const Pack<T, V>& v) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(v.v[j]);
      acc[0][j] += f;
      acc[1][j] += __fmul_rn(f, f);  // x^2 rounded, as the plain version's
    }
  });
  block_sums<V>(acc, g, p, sums, partials, tickets);
}

// Apply: y = act(round((x - mean) * mul + bias)) from the sums over n rows
// (train) or the running statistics; chunk 0 writes the saved mean and
// rstd and, in train mode, the running statistics.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ sums,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        float* __restrict__ rmean, float* __restrict__ rvar, T* __restrict__ y,
                        float* __restrict__ mean_out, float* __restrict__ rstd_out, Plan p,
                        float n, float eps, float momentum, float keep, int train, int act,
                        float slope) {
  const Geom g = geom<V>(p);
  float mean[V], mul[V], bt[V];
  if (g.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = g.ch + j;
      float m, var;
      if (train) {
        m = __fdiv_rn(sums[ch], n);
        var = fmaxf(__fsub_rn(__fdiv_rn(sums[p.c + ch], n), __fmul_rn(m, m)), 0.f);
      } else {
        m = rmean[ch];
        var = rvar[ch];
      }
      const float r = rsqrtf(__fadd_rn(var, eps));
      mean[j] = m;
      mul[j] = __fmul_rn(r, scale[ch]);
      bt[j] = bias[ch];
      if (blockIdx.x == 0 && g.slot == 0) {
        mean_out[ch] = m;
        rstd_out[ch] = r;
        if (train) {
          rmean[ch] = __fadd_rn(__fmul_rn(momentum, rmean[ch]), __fmul_rn(keep, m));
          rvar[ch] = __fadd_rn(__fmul_rn(momentum, rvar[ch]), __fmul_rn(keep, var));
        }
      }
    }
  }
  each_row<T, V, kUnroll>(g, p, x, [&](int64_t at, const Pack<T, V>& v) {
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j)
      from_f32(o.v[j], activate<T>(affine(to_f32(v.v[j]), mean[j], mul[j], bt[j]), act, slope));
    *reinterpret_cast<Pack<T, V>*>(y + at) = o;
  });
}

// The per-channel values both backward passes take: mean, rstd, mul and
// bias of channel ch + j.
template <int V>
struct Saved {
  float mean[V], rstd[V], mul[V], bias[V];
  __device__ __forceinline__ void load(const Geom& g, const float* __restrict__ mean_in,
                                       const float* __restrict__ rstd_in,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias_in) {
    if (!g.active) return;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = g.ch + j;
      mean[j] = mean_in[ch];
      rstd[j] = rstd_in[ch];
      mul[j] = __fmul_rn(rstd[j], scale[ch]);
      bias[j] = bias_in[ch];
    }
  }
};

// Reduce: sums (2, C) = per channel sum g, sum g * xhat.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                         float* __restrict__ sums, float* __restrict__ partials,
                         unsigned int* __restrict__ tickets, Plan p, int act, float slope) {
  const Geom g = geom<V>(p);
  Saved<V> sv;
  sv.load(g, mean_in, rstd_in, scale, bias);
  float acc[2][V] = {};
  each_row2<T, V, kUnroll / 2>(g, p, x, dy,
                               [&](int64_t, const Pack<T, V>& xv, const Pack<T, V>& dv) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xf = to_f32(xv.v[j]);
      const float gr = act_grad<T>(affine(xf, sv.mean[j], sv.mul[j], sv.bias[j]),
                                   to_f32(dv.v[j]), act, slope);
      acc[0][j] += gr;
      acc[1][j] = fmaf(gr, __fmul_rn(__fsub_rn(xf, sv.mean[j]), sv.rstd[j]), acc[1][j]);
    }
  });
  block_sums<V>(acc, g, p, sums, partials, tickets);
}

// Apply back: dx = mul * (g - sum g / n - xhat * sum g xhat / n), or mul * g
// (train == 0: the running statistics, which take no gradient).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ sums, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ mean_in,
                        const float* __restrict__ rstd_in, T* __restrict__ dx, Plan p, float n,
                        int train, int act, float slope) {
  const Geom g = geom<V>(p);
  Saved<V> sv;
  sv.load(g, mean_in, rstd_in, scale, bias);
  float k1[V] = {}, k2[V] = {};
  if (train && g.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      k1[j] = __fdiv_rn(sums[g.ch + j], n);
      k2[j] = __fdiv_rn(sums[p.c + g.ch + j], n);
    }
  }
  each_row2<T, V, kUnroll / 2>(g, p, x, dy,
                               [&](int64_t at, const Pack<T, V>& xv, const Pack<T, V>& dv) {
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xf = to_f32(xv.v[j]);
      const float gr = act_grad<T>(affine(xf, sv.mean[j], sv.mul[j], sv.bias[j]),
                                   to_f32(dv.v[j]), act, slope);
      float d = gr;
      if (train) {
        const float xhat = __fmul_rn(__fsub_rn(xf, sv.mean[j]), sv.rstd[j]);
        d = __fsub_rn(__fsub_rn(gr, k1[j]), __fmul_rn(xhat, k2[j]));
      }
      from_f32(o.v[j], __fmul_rn(sv.mul[j], d));
    }
    *reinterpret_cast<Pack<T, V>*>(dx + at) = o;
  });
}

// ------------------------------------------------------------------ launches
template <typename T>
cudaError_t check_plan(const Plan& p) {
  const int wide = static_cast<int>(16 / sizeof(T));
  const bool ok =
      p.rows >= 1 && p.c >= 1 && (p.vec == 1 || p.vec == wide) && p.c % p.vec == 0 &&
      p.lanes >= 1 && p.lanes <= kThreads && (p.lanes & (p.lanes - 1)) == 0 &&
      p.chunks >= 1 && p.chunk_rows >= 1 &&
      static_cast<int64_t>(p.chunk_rows) * p.chunks >= p.rows &&
      static_cast<int64_t>(p.chunk_rows) * (p.chunks - 1) < p.rows &&
      blocks_of(p) <= kMaxBlocks;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

inline dim3 grid_of(const Plan& p) {
  return dim3(static_cast<unsigned int>(p.chunks), static_cast<unsigned int>(blocks_of(p)));
}

// f(std::integral_constant<int, V>) for vec = V: 16 bytes of T, or 1, once
// the plan is checked.
template <typename T, typename F>
int with_vec(const Plan& p, F&& f) {
  cudaError_t e = check_plan<T>(p);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.vec == 1) return f(std::integral_constant<int, 1>{});
  return f(std::integral_constant<int, static_cast<int>(16 / sizeof(T))>{});
}

inline Plan make_plan(int rows, int c, int vec, int lanes, int chunks, int chunk_rows) {
  return Plan{rows, c, vec, lanes, chunks, chunk_rows};
}

}  // namespace

// Each entry point comes in two storage types, suffixed f32 (vec 4 or 1)
// and bf16 (vec 8 or 1); the sums, statistics, scale and bias are float32
// either way. The plan arguments are rows, c, vec, lanes, chunks, chunk_rows.
#define BN_PLAN_ARGS int rows, int c, int vec, int lanes, int chunks, int chunk_rows
#define BN_ENTRY_POINTS(SUFFIX, T)                                                          \
  int bn_fwd_stats_##SUFFIX(const void* x, void* sums, void* partials, void* tickets,       \
                            BN_PLAN_ARGS, void* stream) {                                   \
    const Plan p = make_plan(rows, c, vec, lanes, chunks, chunk_rows);                      \
    return with_vec<T>(p, [&](auto v) {                                                     \
      bn_fwd_stats_kernel<T, decltype(v)::value>                                            \
          <<<grid_of(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(                 \
              static_cast<const T*>(x), static_cast<float*>(sums),                          \
              static_cast<float*>(partials), static_cast<unsigned int*>(tickets), p);       \
      return static_cast<int>(cudaGetLastError());                                          \
    });                                                                                     \
  }                                                                                         \
  int bn_fwd_apply_##SUFFIX(const void* x, const void* sums, const void* scale,             \
                            const void* bias, void* rmean, void* rvar, void* y, void* mean, \
                            void* rstd, BN_PLAN_ARGS, float n, float eps, float momentum,   \
                            float keep, int train, int act, float slope, void* stream) {    \
    const Plan p = make_plan(rows, c, vec, lanes, chunks, chunk_rows);                      \
    return with_vec<T>(p, [&](auto v) {                                                     \
      bn_fwd_apply_kernel<T, decltype(v)::value>                                            \
          <<<grid_of(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(                 \
              static_cast<const T*>(x), static_cast<const float*>(sums),                    \
              static_cast<const float*>(scale), static_cast<const float*>(bias),            \
              static_cast<float*>(rmean), static_cast<float*>(rvar), static_cast<T*>(y),    \
              static_cast<float*>(mean), static_cast<float*>(rstd), p, n, eps, momentum,    \
              keep, train, act, slope);                                                     \
      return static_cast<int>(cudaGetLastError());                                          \
    });                                                                                     \
  }                                                                                         \
  int bn_bwd_reduce_##SUFFIX(const void* x, const void* dy, const void* scale,              \
                             const void* bias, const void* mean, const void* rstd,          \
                             void* sums, void* partials, void* tickets, BN_PLAN_ARGS,       \
                             int act, float slope, void* stream) {                          \
    const Plan p = make_plan(rows, c, vec, lanes, chunks, chunk_rows);                      \
    return with_vec<T>(p, [&](auto v) {                                                     \
      bn_bwd_reduce_kernel<T, decltype(v)::value>                                           \
          <<<grid_of(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(                 \
              static_cast<const T*>(x), static_cast<const T*>(dy),                          \
              static_cast<const float*>(scale), static_cast<const float*>(bias),            \
              static_cast<const float*>(mean), static_cast<const float*>(rstd),             \
              static_cast<float*>(sums), static_cast<float*>(partials),                     \
              static_cast<unsigned int*>(tickets), p, act, slope);                          \
      return static_cast<int>(cudaGetLastError());                                          \
    });                                                                                     \
  }                                                                                         \
  int bn_bwd_apply_##SUFFIX(const void* x, const void* dy, const void* sums,                \
                            const void* scale, const void* bias, const void* mean,          \
                            const void* rstd, void* dx, BN_PLAN_ARGS, float n, int train,   \
                            int act, float slope, void* stream) {                           \
    const Plan p = make_plan(rows, c, vec, lanes, chunks, chunk_rows);                      \
    return with_vec<T>(p, [&](auto v) {                                                     \
      bn_bwd_apply_kernel<T, decltype(v)::value>                                            \
          <<<grid_of(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(                 \
              static_cast<const T*>(x), static_cast<const T*>(dy),                          \
              static_cast<const float*>(sums), static_cast<const float*>(scale),            \
              static_cast<const float*>(bias), static_cast<const float*>(mean),             \
              static_cast<const float*>(rstd), static_cast<T*>(dx), p, n, train, act,       \
              slope);                                                                       \
      return static_cast<int>(cudaGetLastError());                                          \
    });                                                                                     \
  }

extern "C" {

// The statistics pass, (the caller all-reduces the sums over a group,) the
// apply; the backward's reduce, (all-reduce,) apply.
BN_ENTRY_POINTS(f32, float)
BN_ENTRY_POINTS(bf16, __nv_bfloat16)

const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
