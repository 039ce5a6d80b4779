// InstanceNorm forward and backward over channels_last (NHWC) tensors.
//
// Replaces the TPU kernels `_in_fwd_kernel` and `_in_bwd_kernel` of
// imagegeneration_tpu/ops/pallas/instance_norm.py. Statistics are per
// (sample, channel) over the H*W rows, in float32, for float32 or bfloat16
// storage:
//
//   forward:  mean = sum(x) / HW
//             var  = sum((x - mean)^2) / HW
//             rstd = rsqrt(var + eps)
//             y    = (x - mean) * rstd * gamma + beta      (then max(y, 0))
//   backward: xhat = (x - mean) * rstd, dy' = dy * (xhat*gamma + beta > 0)
//             sd = sum(dy'), sdx = sum(dy' * xhat)   (per-sample dbeta, dgamma)
//             dx = rstd * (dy'*gamma - gamma*sd/HW - xhat * gamma*sdx/HW)
//             dbeta = sum over the batch of sd, dgamma likewise of sdx
//
// The variance is two-pass (mean first, then the centred sum of squares),
// as jnp.var and the plain version compute it: the TPU kernel's
// E[x^2] - mean^2 cancels on the post-ReLU, non-negative input of the
// res-block `in2` norm.
//
// Bound on the H100: device-memory bandwidth. The least traffic is one read
// of x and one write of y (forward), one read of x and dy and one write of
// dx (backward). The design, per launch (`launch_plan` in
// ops/instance_norm.py chooses its shape; the kernels check it):
//
// - Occupancy. A (sample, channel block) group is owned by a thread-block
//   cluster of k CTAs (k <= 16; above 8 with the non-portable cluster size),
//   each taking a contiguous range of the H*W rows, so that the norms of the
//   CycleGAN step run >= 128 CTAs (a (B, C/32) grid was 8 CTAs at
//   (4, 64, 128, 128)). The CTAs meet in distributed shared memory: the
//   forward twice (the per-channel sums give the mean, then the centred
//   sums of squares give rstd), the backward once (sum dy' and
//   sum dy'*xhat). Every CTA adds the cluster's partials in rank order, so
//   all of them hold the same bits. A cluster of one skips the barriers.
// - One read of device memory. Where the CTA's slice of x (and of dy in the
//   backward) fits the plan's shared-memory budget, the first pass copies
//   it there with cp.async, every copy in flight at once, and the later
//   passes read it back from there. An input not held is re-read from L2
//   (50 MB, against at most 33.5 MB of x and dy), and the output is then
//   stored evict-first so that it does not push the input out.
// - 16-byte loads. Where C allows (C % 4 == 0 for float32, C % 8 == 0 for
//   bfloat16) a thread moves 4 float32 or 8 bfloat16 consecutive channels
//   at once, neighbouring threads on neighbouring 16-byte chunks of a row
//   segment of `cb` channels; other C (the C = 3 norm before the tanh) take
//   a scalar path with one channel per thread, whose warps read whole rows.
// - The batch sum of dgamma and dbeta, in the backward's one launch. Rank 0
//   of each cluster writes its sample's partials to a scratch buffer and
//   takes a ticket (atomicInc, which wraps the counter back to 0); the last
//   of a channel block's B tickets sums the B partials in sample order. No
//   float atomics: two calls give the same bits.
//
// What bounds the small launches instead is latency, not bytes (PERF.md):
// the launch, the cluster barrier of each exchange, and the ticket's round
// trips through L2 form a chain that data of a few MB does not hide.
//
// The split form of a map H-partitioned over spatial ranks (the section
// "split passes" below; ops/instance_norm._SplitInstanceNorm) has four
// more kernels on plain grids: a forward partial and apply, a backward
// partial and apply, around one collective each way.
//
// The ReLU mask and the normalized values are evaluated with explicitly
// rounded intrinsics (no FMA contraction), in the order of the plain
// version, so that given the same mean and rstd the backward's mask is the
// plain version's bit for bit.
//
// C interface: raw pointers, sizes, the launch plan and the CUDA stream;
// the plan is checked (cudaErrorInvalidValue if it is not one this source
// can run) and every entry point returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannelBlock = 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxDynamicSmem = 232448 - 8192;  // the static buffers below fit in 8 KB
// cta_sums's buffer: two statistics per channel, per warp or per thread.
constexpr int kRed = 2 * (kWarps * kMaxChannelBlock > kThreads ? kWarps * kMaxChannelBlock
                                                               : kThreads);

// Launch plan, computed by ops/instance_norm.py::launch_plan.
struct Plan {
  int hw;      // rows per sample
  int c;       // channels
  int cb;      // channels per block
  int k;       // CTAs per cluster, one cluster per (sample, channel block)
  int rows;    // rows per CTA
  int held;    // inputs whose slice the CTA holds in shared memory (x, then dy)
};

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

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

// An output store; `stream` marks a 16-byte store evict-first, so that it
// does not push out of L2 the inputs a later pass re-reads.
template <typename T, int V>
__device__ __forceinline__ void store_out(T* p, const Pack<T, V>& v, bool stream) {
  if constexpr (sizeof(T) * V == 16) {
    if (stream) {
      __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
      return;
    }
  }
  store_pack(p, v);
}

__device__ __forceinline__ float normalized(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float affine(float xhat, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xhat, gamma), beta);
}

// 16 bytes from device memory into shared memory, asynchronously; a
// thread's copies are visible to it after cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The split cluster barrier that keeps a CTA's shared memory alive while
// the others may still read it; nothing to wait for in a cluster of one.
__device__ __forceinline__ void cluster_arrive(int k) {
  if (k > 1) asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait(int k) {
  if (k > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Where this thread works inside its CTA. A row segment of the block's cb
// channels is L = cb / V chunks; thread t takes chunk t % L of rows
// row0 + t / L, + slots, ... below row1.
template <int V>
struct Geom {
  int lane;       // chunk of V channels within the block
  int slot;       // first row offset
  int slots;      // rows per pass of the CTA
  int ch;         // first absolute channel of the chunk
  bool active;    // holds channels < C and a row slot
  int row0, row1; // the CTA's rows
  int64_t base;   // element offset of (sample, row 0, ch)
};

template <int V>
__device__ __forceinline__ Geom<V> geom(const Plan& p, int rank) {
  Geom<V> g;
  const int lanes = p.cb / V;
  g.lane = threadIdx.x % lanes;
  g.slot = threadIdx.x / lanes;
  g.slots = kThreads / lanes;
  g.ch = blockIdx.y * p.cb + g.lane * V;
  g.active = g.slot < g.slots && g.ch < p.c;
  g.row0 = rank * p.rows;
  g.row1 = min(p.hw, g.row0 + p.rows);
  g.base = static_cast<int64_t>(blockIdx.z) * p.hw * p.c + g.ch;
  return g;
}

// Where a pass reads the CTA's slice: shared memory when held, else device
// memory (L2).
template <typename T>
struct Source {
  const T* at;    // element of row `first`
  int64_t pitch;  // elements between rows
  int first;
  __device__ __forceinline__ const T* row(int r) const {
    return at + static_cast<int64_t>(r - first) * pitch;
  }
};

template <typename T, int V>
__device__ __forceinline__ Source<T> source(const Plan& p, const Geom<V>& g, bool held,
                                            const T* cache, const T* global) {
  if (held) return {cache + g.lane * V, p.cb, g.row0};
  return {global + g.base, p.c, 0};
}

// f(r, a_r) over this thread's rows in increasing order, U (kUnroll unless
// given) loads of `a` in flight at a time (two-source form below: f(r, a_r,
// b_r)).
constexpr int kUnroll = 4;

template <int U = kUnroll, typename T, int V, typename F>
__device__ __forceinline__ void each_row(const Geom<V>& g, const Source<T>& a, F&& f) {
  for (int r0 = g.row0 + g.slot; r0 < g.row1; r0 += U * g.slots) {
    Pack<T, V> va[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * g.slots < g.row1) va[u] = load_pack<T, V>(a.row(r0 + u * g.slots));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * g.slots < g.row1) f(r0 + u * g.slots, va[u]);
  }
}

template <int U = kUnroll, typename T, int V, typename F>
__device__ __forceinline__ void each_row(const Geom<V>& g, const Source<T>& a,
                                         const Source<T>& b, F&& f) {
  for (int r0 = g.row0 + g.slot; r0 < g.row1; r0 += U * g.slots) {
    Pack<T, V> va[U], vb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * g.slots < g.row1) {
        va[u] = load_pack<T, V>(a.row(r0 + u * g.slots));
        vb[u] = load_pack<T, V>(b.row(r0 + u * g.slots));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * g.slots < g.row1) f(r0 + u * g.slots, va[u], vb[u]);
  }
}

// This thread's part of the CTA's slice of `global` into `cache` (the
// layout of Source when held). 16-byte chunks go by cp.async, left in
// flight (cp_async_wait_all waits for every copy issued); the scalar path
// loads and stores. Each thread later reads only what it copied itself, so
// no CTA barrier is needed.
template <typename T, int V>
__device__ __forceinline__ void fill_cache(const Plan& p, const Geom<V>& g, T* cache,
                                           const T* global) {
  if (!g.active) return;
  if constexpr (sizeof(T) * V == 16) {
    for (int r = g.row0 + g.slot; r < g.row1; r += g.slots)
      cp_async16(cache + (r - g.row0) * p.cb + g.lane * V,
                 global + g.base + static_cast<int64_t>(r) * p.c);
  } else {
    const Source<T> src{global + g.base, p.c, 0};
    each_row(g, src, [&](int r, const Pack<T, V>& v) {
      store_pack(cache + (r - g.row0) * p.cb + g.lane * V, v);
    });
  }
}

// Sums of S statistics of V channels, v[s * V + j], over the CTA's threads
// that hold the same channels; statistic s of the block's channel
// lane * V + j lands in out[s * cb + lane * V + j], in a fixed order.
template <int V, int S>
__device__ __forceinline__ void cta_sums(float (&v)[S * V], int cb, float* red, float* out) {
  const int lanes = cb / V;
  int nslots;
  if (32 % lanes == 0) {  // a warp holds whole row segments: shuffle first
    for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
      for (int i = 0; i < S * V; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
    const int w = threadIdx.x / 32, lw = threadIdx.x % 32;
    if (lw < lanes) {
#pragma unroll
      for (int i = 0; i < S * V; ++i) red[(w * lanes + lw) * S * V + i] = v[i];
    }
    nslots = kWarps;
  } else {  // only the scalar path has lanes that do not divide 32 (check_plan)
    if constexpr (V == 1) {
#pragma unroll
      for (int i = 0; i < S; ++i) red[threadIdx.x * S + i] = v[i];
    }
    nslots = kThreads / lanes;
  }
  __syncthreads();
  if (threadIdx.x < S * cb) {
    const int st = threadIdx.x / cb, ch = threadIdx.x % cb;
    const int lane = ch / V, i = st * V + ch % V;
    float s = 0.f;
    for (int k = 0; k < nslots; ++k) s += red[(k * lanes + lane) * S * V + i];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// tot[i] = sum over the cluster's CTAs, in rank order, of part[i], i < n.
// A lone CTA (k = 1) skips the cluster barrier: cta_sums's last barrier
// already made its part visible to its own threads.
__device__ __forceinline__ void cluster_totals(const cg::cluster_group& cl, float* part,
                                               float* tot, int n, int k) {
  if (k > 1) cl.sync();
  if (threadIdx.x < n) {
    float v[kMaxCluster];  // the k remote loads issued together
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < k) v[r] = cl.map_shared_rank(part, r)[threadIdx.x];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < k) s += v[r];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    in_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out, Plan p,
                  float eps, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kRed];
  __shared__ float part[2 * kMaxChannelBlock];
  __shared__ float tot[2 * kMaxChannelBlock];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const Geom<V> g = geom<V>(p, rank);
  T* cache = reinterpret_cast<T*>(smem);
  const float n = static_cast<float>(p.hw);
  float gm[V] = {}, bt[V] = {};
  if (g.ch < p.c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gm[j] = gamma[g.ch + j];
      bt[j] = beta[g.ch + j];
    }
  }

  // Pass 1: the sums (after the slice is copied into shared memory).
  if (p.held) fill_cache<T, V>(p, g, cache, x);
  cp_async_wait_all();
  const Source<T> src = source<T, V>(p, g, p.held > 0, cache, x);
  float s[V] = {};
  if (g.active) {
    each_row(g, src, [&](int, const Pack<T, V>& v) {
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += to_f32(v.v[j]);
    });
  }
  cta_sums<V, 1>(s, p.cb, red, part);
  cluster_totals(cl, part, tot, p.cb, p.k);
  float mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = __fdiv_rn(tot[g.lane * V + j], n);

  // Pass 2: the centred sums of squares.
  float q[V] = {};
  if (g.active) {
    each_row(g, src, [&](int, const Pack<T, V>& v) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(to_f32(v.v[j]), mean[j]);
        q[j] = __fadd_rn(q[j], __fmul_rn(d, d));
      }
    });
  }
  cta_sums<V, 1>(q, p.cb, red, part + p.cb);
  cluster_totals(cl, part + p.cb, tot + p.cb, p.cb, p.k);
  float rstd[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    rstd[j] = rsqrtf(__fadd_rn(__fdiv_rn(tot[p.cb + g.lane * V + j], n), eps));
  cluster_arrive(p.k);  // this CTA reads no other's shared memory from here on

  // Pass 3: normalize.
  if (g.active) {
    each_row(g, src, [&](int r, const Pack<T, V>& v) {
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float a = affine(normalized(to_f32(v.v[j]), mean[j], rstd[j]), gm[j], bt[j]);
        if (relu) a = fmaxf(a, 0.f);
        from_f32(o.v[j], a);
      }
      store_out(y + g.base + static_cast<int64_t>(r) * p.c, o, p.held == 0);
    });
    if (rank == 0 && g.slot == 0) {
      const int64_t s_idx = static_cast<int64_t>(blockIdx.z) * p.c + g.ch;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mean_out[s_idx + j] = mean[j];
        rstd_out[s_idx + j] = rstd[j];
      }
    }
  }
  cluster_wait(p.k);  // no CTA leaves while another may read its shared memory
}

// The backward's per-thread sums over one row: sums[j] += dy', sums[V + j]
// += dy' * xhat, dy' masked by the ReLU rebuilt from xhat. The single-pass
// kernel and the split partial both add their rows through it, in the same
// order, so that one shard's sums are the single-pass kernel's bits.
template <typename T, int V>
__device__ __forceinline__ void bwd_add(float (&sums)[2 * V], const Pack<T, V>& xv,
                                        const Pack<T, V>& dv, const float (&mean)[V],
                                        const float (&rstd)[V], const float (&gm)[V],
                                        const float (&bt)[V], int relu) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xhat = normalized(to_f32(xv.v[j]), mean[j], rstd[j]);
    float d = to_f32(dv.v[j]);
    if (relu && !(affine(xhat, gm[j], bt[j]) > 0.f)) d = 0.f;
    sums[j] += d;
    sums[V + j] += d * xhat;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    in_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                  T* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
                  float* __restrict__ partials, unsigned int* __restrict__ tickets, Plan p,
                  int batch, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kRed];
  __shared__ float part[2 * kMaxChannelBlock];
  __shared__ float tot[2 * kMaxChannelBlock];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const Geom<V> g = geom<V>(p, rank);
  T* cache_x = reinterpret_cast<T*>(smem);
  T* cache_dy = cache_x + static_cast<int64_t>(p.rows) * p.cb;
  const int64_t s_idx = static_cast<int64_t>(blockIdx.z) * p.c + g.ch;
  float mean[V] = {}, rstd[V] = {}, gm[V] = {}, bt[V] = {};
  if (g.ch < p.c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean[j] = mean_in[s_idx + j];
      rstd[j] = rstd_in[s_idx + j];
      gm[j] = gamma[g.ch + j];
      bt[j] = beta[g.ch + j];
    }
  }

  // Pass 1: this sample's dbeta and dgamma partials (after the slices are
  // copied into shared memory).
  if (p.held > 0) fill_cache<T, V>(p, g, cache_x, x);
  if (p.held > 1) fill_cache<T, V>(p, g, cache_dy, dy);
  cp_async_wait_all();
  const Source<T> xs = source<T, V>(p, g, p.held > 0, cache_x, x);
  const Source<T> ds = source<T, V>(p, g, p.held > 1, cache_dy, dy);
  float sums[2 * V] = {};  // sum dy' of each channel, then sum dy' * xhat
  if (g.active) {
    each_row(g, xs, ds, [&](int, const Pack<T, V>& xv, const Pack<T, V>& dv) {
      bwd_add(sums, xv, dv, mean, rstd, gm, bt, relu);
    });
  }
  cta_sums<V, 2>(sums, p.cb, red, part);
  cluster_totals(cl, part, tot, 2 * p.cb, p.k);
  cluster_arrive(p.k);  // this CTA reads no other's shared memory from here on

  // dbeta and dgamma: the sums over the batch, by warp 0 of the last rank-0
  // CTA of the channel block to take a ticket. The ticket is taken before
  // this warp's share of pass 2 and read after it, so the atomic's round
  // trip overlaps the pass. partials is (2, batch, C).
  const bool batch_sum = rank == 0 && threadIdx.x < 32;
  const int64_t plane = static_cast<int64_t>(batch) * p.c;
  unsigned int ticket = 0;
  if (batch_sum) {
    for (int i = threadIdx.x; i < p.cb; i += 32) {
      const int ch = blockIdx.y * p.cb + i;
      if (ch < p.c) {
        const int64_t at = static_cast<int64_t>(blockIdx.z) * p.c + ch;
        partials[at] = tot[i];
        partials[plane + at] = tot[p.cb + i];
      }
    }
    __threadfence();
    __syncwarp();
    if (threadIdx.x == 0)
      ticket = atomicInc(&tickets[blockIdx.y], static_cast<unsigned int>(batch - 1));
  }

  // Pass 2: dx, with mean(g) = gamma * sum_d / HW, mean(g*xhat) likewise.
  if (g.active) {
    const float n = static_cast<float>(p.hw);
    float mean_g[V], mean_gx[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean_g[j] = __fdiv_rn(__fmul_rn(tot[g.lane * V + j], gm[j]), n);
      mean_gx[j] = __fdiv_rn(__fmul_rn(tot[p.cb + g.lane * V + j], gm[j]), n);
    }
    each_row(g, xs, ds, [&](int r, const Pack<T, V>& xv, const Pack<T, V>& dv) {
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = normalized(to_f32(xv.v[j]), mean[j], rstd[j]);
        float d = to_f32(dv.v[j]);
        if (relu && !(affine(xhat, gm[j], bt[j]) > 0.f)) d = 0.f;
        const float inner = __fsub_rn(__fsub_rn(__fmul_rn(d, gm[j]), mean_g[j]),
                                      __fmul_rn(xhat, mean_gx[j]));
        from_f32(o.v[j], __fmul_rn(rstd[j], inner));
      }
      store_out(dx + g.base + static_cast<int64_t>(r) * p.c, o, p.held < 2);
    });
  }

  if (batch_sum &&
      __shfl_sync(0xffffffffu, ticket, 0) == static_cast<unsigned int>(batch - 1)) {
    __threadfence();
    for (int i = threadIdx.x; i < p.cb; i += 32) {
      const int ch = blockIdx.y * p.cb + i;
      if (ch >= p.c) continue;
      float sb = 0.f, sg = 0.f;
      for (int b = 0; b < batch; ++b) {
        sb += __ldcg(partials + static_cast<int64_t>(b) * p.c + ch);
        sg += __ldcg(partials + plane + static_cast<int64_t>(b) * p.c + ch);
      }
      dbeta[ch] = sb;
      dgamma[ch] = sg;
    }
  }
  cluster_wait(p.k);  // no CTA leaves while another may read its shared memory
}

// cudaErrorInvalidValue unless this source can run the plan; sets p.held.
cudaError_t check_plan(Plan& p, int b, int vec, int tensors, int esize, int smem) {
  const bool ok =
      b >= 1 && p.hw >= 1 && p.c >= 1 && p.cb >= vec && p.cb <= kMaxChannelBlock &&
      p.cb % vec == 0 && p.cb / vec <= kThreads &&
      // vector path: blocks tile C, and a warp holds whole row segments
      (vec == 1 || (p.c % p.cb == 0 && 32 % (p.cb / vec) == 0)) && p.k >= 1 &&
      p.k <= kMaxCluster && p.rows >= 1 &&
      static_cast<int64_t>(p.rows) * p.k >= p.hw &&         // the rows are covered
      static_cast<int64_t>(p.rows) * (p.k - 1) < p.hw &&    // every CTA has a row
      smem >= 0 && smem <= kMaxDynamicSmem && smem % (p.rows * p.cb * esize) == 0 &&
      smem / (p.rows * p.cb * esize) <= tensors;  // whole slices of x (and dy)
  if (!ok) return cudaErrorInvalidValue;
  p.held = smem / (p.rows * p.cb * esize);
  return cudaSuccess;
}

template <typename K>
cudaError_t prepare(K* kernel, const Plan& p, int smem) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && p.k > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Launch(const Plan& p, int b, int smem, void* stream) : cfg(), attr() {
    cfg.gridDim = dim3(static_cast<unsigned int>(p.k),
                       static_cast<unsigned int>((p.c + p.cb - 1) / p.cb),
                       static_cast<unsigned int>(b));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned int>(p.k);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = p.k > 1 ? 1 : 0;  // a lone CTA is a cluster of one anyway
  }
};

Plan make_plan(int hw, int c, int cb, int cluster, int rows) {
  return Plan{hw, c, cb, cluster, rows, 0};
}

template <typename T, int V>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean,
               void* rstd, int b, Plan p, int smem, float eps, int relu, void* stream) {
  cudaError_t e = check_plan(p, b, V, 1, sizeof(T), smem);
  if (e == cudaSuccess) e = prepare(in_fwd_kernel<T, V>, p, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l(p, b, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, in_fwd_kernel<T, V>, static_cast<const T*>(x),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<T*>(y), static_cast<float*>(mean),
                         static_cast<float*>(rstd), p, eps, relu);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
               const void* mean, const void* rstd, void* dx, void* dgamma, void* dbeta,
               void* partials, void* tickets, int b, Plan p, int smem, int relu,
               void* stream) {
  cudaError_t e = check_plan(p, b, V, 2, sizeof(T), smem);
  if (e == cudaSuccess) e = prepare(in_bwd_kernel<T, V>, p, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l(p, b, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, in_bwd_kernel<T, V>, static_cast<const T*>(x),
                         static_cast<const T*>(dy), static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), static_cast<const float*>(mean),
                         static_cast<const float*>(rstd), static_cast<T*>(dx),
                         static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                         static_cast<float*>(partials),
                         static_cast<unsigned int*>(tickets), p, b, relu);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ split passes
// The split norm of a shard of an H-partitioned map: plain grids of (row
// chunks, channel blocks, samples), no cluster. A CTA takes `rows`
// consecutive rows (p.rows; p.k chunks cover the shard's p.hw rows, the
// last one possibly shorter) of its sample and its block's cb channels, and
// a thread moves V channels per load, as in the kernels above.
//
// The partial passes read 1-8 MB at the CycleGAN generator's shards, which
// the card streams in 1-5 us: what sets their time is the chain from
// launch to exit (a design built from the single-pass kernels' cluster
// passes spent it on a shared-memory fill, cluster barriers and a ticket
// chain).
// - Forward partial: one read of x straight into registers, kHold rows a
//   thread, every load issued before the first is used (the plan cuts the
//   rows into chunks short enough); then the CTA's sum, its mean, and the
//   centred sum of squares about that mean from the registers (two-pass,
//   as jnp.var, within the chunk). No shared-memory copy, no cluster, no
//   second read, no wait on another CTA: each chunk's (sum, M2) is written
//   as it is, (k, B, C, 2), and the forward apply merges the S x k chunks
//   of the spatial peers by Chan's formula, in a fixed order.
// - Backward partial: one read of x and dy, kDeep rows of each in flight a
//   thread, no staging; each CTA's sum dy' and sum dy' xhat go to a scratch
//   row, and the last CTA of a channel block to take a ticket (one
//   atomicInc after a release fence; the counter wraps back to 0) adds the
//   chunks of each (sample, channel) in chunk order, and the samples in
//   sample order for dgamma/dbeta: the single-pass kernel's orders, so one
//   shard at its plan gives its bits. No float atomics: two calls give the
//   same bits.
// - The applies: below, beside their kernels.
constexpr int kHold = 16;         // rows a thread of the forward partial holds
constexpr int kDeep = 8;          // rows of x and dy a backward-partial thread has in flight
constexpr int kTicketBatch = 32;  // samples the backward partial's last CTA adds per round

// cudaErrorInvalidValue unless this source can run a plain-grid plan of
// the split passes; a partial pass (`partial`) also reduces over its CTA,
// so its vector path needs a warp to hold whole row segments (as
// check_plan), and the forward partial (`hold`) every row of a thread in
// registers.
cudaError_t check_grid_plan(const Plan& p, int b, int vec, bool partial, bool hold) {
  const int lanes = p.cb / vec;  // vec is 1 or 16 bytes' worth (with_vec)
  const bool ok =
      b >= 1 && p.hw >= 1 && p.c >= 1 && p.cb >= vec && p.cb <= kMaxChannelBlock &&
      p.cb % vec == 0 && lanes <= kThreads && (vec == 1 || p.c % p.cb == 0) &&
      p.k >= 1 && p.k <= 65535 && p.rows >= 1 &&
      static_cast<int64_t>(p.rows) * p.k >= p.hw &&
      static_cast<int64_t>(p.rows) * (p.k - 1) < p.hw &&
      (!partial || vec == 1 || 32 % lanes == 0) &&
      (!hold || p.rows <= (kThreads / lanes) * kHold);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// Forward partial: parts[((chunk * B + b) * C + c) * 2 + {0, 1}] = the sum
// of x and the sum of (x - m)^2 over the chunk's rows of (b, c), m the
// chunk's own mean.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    in_fwd_partial_kernel(const T* __restrict__ x, float* __restrict__ parts, Plan p,
                          int batch) {
  __shared__ float red[kRed];
  __shared__ float stat[2 * kMaxChannelBlock];
  const Geom<V> g = geom<V>(p, blockIdx.x);
  Pack<T, V> v[kHold];
#pragma unroll
  for (int u = 0; u < kHold; ++u) {
    const int r = g.row0 + g.slot + u * g.slots;
    if (g.active && r < g.row1) v[u] = load_pack<T, V>(x + g.base + static_cast<int64_t>(r) * p.c);
  }
  float s[V] = {};
#pragma unroll
  for (int u = 0; u < kHold; ++u) {
    if (g.active && g.row0 + g.slot + u * g.slots < g.row1) {
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += to_f32(v[u].v[j]);
    }
  }
  cta_sums<V, 1>(s, p.cb, red, stat);
  const float n = static_cast<float>(g.row1 - g.row0);
  float mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = __fdiv_rn(stat[g.lane * V + j], n);
  float q[V] = {};
#pragma unroll
  for (int u = 0; u < kHold; ++u) {
    if (g.active && g.row0 + g.slot + u * g.slots < g.row1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(to_f32(v[u].v[j]), mean[j]);
        q[j] = __fadd_rn(q[j], __fmul_rn(d, d));
      }
    }
  }
  cta_sums<V, 1>(q, p.cb, red, stat + p.cb);
  if (threadIdx.x < p.cb) {
    const int ch = blockIdx.y * p.cb + threadIdx.x;
    if (ch < p.c) {
      const int64_t at =
          ((static_cast<int64_t>(blockIdx.x) * batch + blockIdx.z) * p.c + ch) * 2;
      parts[at] = stat[threadIdx.x];
      parts[at + 1] = stat[p.cb + threadIdx.x];
    }
  }
}

// Backward partial: split[(b * C + c) * 2 + {0, 1}] = gamma * sum dy' and
// gamma * sum dy' * xhat over the shard's rows (sum g and sum g * xhat; the
// apply takes them summed over the spatial peers); dgamma, dbeta (C,) the
// shard's own, summed over its samples. chunks (k, B, C, 2) is scratch.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    in_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                          float* __restrict__ split, float* __restrict__ dgamma,
                          float* __restrict__ dbeta, float* __restrict__ chunks,
                          unsigned int* __restrict__ tickets, Plan p, int batch, int relu) {
  __shared__ float red[kRed];
  __shared__ float part[2 * kMaxChannelBlock];
  __shared__ float tot[2 * kTicketBatch * kMaxChannelBlock];
  __shared__ unsigned int ticket;
  const Geom<V> g = geom<V>(p, blockIdx.x);
  const int64_t s_idx = static_cast<int64_t>(blockIdx.z) * p.c + g.ch;
  float mean[V] = {}, rstd[V] = {}, gm[V] = {}, bt[V] = {};
  if (g.ch < p.c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean[j] = mean_in[s_idx + j];
      rstd[j] = rstd_in[s_idx + j];
      gm[j] = gamma[g.ch + j];
      bt[j] = beta[g.ch + j];
    }
  }
  float sums[2 * V] = {};  // sum dy' of each channel, then sum dy' * xhat
  if (g.active) {
    const Source<T> xs{x + g.base, p.c, 0}, ds{dy + g.base, p.c, 0};
    each_row<kDeep>(g, xs, ds, [&](int, const Pack<T, V>& xv, const Pack<T, V>& dv) {
      bwd_add(sums, xv, dv, mean, rstd, gm, bt, relu);
    });
  }
  cta_sums<V, 2>(sums, p.cb, red, part);
  if (threadIdx.x < p.cb) {
    const int ch = blockIdx.y * p.cb + threadIdx.x;
    if (ch < p.c) {
      const int64_t at =
          ((static_cast<int64_t>(blockIdx.x) * batch + blockIdx.z) * p.c + ch) * 2;
      chunks[at] = part[threadIdx.x];
      chunks[at + 1] = part[p.cb + threadIdx.x];
    }
  }
  __threadfence();  // this CTA's chunk row is visible before its ticket
  __syncthreads();
  const unsigned int last = static_cast<unsigned int>(p.k * batch - 1);
  if (threadIdx.x == 0) ticket = atomicInc(&tickets[blockIdx.y], last);
  __syncthreads();
  if (ticket != last) return;
  __threadfence();

  // The last CTA of the channel block: per (sample, channel) the chunks in
  // chunk order, then per channel the samples in sample order.
  float sb = 0.f, sg = 0.f;
  for (int b0 = 0; b0 < batch; b0 += kTicketBatch) {
    const int nb = min(kTicketBatch, batch - b0);
    for (int i = threadIdx.x; i < nb * p.cb; i += kThreads) {
      const int b = b0 + i / p.cb, lc = i % p.cb, ch = blockIdx.y * p.cb + lc;
      if (ch >= p.c) continue;
      float t0 = 0.f, t1 = 0.f;
      for (int j = 0; j < p.k; ++j) {
        const int64_t at = ((static_cast<int64_t>(j) * batch + b) * p.c + ch) * 2;
        t0 += __ldcg(chunks + at);
        t1 += __ldcg(chunks + at + 1);
      }
      const int64_t at = (static_cast<int64_t>(b) * p.c + ch) * 2;
      split[at] = __fmul_rn(t0, gamma[ch]);
      split[at + 1] = __fmul_rn(t1, gamma[ch]);
      tot[(i / p.cb) * 2 * kMaxChannelBlock + lc] = t0;
      tot[(i / p.cb) * 2 * kMaxChannelBlock + kMaxChannelBlock + lc] = t1;
    }
    __syncthreads();
    if (threadIdx.x < p.cb) {
      for (int b = 0; b < nb; ++b) {
        sb += tot[b * 2 * kMaxChannelBlock + threadIdx.x];
        sg += tot[b * 2 * kMaxChannelBlock + kMaxChannelBlock + threadIdx.x];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < p.cb && blockIdx.y * p.cb + threadIdx.x < p.c) {
    dbeta[blockIdx.y * p.cb + threadIdx.x] = sb;
    dgamma[blockIdx.y * p.cb + threadIdx.x] = sg;
  }
}

dim3 apply_grid(const Plan& p, int b) {
  return dim3(static_cast<unsigned int>(p.k),
              static_cast<unsigned int>((p.c + p.cb - 1) / p.cb),
              static_cast<unsigned int>(b));
}

// The applies stream their rows once and are bound by bytes (forward:
// read x, write y; backward: read x and dy, write dx), but at the
// generator's shards (2-25 MB) what sets their time is the chain from
// launch to the last store. So a thread issues the loads of its first
// rows (up to kFwdApplyDeep of x; kShallow of x and of dy) before it
// touches the statistics: the merge of the partials (forward) or the loads
// of mean, rstd and the sums (backward) run while those rows are in
// flight, and the chain holds one trip to device memory, not two. Rows
// past the first batch (the plan's rows per thread above the batch) are
// loaded batch by batch after it. The forward's plan (fwd_apply_plan)
// gives each thread the deep batch where the grid keeps MIN_CTAS CTAs, so
// that fewer CTAs repeat the merge, else kShallow rows or fewer; its
// kernel holds D rows a thread: kShallow where the plan gives a thread at
// most that many (the registers of a deep batch would cost the small
// shards occupancy and spills), else the deep batch. The backward has no
// merge to spread: kShallow rows a thread (bwd_apply_plan), where 8 rows
// on half the CTAs measured no faster.
constexpr int kFwdApplyDeep = 16;  // rows of x a forward-apply thread has in flight
constexpr int kShallow = 4;        // the batch of a plan of at most that many rows a thread
constexpr int kMergeParts = 8;     // partials a forward-apply thread holds in registers

// v[u] = row r0 + u * slots of `src` (rows below row1 only).
template <int D, typename T, int V>
__device__ __forceinline__ void load_rows(Pack<T, V> (&v)[D], const T* __restrict__ src,
                                          const Geom<V>& g, int pitch, int r0) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    const int r = r0 + u * g.slots;
    if (r < g.row1) v[u] = load_pack<T, V>(src + g.base + static_cast<int64_t>(r) * pitch);
  }
}

// A (rows, sum, centred sum of squares) triple, and Chan's combination of
// two: symmetric in its arguments bit for bit (commuted adds and products,
// the difference of means only squared), so that an xor-shuffle tree
// leaves the same bits in every lane.
struct Moments {
  float n, s, m2;
};

__device__ __forceinline__ Moments combine(const Moments& a, const Moments& b) {
  if (a.n == 0.f) return b;
  if (b.n == 0.f) return a;
  const float n = __fadd_rn(a.n, b.n);
  const float d = __fsub_rn(__fdiv_rn(a.s, a.n), __fdiv_rn(b.s, b.n));
  const float w = __fdiv_rn(__fmul_rn(a.n, b.n), n);
  return {n, __fadd_rn(a.s, b.s), __fadd_rn(__fadd_rn(a.m2, b.m2), __fmul_rn(__fmul_rn(d, d), w))};
}

// The whole map's mean and rstd of the CTA's channels from the S x k chunk
// partials (parts is (S, k, B, C, 2): shard s's chunk j, the forward
// partial's sum and centred sum of squares over its n_j rows, n_j =
// min(ceil(hw / k), hw - j * ceil(hw / k)) of the shard's hw), N = S * hw,
// into stat (mean at [lc], rstd at [kMaxChannelBlock + lc]); the CTAs of
// row chunk 0 also write them to mean_out and rstd_out (B, C). G threads a
// channel (a power of two, G * cb <= kThreads, lanes of one warp): thread
// g of a group takes the parts q = g, g + G, ..., every part read once.
// - Up to kMergeParts parts a thread (S x k <= kMergeParts * G: the
//   generator's shards), all of them in registers, their loads issued
//   together; Chan's two passes over the registers, in a fixed order:
//     mean = sum_q sum_q / N
//     var  = sum_q (m2_q + n_q (sum_q / n_q - mean)^2) / N
//   each sum first over a thread's parts in order, then over the group by
//   xor shuffles (the same bits in every lane).
// - More: rounds of kMergeParts parts a thread, each round's (rows, sum,
//   M2 about its own mean) combined into the thread's by `combine`, then
//   the group's threads by xor shuffles of the same.
// Every thread of the CTA runs the shuffles (full mask).
__device__ __forceinline__ void merge_chunks(const float* __restrict__ parts, const Plan& p,
                                             int batch, int shards, int splits, float eps,
                                             float* stat, float* __restrict__ mean_out,
                                             float* __restrict__ rstd_out) {
  int G = 32;
  while (G * p.cb > kThreads) G >>= 1;
  const int lc = threadIdx.x / G, q0 = threadIdx.x % G;
  const int ch = blockIdx.y * p.cb + lc;
  const bool mine = lc < p.cb && ch < p.c;
  const float total = __fmul_rn(static_cast<float>(p.hw), static_cast<float>(shards));
  const int prow = (p.hw + splits - 1) / splits;
  const int nparts = shards * splits;
  const int64_t stride = static_cast<int64_t>(batch) * p.c * 2;
  const float* at = parts + (static_cast<int64_t>(blockIdx.z) * p.c + (mine ? ch : 0)) * 2;
  float sum = 0.f, m2 = 0.f, mean;
  const int per = (nparts + G - 1) / G;  // parts of the busiest thread
  if (per <= kMergeParts) {
    float ps[kMergeParts], pm[kMergeParts];
#pragma unroll
    for (int i = 0; i < kMergeParts; ++i) {
      if (i >= per) break;
      const int q = q0 + i * G;
      ps[i] = pm[i] = 0.f;
      if (mine && q < nparts) {
        ps[i] = at[q * stride];
        pm[i] = at[q * stride + 1];
      }
    }
#pragma unroll
    for (int i = 0; i < kMergeParts; ++i) {
      if (i >= per) break;
      if (mine && q0 + i * G < nparts) sum = __fadd_rn(sum, ps[i]);
    }
    for (int off = G / 2; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    mean = __fdiv_rn(sum, total);
#pragma unroll
    for (int i = 0; i < kMergeParts; ++i) {
      if (i >= per) break;
      const int q = q0 + i * G;
      if (mine && q < nparts) {
        const float n = static_cast<float>(min(prow, p.hw - (q % splits) * prow));
        const float d = __fsub_rn(__fdiv_rn(ps[i], n), mean);
        m2 = __fadd_rn(m2, __fadd_rn(pm[i], __fmul_rn(n, __fmul_rn(d, d))));
      }
    }
    for (int off = G / 2; off > 0; off >>= 1)
      m2 = __fadd_rn(m2, __shfl_xor_sync(0xffffffffu, m2, off));
  } else {
    Moments acc{0.f, 0.f, 0.f};
    for (int q1 = q0; q1 < nparts; q1 += kMergeParts * G) {
      float ps[kMergeParts], pm[kMergeParts], pn[kMergeParts];
#pragma unroll
      for (int i = 0; i < kMergeParts; ++i) {
        const int q = q1 + i * G;
        ps[i] = pm[i] = pn[i] = 0.f;
        if (mine && q < nparts) {
          ps[i] = at[q * stride];
          pm[i] = at[q * stride + 1];
          pn[i] = static_cast<float>(min(prow, p.hw - (q % splits) * prow));
        }
      }
      Moments r{0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kMergeParts; ++i) {
        r.n = __fadd_rn(r.n, pn[i]);
        r.s = __fadd_rn(r.s, ps[i]);
      }
      if (r.n > 0.f) {
        const float rm = __fdiv_rn(r.s, r.n);
#pragma unroll
        for (int i = 0; i < kMergeParts; ++i) {
          if (pn[i] > 0.f) {
            const float d = __fsub_rn(__fdiv_rn(ps[i], pn[i]), rm);
            r.m2 = __fadd_rn(r.m2, __fadd_rn(pm[i], __fmul_rn(pn[i], __fmul_rn(d, d))));
          }
        }
      }
      acc = combine(acc, r);
    }
    for (int off = G / 2; off > 0; off >>= 1) {
      const Moments o{__shfl_xor_sync(0xffffffffu, acc.n, off),
                      __shfl_xor_sync(0xffffffffu, acc.s, off),
                      __shfl_xor_sync(0xffffffffu, acc.m2, off)};
      acc = combine(acc, o);
    }
    sum = acc.s;
    m2 = acc.m2;
    mean = __fdiv_rn(sum, total);
  }
  if (mine && q0 == 0) {
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(m2, total), eps));
    stat[lc] = mean;
    stat[kMaxChannelBlock + lc] = rstd;
    if (blockIdx.x == 0) {
      mean_out[static_cast<int64_t>(blockIdx.z) * p.c + ch] = mean;
      rstd_out[static_cast<int64_t>(blockIdx.z) * p.c + ch] = rstd;
    }
  }
}

// Forward apply: the loads of this thread's first rows of x, then the
// merge of the partials (merge_chunks) while they are in flight, then y =
// (x - mean) * rstd * gamma + beta (+ReLU) on this shard's rows.
template <typename T, int V, int D>
__global__ void __launch_bounds__(kThreads)
    in_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ parts,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        T* __restrict__ y, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, Plan p, int batch, int shards,
                        int splits, float eps, int relu) {
  __shared__ float stat[2 * kMaxChannelBlock];
  const Geom<V> g = geom<V>(p, blockIdx.x);
  Pack<T, V> v[D];
  float gm[V] = {}, bt[V] = {};
  if (g.active) {
    load_rows(v, x, g, p.c, g.row0 + g.slot);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gm[j] = gamma[g.ch + j];
      bt[j] = beta[g.ch + j];
    }
  }
  merge_chunks(parts, p, batch, shards, splits, eps, stat, mean_out, rstd_out);
  __syncthreads();
  if (!g.active) return;
  float mean[V], rstd[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = stat[g.lane * V + j];
    rstd[j] = stat[kMaxChannelBlock + g.lane * V + j];
  }
  for (int r0 = g.row0 + g.slot;;) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int r = r0 + u * g.slots;
      if (r < g.row1) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float a = affine(normalized(to_f32(v[u].v[j]), mean[j], rstd[j]), gm[j], bt[j]);
          if (relu) a = fmaxf(a, 0.f);
          from_f32(o.v[j], a);
        }
        store_pack(y + g.base + static_cast<int64_t>(r) * p.c, o);
      }
    }
    r0 += D * g.slots;
    if (r0 - g.slot >= g.row1) break;
    load_rows(v, x, g, p.c, r0);
  }
}

// Backward apply: with sums (B, C, 2) = (sum g, sum g * xhat) over the
// whole map (the spatial peers' split outputs summed), g = dy' * gamma,
//   dx = rstd * (g - sum g / N - xhat * sum(g * xhat) / N)
// on this shard's rows, the ReLU mask rebuilt as in the single-pass kernel
// and every element by that kernel's expression (so one shard is its
// bits). The loads of the first rows of x and dy are issued before those
// of the statistics.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ sums, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ mean_in,
                        const float* __restrict__ rstd_in, T* __restrict__ dx, Plan p,
                        float total, int relu) {
  const Geom<V> g = geom<V>(p, blockIdx.x);
  if (!g.active) return;
  constexpr int D = kShallow;
  Pack<T, V> xv[D], dv[D];
  load_rows(xv, x, g, p.c, g.row0 + g.slot);
  load_rows(dv, dy, g, p.c, g.row0 + g.slot);
  const int64_t s_idx = static_cast<int64_t>(blockIdx.z) * p.c + g.ch;
  float mean[V], rstd[V], gm[V], bt[V], mean_g[V], mean_gx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = mean_in[s_idx + j];
    rstd[j] = rstd_in[s_idx + j];
    gm[j] = gamma[g.ch + j];
    bt[j] = beta[g.ch + j];
    mean_g[j] = __fdiv_rn(sums[(s_idx + j) * 2], total);
    mean_gx[j] = __fdiv_rn(sums[(s_idx + j) * 2 + 1], total);
  }
  for (int r0 = g.row0 + g.slot;;) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int r = r0 + u * g.slots;
      if (r < g.row1) {
        Pack<T, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = normalized(to_f32(xv[u].v[j]), mean[j], rstd[j]);
          float d = to_f32(dv[u].v[j]);
          if (relu && !(affine(xhat, gm[j], bt[j]) > 0.f)) d = 0.f;
          const float inner = __fsub_rn(__fsub_rn(__fmul_rn(d, gm[j]), mean_g[j]),
                                        __fmul_rn(xhat, mean_gx[j]));
          from_f32(o.v[j], __fmul_rn(rstd[j], inner));
        }
        store_pack(dx + g.base + static_cast<int64_t>(r) * p.c, o);
      }
    }
    r0 += D * g.slots;
    if (r0 - g.slot >= g.row1) break;
    load_rows(xv, x, g, p.c, r0);
    load_rows(dv, dy, g, p.c, r0);
  }
}

// f(std::integral_constant<int, D>): D = kShallow where the plan gives a
// thread at most that many rows, else kFwdApplyDeep.
template <int V, typename F>
void with_depth(const Plan& p, F&& f) {
  const int slots = kThreads / (p.cb / V);
  if ((p.rows + slots - 1) / slots <= kShallow)
    f(std::integral_constant<int, kShallow>{});
  else
    f(std::integral_constant<int, kFwdApplyDeep>{});
}

template <typename T, int V>
int launch_fwd_apply(const void* x, const void* parts, const void* gamma, const void* beta,
                     void* y, void* mean, void* rstd, int b, const Plan& p, int shards,
                     int splits, float eps, int relu, void* stream) {
  cudaError_t e = check_grid_plan(p, b, V, false, false);
  if (e == cudaSuccess && (shards < 1 || splits < 1 || splits > p.hw))
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  with_depth<V>(p, [&](auto d) {
    in_fwd_apply_kernel<T, V, decltype(d)::value>
        <<<apply_grid(p, b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const float*>(parts),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), p, b,
            shards, splits, eps, relu);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_fwd_partial(const void* x, void* parts, int b, const Plan& p, void* stream) {
  cudaError_t e = check_grid_plan(p, b, V, true, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  in_fwd_partial_kernel<T, V>
      <<<apply_grid(p, b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<float*>(parts), p, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd_partial(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* mean, const void* rstd, void* split, void* dgamma,
                       void* dbeta, void* chunks, void* tickets, int b, const Plan& p,
                       int relu, void* stream) {
  cudaError_t e = check_grid_plan(p, b, V, true, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  in_bwd_partial_kernel<T, V>
      <<<apply_grid(p, b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy),
          static_cast<const float*>(gamma), static_cast<const float*>(beta),
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          static_cast<float*>(split), static_cast<float*>(dgamma), static_cast<float*>(dbeta),
          static_cast<float*>(chunks), static_cast<unsigned int*>(tickets), p, b, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_bwd_apply(const void* x, const void* dy, const void* sums, const void* gamma,
                     const void* beta, const void* mean, const void* rstd, void* dx, int b,
                     const Plan& p, float total, int relu, void* stream) {
  cudaError_t e = check_grid_plan(p, b, V, false, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  in_bwd_apply_kernel<T, V><<<apply_grid(p, b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(sums),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
      p, total, relu);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, V>) for vec = V: 16 bytes of T, or 1.
template <typename T, typename F>
int with_vec(int vec, F&& f) {
  if (vec == static_cast<int>(16 / sizeof(T)))
    return f(std::integral_constant<int, static_cast<int>(16 / sizeof(T))>{});
  if (vec == 1) return f(std::integral_constant<int, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename K>
int active_clusters(K* kernel, const Plan& p, int smem) {
  cudaError_t e = prepare(kernel, p, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  Launch l(p, 1, smem, nullptr);
  l.cfg.numAttrs = 1;  // a plan of k = 1 counts as clusters of one CTA
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <typename T>
int clusters_of(int bwd, int vec, const Plan& p, int smem) {
  return with_vec<T>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    return bwd ? active_clusters(in_bwd_kernel<T, V>, p, smem)
               : active_clusters(in_fwd_kernel<T, V>, p, smem);
  });
}

}  // namespace

// Each entry point below comes in two storage types, suffixed f32 (vec 4
// for 16-byte loads, or 1) and bf16 (vec 8, or 1); the float statistics,
// gamma, beta and the partials are float32 either way.
#define IN_ENTRY_POINTS(SUFFIX, T)                                                          \
  int in_fwd_##SUFFIX(const void* x, const void* gamma, const void* beta, void* y,          \
                      void* mean, void* rstd, int b, int hw, int c, int cb, int vec,        \
                      int cluster, int rows, int smem, float eps, int relu, void* stream) { \
    const Plan p = make_plan(hw, c, cb, cluster, rows);                                     \
    return with_vec<T>(vec, [&](auto v) {                                                   \
      return launch_fwd<T, decltype(v)::value>(x, gamma, beta, y, mean, rstd, b, p, smem,   \
                                               eps, relu, stream);                          \
    });                                                                                     \
  }                                                                                         \
  int in_bwd_##SUFFIX(const void* x, const void* dy, const void* gamma, const void* beta,   \
                      const void* mean, const void* rstd, void* dx, void* dgamma,           \
                      void* dbeta, void* partials, void* tickets, int b, int hw, int c,     \
                      int cb, int vec, int cluster, int rows, int smem, int relu,           \
                      void* stream) {                                                       \
    const Plan p = make_plan(hw, c, cb, cluster, rows);                                     \
    return with_vec<T>(vec, [&](auto v) {                                                   \
      return launch_bwd<T, decltype(v)::value>(x, dy, gamma, beta, mean, rstd, dx, dgamma, \
                                               dbeta, partials, tickets, b, p, smem, relu,  \
                                               stream);                                     \
    });                                                                                     \
  }                                                                                         \
  int in_fwd_partial_##SUFFIX(const void* x, void* parts, int b, int hw, int c, int cb,     \
                              int vec, int chunks, int rows, void* stream) {                \
    const Plan p = make_plan(hw, c, cb, chunks, rows);                                      \
    return with_vec<T>(vec, [&](auto v) {                                                   \
      return launch_fwd_partial<T, decltype(v)::value>(x, parts, b, p, stream);             \
    });                                                                                     \
  }                                                                                         \
  int in_bwd_partial_##SUFFIX(const void* x, const void* dy, const void* gamma,             \
                              const void* beta, const void* mean, const void* rstd,         \
                              void* split, void* dgamma, void* dbeta, void* chunks,         \
                              void* tickets, int b, int hw, int c, int cb, int vec,         \
                              int nchunks, int rows, int relu, void* stream) {              \
    const Plan p = make_plan(hw, c, cb, nchunks, rows);                                     \
    return with_vec<T>(vec, [&](auto v) {                                                   \
      return launch_bwd_partial<T, decltype(v)::value>(x, dy, gamma, beta, mean, rstd,      \
                                                       split, dgamma, dbeta, chunks,        \
                                                       tickets, b, p, relu, stream);        \
    });                                                                                     \
  }                                                                                         \
  int in_fwd_apply_##SUFFIX(const void* x, const void* parts, const void* gamma,            \
                            const void* beta, void* y, void* mean, void* rstd, int b,       \
                            int hw, int c, int cb, int vec, int chunks, int rows,           \
                            int shards, int splits, float eps, int relu, void* stream) {    \
    const Plan p = make_plan(hw, c, cb, chunks, rows);                                      \
    return with_vec<T>(vec, [&](auto v) {                                                   \
      return launch_fwd_apply<T, decltype(v)::value>(x, parts, gamma, beta, y, mean, rstd,  \
                                                     b, p, shards, splits, eps, relu,       \
                                                     stream);                               \
    });                                                                                     \
  }                                                                                         \
  int in_bwd_apply_##SUFFIX(const void* x, const void* dy, const void* sums,                \
                            const void* gamma, const void* beta, const void* mean,          \
                            const void* rstd, void* dx, int b, int hw, int c, int cb,       \
                            int vec, int chunks, int rows, float total, int relu,           \
                            void* stream) {                                                 \
    const Plan p = make_plan(hw, c, cb, chunks, rows);                                      \
    return with_vec<T>(vec, [&](auto v) {                                                   \
      return launch_bwd_apply<T, decltype(v)::value>(x, dy, sums, gamma, beta, mean, rstd,  \
                                                     dx, b, p, total, relu, stream);        \
    });                                                                                     \
  }

extern "C" {

// The single-pass forward and backward (whole maps), then the split pair of
// an H-partitioned map: in_fwd_partial, (the caller all-gathers the
// partials over the spatial group,) in_fwd_apply; in_bwd_partial, (the
// caller all-reduces the split sums,) in_bwd_apply.
IN_ENTRY_POINTS(f32, float)
IN_ENTRY_POINTS(bf16, __nv_bfloat16)

// How many clusters of a plan the card holds at once (the occupancy API),
// or minus the CUDA error code. bwd: 0 forward, 1 backward.
int in_active_clusters(int bwd, int bf16, int hw, int c, int cb, int vec, int cluster,
                       int rows, int smem) {
  const Plan p = make_plan(hw, c, cb, cluster, rows);
  return bf16 ? clusters_of<__nv_bfloat16>(bwd, vec, p, smem)
              : clusters_of<float>(bwd, vec, p, smem);
}

const char* in_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
