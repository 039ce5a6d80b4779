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
//
// The variance is two-pass (mean first, then the centred sum of squares),
// as jnp.var and the plain version compute it: the TPU kernel's
// E[x^2] - mean^2 cancels on the post-ReLU, non-negative input of the
// res-block `in2` norm. The forward therefore reads x three times (sum,
// centred squares, normalize) and the backward reads x and dy twice; the
// re-reads of one CTA's slice are served from L2 at the shapes of the
// CycleGAN step (at most 16.8 MB for the whole tensor).
//
// Grid: one CTA per (channel block, sample). A channel block is
// cb = min(C, 32) channels; thread t handles channel c0 + t % cb on rows
// t / cb, t / cb + R, ... with R = kThreads / cb rows per pass, so a warp's
// loads are consecutive addresses: one 32-channel row segment for C >= 32,
// and whole rows for C < 32 (the C = 3 norm before the generator's tanh).
// Per-thread partial sums are combined per channel in shared memory.
//
// Bound on the H100: device-memory bandwidth. The least traffic is one read
// of x and one write of y (forward), one read of x and dy and one write of
// dx (backward). This simple design leaves two things for later work: the
// L2 re-reads, and occupancy (a (B, C/32) grid is 32 CTAs at the res-block
// norms against 132 SMs).
//
// The ReLU mask and the normalized values are evaluated with explicitly
// rounded intrinsics (no FMA contraction), in the order of the plain
// version, so that given the same mean and rstd the backward's mask is the
// plain version's bit for bit.
//
// C interface: raw pointers, sizes and the CUDA stream; every entry point
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannelBlock = 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Where this thread works inside its CTA's (sample, channel block) tile.
struct Tile {
  int ch;         // absolute channel
  int row0;       // first row
  int rows;       // rows per pass of the CTA
  bool active;    // holds a channel < C and a row slot
  int64_t base;   // element offset of (sample, row 0, ch)
  int64_t pitch;  // elements between rows (= C)
};

__device__ __forceinline__ Tile make_tile(int hw, int c, int cb) {
  Tile t;
  const int lane_c = threadIdx.x % cb;
  t.rows = kThreads / cb;
  t.row0 = threadIdx.x / cb;
  t.ch = blockIdx.x * cb + lane_c;
  t.active = t.row0 < t.rows && t.ch < c;
  t.pitch = c;
  t.base = static_cast<int64_t>(blockIdx.y) * hw * c + t.ch;
  return t;
}

// Sum of `v` over the CTA's threads that hold the same channel, returned to
// each of them. `red` holds kThreads floats, `out` kMaxChannelBlock.
__device__ __forceinline__ float channel_sum(float v, int cb, int rows,
                                             float* red, float* out) {
  red[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < cb) {
    float s = 0.f;
    for (int k = 0; k < rows; ++k) s += red[threadIdx.x + k * cb];
    out[threadIdx.x] = s;
  }
  __syncthreads();
  return out[threadIdx.x % cb];
}

__device__ __forceinline__ float normalized(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float affine(float xhat, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xhat, gamma), beta);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int hw, int c, int cb, float eps, int relu) {
  __shared__ float red[kThreads];
  __shared__ float out[kMaxChannelBlock];
  const Tile t = make_tile(hw, c, cb);
  const float n = static_cast<float>(hw);

  float s = 0.f;
  if (t.active) {
#pragma unroll 4
    for (int p = t.row0; p < hw; p += t.rows) s += load_f32(x + t.base + p * t.pitch);
  }
  const float mean = __fdiv_rn(channel_sum(s, cb, t.rows, red, out), n);

  float q = 0.f;
  if (t.active) {
#pragma unroll 4
    for (int p = t.row0; p < hw; p += t.rows) {
      const float d = __fsub_rn(load_f32(x + t.base + p * t.pitch), mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(channel_sum(q, cb, t.rows, red, out), n);
  const float rstd = rsqrtf(__fadd_rn(var, eps));

  if (!t.active) return;
  const float g = gamma[t.ch];
  const float b = beta[t.ch];
#pragma unroll 4
  for (int p = t.row0; p < hw; p += t.rows) {
    const int64_t i = t.base + p * t.pitch;
    float v = affine(normalized(load_f32(x + i), mean, rstd), g, b);
    if (relu) v = fmaxf(v, 0.f);
    store(y + i, v);
  }
  if (t.row0 == 0) {
    const int64_t s_idx = static_cast<int64_t>(blockIdx.y) * c + t.ch;
    mean_out[s_idx] = mean;
    rstd_out[s_idx] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                  T* __restrict__ dx, float* __restrict__ dgamma_part,
                  float* __restrict__ dbeta_part, int hw, int c, int cb, int relu) {
  __shared__ float red[kThreads];
  __shared__ float out[kMaxChannelBlock];
  const Tile t = make_tile(hw, c, cb);
  const int64_t s_idx = static_cast<int64_t>(blockIdx.y) * c + t.ch;
  float mean = 0.f, rstd = 0.f, g = 0.f, b = 0.f;
  if (t.ch < c) {
    mean = mean_in[s_idx];
    rstd = rstd_in[s_idx];
    g = gamma[t.ch];
    b = beta[t.ch];
  }

  // Pass 1: the per-sample dbeta and dgamma partials.
  float sd = 0.f, sdx = 0.f;
  if (t.active) {
#pragma unroll 4
    for (int p = t.row0; p < hw; p += t.rows) {
      const int64_t i = t.base + p * t.pitch;
      const float xhat = normalized(load_f32(x + i), mean, rstd);
      float d = load_f32(dy + i);
      if (relu && !(affine(xhat, g, b) > 0.f)) d = 0.f;
      sd += d;
      sdx += d * xhat;
    }
  }
  const float sum_d = channel_sum(sd, cb, t.rows, red, out);
  const float sum_dx = channel_sum(sdx, cb, t.rows, red, out);
  if (!t.active) return;
  if (t.row0 == 0) {
    dbeta_part[s_idx] = sum_d;
    dgamma_part[s_idx] = sum_dx;
  }

  // Pass 2: dx, with mean(g) = gamma * sum_d / HW, mean(g*xhat) likewise.
  const float n = static_cast<float>(hw);
  const float mean_g = __fdiv_rn(__fmul_rn(sum_d, g), n);
  const float mean_gx = __fdiv_rn(__fmul_rn(sum_dx, g), n);
#pragma unroll 4
  for (int p = t.row0; p < hw; p += t.rows) {
    const int64_t i = t.base + p * t.pitch;
    const float xhat = normalized(load_f32(x + i), mean, rstd);
    float d = load_f32(dy + i);
    if (relu && !(affine(xhat, g, b) > 0.f)) d = 0.f;
    const float inner = __fsub_rn(__fsub_rn(__fmul_rn(d, g), mean_g),
                                  __fmul_rn(xhat, mean_gx));
    store(dx + i, __fmul_rn(rstd, inner));
  }
}

dim3 grid_of(int b, int c, int cb) {
  return dim3(static_cast<unsigned int>((c + cb - 1) / cb),
              static_cast<unsigned int>(b));
}

template <typename T>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y,
               void* mean, void* rstd, int b, int hw, int c, float eps,
               int relu, void* stream) {
  const int cb = c < kMaxChannelBlock ? c : kMaxChannelBlock;
  in_fwd_kernel<T><<<grid_of(b, c, cb), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), hw, c, cb, eps,
      relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* gamma,
               const void* beta, const void* mean, const void* rstd, void* dx,
               void* dgamma_part, void* dbeta_part, int b, int hw, int c,
               int relu, void* stream) {
  const int cb = c < kMaxChannelBlock ? c : kMaxChannelBlock;
  in_bwd_kernel<T><<<grid_of(b, c, cb), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(dgamma_part),
      static_cast<float*>(dbeta_part), hw, c, cb, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int in_fwd_f32(const void* x, const void* gamma, const void* beta, void* y,
               void* mean, void* rstd, int b, int hw, int c, float eps,
               int relu, void* stream) {
  return launch_fwd<float>(x, gamma, beta, y, mean, rstd, b, hw, c, eps, relu,
                           stream);
}

int in_fwd_bf16(const void* x, const void* gamma, const void* beta, void* y,
                void* mean, void* rstd, int b, int hw, int c, float eps,
                int relu, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, b, hw, c,
                                   eps, relu, stream);
}

int in_bwd_f32(const void* x, const void* dy, const void* gamma,
               const void* beta, const void* mean, const void* rstd, void* dx,
               void* dgamma_part, void* dbeta_part, int b, int hw, int c,
               int relu, void* stream) {
  return launch_bwd<float>(x, dy, gamma, beta, mean, rstd, dx, dgamma_part,
                           dbeta_part, b, hw, c, relu, stream);
}

int in_bwd_bf16(const void* x, const void* dy, const void* gamma,
                const void* beta, const void* mean, const void* rstd, void* dx,
                void* dgamma_part, void* dbeta_part, int b, int hw, int c,
                int relu, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, gamma, beta, mean, rstd, dx,
                                   dgamma_part, dbeta_part, b, hw, c, relu,
                                   stream);
}

const char* in_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
