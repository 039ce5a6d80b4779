// Fused LeakyReLU + counter-hash inverted dropout, forward and backward.
//
// Replaces the TPU kernel pair `_kernel` / `_bwd_kernel` of
// imagegeneration_tpu/ops/pallas/dropout.py (`leaky_relu_dropout`), with the
// mask of the JAX main path (imagegeneration_tpu/ops/bitdropout.py,
// `_hash_mask` rounds=1) instead of the TPU's hardware PRNG:
//
//   idx  = base + NHWC linear index of the element (= its offset in a
//          channels_last tensor), as uint32. base is 0 on one device; a
//          data-parallel rank holding rows [r*b, (r+1)*b) of a global batch
//          passes r*b*H*W*C, so its mask is the global batch's at its rows
//          (the wrapper bounds the global element count below 2^32)
//   h    = fmix32(idx ^ k0) + k1            (uint32 wrap-around)
//   keep = (h & 0xFF) >= cut,  cut = round(rate * 256)
//   fwd: y  = keep ? leaky(x) * scale : 0
//   bwd: dx = keep ? g * scale * (x >= 0 ? 1 : slope) : 0
//
// scale = 256 / (256 - cut). Math is float32; storage is the input dtype.
// The backward regenerates the mask from (idx, k0, k1), so the only saved
// tensor is x.
//
// Bound on the H100: device-memory bandwidth. The forward reads x and writes
// y (2 passes over the activation); the backward reads x and g and writes dx
// (3 passes). The hash is ~10 integer ops per element, far below the ALU
// rate. The design keeps the mask out of device memory entirely and reads
// the key words from device memory (no host sync to launch). Threads walk
// the tensor with a grid-stride loop in memory order, so neighbouring
// threads touch neighbouring addresses.
//
// C interface: raw pointers, the element count, the index base and the
// CUDA stream; each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void lrd_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const int64_t* __restrict__ kw, int64_t n,
                               uint32_t base, uint32_t cut, float scale,
                               float slope) {
  const uint32_t k0 = static_cast<uint32_t>(kw[0]);
  const uint32_t k1 = static_cast<uint32_t>(kw[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t h = fmix32((base + static_cast<uint32_t>(i)) ^ k0) + k1;
    const float v = load_f32(x, i);
    const float l = v >= 0.f ? v : __fmul_rn(v, slope);
    store_f32(y, i, (h & 0xFFu) >= cut ? __fmul_rn(l, scale) : 0.f);
  }
}

template <typename T>
__global__ void lrd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               T* __restrict__ dx,
                               const int64_t* __restrict__ kw, int64_t n,
                               uint32_t base, uint32_t cut, float scale,
                               float slope) {
  const uint32_t k0 = static_cast<uint32_t>(kw[0]);
  const uint32_t k1 = static_cast<uint32_t>(kw[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t h = fmix32((base + static_cast<uint32_t>(i)) ^ k0) + k1;
    const float gs = __fmul_rn(load_f32(g, i), scale);
    const float d = load_f32(x, i) >= 0.f ? gs : __fmul_rn(gs, slope);
    store_f32(dx, i, (h & 0xFFu) >= cut ? d : 0.f);
  }
}

inline unsigned int num_blocks(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  if (b < 1) b = 1;
  return static_cast<unsigned int>(b);
}

}  // namespace

extern "C" {

int lrd_fwd_f32(const void* x, void* y, const void* kw, int64_t n,
                uint32_t base, uint32_t cut, float scale, float slope,
                void* stream) {
  lrd_fwd_kernel<float><<<num_blocks(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const int64_t*>(kw), n, base, cut, scale, slope);
  return static_cast<int>(cudaGetLastError());
}

int lrd_fwd_bf16(const void* x, void* y, const void* kw, int64_t n,
                 uint32_t base, uint32_t cut, float scale, float slope,
                 void* stream) {
  lrd_fwd_kernel<__nv_bfloat16><<<num_blocks(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      static_cast<const int64_t*>(kw), n, base, cut, scale, slope);
  return static_cast<int>(cudaGetLastError());
}

int lrd_bwd_f32(const void* x, const void* g, void* dx, const void* kw,
                int64_t n, uint32_t base, uint32_t cut, float scale,
                float slope, void* stream) {
  lrd_bwd_kernel<float><<<num_blocks(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(dx), static_cast<const int64_t*>(kw), n, base, cut,
      scale, slope);
  return static_cast<int>(cudaGetLastError());
}

int lrd_bwd_bf16(const void* x, const void* g, void* dx, const void* kw,
                 int64_t n, uint32_t base, uint32_t cut, float scale,
                 float slope, void* stream) {
  lrd_bwd_kernel<__nv_bfloat16><<<num_blocks(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx),
      static_cast<const int64_t*>(kw), n, base, cut, scale, slope);
  return static_cast<int>(cudaGetLastError());
}

const char* lrd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
