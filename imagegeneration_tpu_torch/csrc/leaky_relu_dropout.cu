// Fused LeakyReLU + counter-hash inverted dropout, forward and backward.
//
// Replaces the TPU kernel pair `_kernel` / `_bwd_kernel` of
// imagegeneration_tpu/ops/pallas/dropout.py (`leaky_relu_dropout`), with the
// mask of the JAX main path (imagegeneration_tpu/ops/bitdropout.py,
// `_hash_mask` rounds=1) instead of the TPU's hardware PRNG:
//
//   idx  = the element's NHWC linear index in the GLOBAL (B, H, W, C)
//          array, as uint32 (the wrapper bounds the global element count
//          below 2^32). On one device it is the element's offset i in the
//          channels_last tensor. A rank holding batch rows [b0, b0+b) passes
//          base = b0*H*W*C; one that also holds only image rows [h0,
//          h0+h) of H (a spatial shard) passes (h, H, h0, W*C), and local
//          offset i = bb*h*wc + hh*wc + rest maps to
//            base + bb*H*wc + (h0+hh)*wc + rest
//          = base + h0*wc + i + (i / (h*wc)) * (H-h)*wc
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
// The row-block mapping costs one 32-bit division per element; it is a
// template branch of its own, so the contiguous case (h == H, h0 == 0: one
// device, or data parallelism alone) runs the code it ran before.
//
// C interface: raw pointers, the element count, the index base, the row
// block (h_local, h_global, h0, wc) and the CUDA stream; each entry point
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue, before
// any launch, for a row block that does not fit).

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

// Global mask index of local offset i (see the header).
template <bool kRowBlocks>
__device__ __forceinline__ uint32_t global_index(uint32_t i, uint32_t offset,
                                                 uint32_t block, uint32_t gap) {
  if (kRowBlocks) return offset + i + (i / block) * gap;
  return offset + i;
}

template <typename T, bool kRowBlocks>
__global__ void lrd_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const int64_t* __restrict__ kw, int64_t n,
                               uint32_t offset, uint32_t block, uint32_t gap,
                               uint32_t cut, float scale, float slope) {
  const uint32_t k0 = static_cast<uint32_t>(kw[0]);
  const uint32_t k1 = static_cast<uint32_t>(kw[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t idx =
        global_index<kRowBlocks>(static_cast<uint32_t>(i), offset, block, gap);
    const uint32_t h = fmix32(idx ^ k0) + k1;
    const float v = load_f32(x, i);
    const float l = v >= 0.f ? v : __fmul_rn(v, slope);
    store_f32(y, i, (h & 0xFFu) >= cut ? __fmul_rn(l, scale) : 0.f);
  }
}

template <typename T, bool kRowBlocks>
__global__ void lrd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               T* __restrict__ dx,
                               const int64_t* __restrict__ kw, int64_t n,
                               uint32_t offset, uint32_t block, uint32_t gap,
                               uint32_t cut, float scale, float slope) {
  const uint32_t k0 = static_cast<uint32_t>(kw[0]);
  const uint32_t k1 = static_cast<uint32_t>(kw[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t idx =
        global_index<kRowBlocks>(static_cast<uint32_t>(i), offset, block, gap);
    const uint32_t h = fmix32(idx ^ k0) + k1;
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

// The kernel's (offset, block, gap) of a shard; false when the row block
// does not fit (h_local rows at h0 inside h_global, a whole number of rows).
inline bool row_blocks(int64_t n, uint32_t base, uint32_t h_local,
                       uint32_t h_global, uint32_t h0, uint32_t wc,
                       uint32_t* offset, uint32_t* block, uint32_t* gap) {
  const uint64_t rows = static_cast<uint64_t>(h_local) * wc;
  if (h_local == 0 || wc == 0 || h0 + h_local > h_global ||
      static_cast<uint64_t>(n) % rows != 0)
    return false;
  *offset = base + h0 * wc;
  *block = static_cast<uint32_t>(rows);
  *gap = (h_global - h_local) * wc;
  return true;
}

template <typename T>
int launch_fwd(const void* x, void* y, const void* kw, int64_t n,
               uint32_t base, uint32_t h_local, uint32_t h_global,
               uint32_t h0, uint32_t wc, uint32_t cut, float scale,
               float slope, void* stream) {
  uint32_t offset, block, gap;
  if (!row_blocks(n, base, h_local, h_global, h0, wc, &offset, &block, &gap))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const T*>(x);
  auto* ys = static_cast<T*>(y);
  const auto* k = static_cast<const int64_t*>(kw);
  if (gap == 0)
    lrd_fwd_kernel<T, false><<<num_blocks(n), kThreads, 0, s>>>(
        xs, ys, k, n, offset, block, gap, cut, scale, slope);
  else
    lrd_fwd_kernel<T, true><<<num_blocks(n), kThreads, 0, s>>>(
        xs, ys, k, n, offset, block, gap, cut, scale, slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, const void* kw,
               int64_t n, uint32_t base, uint32_t h_local, uint32_t h_global,
               uint32_t h0, uint32_t wc, uint32_t cut, float scale,
               float slope, void* stream) {
  uint32_t offset, block, gap;
  if (!row_blocks(n, base, h_local, h_global, h0, wc, &offset, &block, &gap))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const T*>(x);
  const auto* gs = static_cast<const T*>(g);
  auto* dxs = static_cast<T*>(dx);
  const auto* k = static_cast<const int64_t*>(kw);
  if (gap == 0)
    lrd_bwd_kernel<T, false><<<num_blocks(n), kThreads, 0, s>>>(
        xs, gs, dxs, k, n, offset, block, gap, cut, scale, slope);
  else
    lrd_bwd_kernel<T, true><<<num_blocks(n), kThreads, 0, s>>>(
        xs, gs, dxs, k, n, offset, block, gap, cut, scale, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lrd_fwd_f32(const void* x, void* y, const void* kw, int64_t n,
                uint32_t base, uint32_t h_local, uint32_t h_global,
                uint32_t h0, uint32_t wc, uint32_t cut, float scale,
                float slope, void* stream) {
  return launch_fwd<float>(x, y, kw, n, base, h_local, h_global, h0, wc, cut,
                           scale, slope, stream);
}

int lrd_fwd_bf16(const void* x, void* y, const void* kw, int64_t n,
                 uint32_t base, uint32_t h_local, uint32_t h_global,
                 uint32_t h0, uint32_t wc, uint32_t cut, float scale,
                 float slope, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, y, kw, n, base, h_local, h_global, h0,
                                   wc, cut, scale, slope, stream);
}

int lrd_bwd_f32(const void* x, const void* g, void* dx, const void* kw,
                int64_t n, uint32_t base, uint32_t h_local, uint32_t h_global,
                uint32_t h0, uint32_t wc, uint32_t cut, float scale,
                float slope, void* stream) {
  return launch_bwd<float>(x, g, dx, kw, n, base, h_local, h_global, h0, wc,
                           cut, scale, slope, stream);
}

int lrd_bwd_bf16(const void* x, const void* g, void* dx, const void* kw,
                 int64_t n, uint32_t base, uint32_t h_local, uint32_t h_global,
                 uint32_t h0, uint32_t wc, uint32_t cut, float scale,
                 float slope, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dx, kw, n, base, h_local, h_global,
                                   h0, wc, cut, scale, slope, stream);
}

const char* lrd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
