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
// (3 passes). The mask is integer work on top: the hash is ~10 integer
// operations an element, and the H100's integer pipe has 64 lanes an SM
// (half the float32 FMA lanes), so at the forward's 2 bytes of bf16 read and
// 2 written an element the integer issue comes close to the byte time. The
// design keeps the mask out of device memory entirely and reads the key
// words from device memory (no host sync to launch).
//
// The forward (redesigned for Hopper) moves 16 bytes per access: 8 bf16 or
// 4 float32 values a vector, each thread issuing the loads of U vectors
// (U = 2 or 4, from the wrapper's launch plan, ops/dropout.launch_plan)
// before it hashes any of them, so that an SM keeps tens of KB in flight;
// the plan gives each CTA a single trip of kFwdThreads * U vectors (such
// grids ran level with a copy of the same bytes, a few % ahead of one
// persistent wave). The tensor is walked as rows of a 2-D (row, offset)
// grid: one row for a contiguous tensor (one device, or data parallelism
// alone), one per batch row of a spatial shard, so that the global index
// is first + offset with no division (a vector never straddles a row: the
// plan checks that W*C is a multiple of the vector). The hash takes the same bits with less integer
// work:
//   - fmix32's first step folds into the index: (idx ^ k0) ^ ((idx ^ k0)
//     >> 16) = idx ^ (idx >> 16) ^ (k0 ^ (k0 >> 16)); a vector starts at a
//     global index a multiple of its width (the plan checks it), so its
//     elements share idx >> 16 and element j's first step is one xor with j;
//   - the keep test needs the low byte of h + k1 only: ((h + k1) & 0xFF) >=
//     cut is (h << 24) + (k1 << 24) >= cut << 24 in uint32, one IMAD and one
//     compare, with no byte extraction;
//   - indices are 32-bit (the global element count is below 2^32), with one
//     64-bit row base per thread.
// A tail of fewer than a vector's elements (a contiguous tensor whose count
// is not a multiple of the width) runs a scalar loop in the same kernel; a
// tensor whose data is not 16-byte aligned, or whose rows or index do not
// fall on vector boundaries, takes the scalar kernel, the same walk one
// element at a time.
//
// The backward keeps its first design (one element a thread per grid-stride
// trip, the row-block mapping by one 32-bit division an element on a shard;
// a template branch of its own, so the contiguous case runs no division).
//
// C interface: raw pointers, the element count, the index base, the row
// block (h_local, h_global, h0, wc) and the CUDA stream, and for the forward
// its plan (unroll: 0 for the scalar kernel, else U; CTAs along a row); each
// entry point returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue, before any launch, for a row block that does not
// fit or a plan the tensor does not allow).

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

// ---------------------------------------------------------------- forward
constexpr int kFwdThreads = 256;

// Elements of T in one 16-byte vector.
template <typename T>
struct Vector;
template <>
struct Vector<float> {
  static constexpr uint32_t kWidth = 4;
};
template <>
struct Vector<__nv_bfloat16> {
  static constexpr uint32_t kWidth = 8;
};

// The keep bit of an element from fmix32's state after its first step
// (idx ^ (idx >> 16) ^ kx, see the header): the remaining steps, then
// ((h + k1) & 0xFF) >= cut as (h << 24) + (k1 << 24) >= (cut << 24).
__device__ __forceinline__ bool keep_bit(uint32_t h, uint32_t k1s,
                                         uint32_t cuts) {
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h * (1u << 24) + k1s >= cuts;
}

__device__ __forceinline__ float fwd_value(float v, bool keep, float scale,
                                           float slope) {
  const float l = v >= 0.f ? v : __fmul_rn(v, slope);
  return keep ? __fmul_rn(l, scale) : 0.f;
}

struct FwdArgs {
  uint32_t kx;    // k0 ^ (k0 >> 16)
  uint32_t k1s;   // k1 << 24
  uint32_t cuts;  // cut << 24
  float scale;
  float slope;
};

__device__ __forceinline__ FwdArgs fwd_args(const int64_t* kw, uint32_t cut,
                                            float scale, float slope) {
  const uint32_t k0 = static_cast<uint32_t>(kw[0]);
  const uint32_t k1 = static_cast<uint32_t>(kw[1]);
  return {k0 ^ (k0 >> 16), k1 << 24, cut << 24, scale, slope};
}

// One 16-byte vector whose first element has global index a (a multiple of
// the width): element j's first hash step is h1 ^ j.
__device__ __forceinline__ uint4 fwd_vector(uint4 q, uint32_t a,
                                            const FwdArgs& f, float) {
  const uint32_t h1 = a ^ (a >> 16) ^ f.kx;
  float v[4] = {__uint_as_float(q.x), __uint_as_float(q.y),
                __uint_as_float(q.z), __uint_as_float(q.w)};
#pragma unroll
  for (uint32_t j = 0; j < 4; ++j)
    v[j] = fwd_value(v[j], keep_bit(h1 ^ j, f.k1s, f.cuts), f.scale, f.slope);
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 fwd_vector(uint4 q, uint32_t a,
                                            const FwdArgs& f, __nv_bfloat16) {
  const uint32_t h1 = a ^ (a >> 16) ^ f.kx;
  uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (uint32_t m = 0; m < 4; ++m) {
    // element 2m in the low half of word m, 2m + 1 in the high half
    const float lo = fwd_value(__uint_as_float(w[m] << 16),
                               keep_bit(h1 ^ (2 * m), f.k1s, f.cuts), f.scale,
                               f.slope);
    const float hi = fwd_value(__uint_as_float(w[m] & 0xFFFF0000u),
                               keep_bit(h1 ^ (2 * m + 1), f.k1s, f.cuts),
                               f.scale, f.slope);
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    w[m] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One element at global index idx (any index).
template <typename T>
__device__ __forceinline__ void fwd_element(const T* x, T* y, uint32_t i,
                                            uint32_t idx, const FwdArgs& f) {
  const bool keep = keep_bit(idx ^ (idx >> 16) ^ f.kx, f.k1s, f.cuts);
  store_f32(y, i, fwd_value(load_f32(x, i), keep, f.scale, f.slope));
}

// The vector kernel. Row r = blockIdx.y holds row_len elements at x + r *
// row_len, of global indices first + r * row_stride + offset; its
// row_len / kWidth vectors are walked by the gridDim.x CTAs of the row,
// kUnroll vectors a thread a trip (the thread's vectors kFwdThreads apart,
// so that each load instruction of a warp covers 512 contiguous bytes). The
// row's last row_len % kWidth elements (only on a one-row launch) are the
// scalar tail.
template <typename T, int kUnroll>
__global__ void __launch_bounds__(kFwdThreads)
    lrd_fwd_vector_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const int64_t* __restrict__ kw, uint32_t row_len,
                          uint32_t first, uint32_t row_stride, uint32_t cut,
                          float scale, float slope) {
  constexpr uint32_t kWidth = Vector<T>::kWidth;
  const FwdArgs f = fwd_args(kw, cut, scale, slope);
  const uint32_t row = blockIdx.y;
  const int64_t row_base = static_cast<int64_t>(row) * row_len;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row_base);
  uint4* yv = reinterpret_cast<uint4*>(y + row_base);
  const uint32_t a0 = first + row * row_stride;
  const uint32_t vectors = row_len / kWidth;
  const uint32_t trip = gridDim.x * kFwdThreads * kUnroll;
  for (uint32_t v0 = blockIdx.x * kFwdThreads * kUnroll + threadIdx.x;
       v0 < vectors; v0 += trip) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = v0 + u * kFwdThreads;
      if (v < vectors) q[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = v0 + u * kFwdThreads;
      if (v < vectors) yv[v] = fwd_vector(q[u], a0 + v * kWidth, f, T());
    }
  }
  const uint32_t tail = row_len - vectors * kWidth;
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const uint32_t i = vectors * kWidth + threadIdx.x;
    fwd_element(x + row_base, y + row_base, i, a0 + i, f);
  }
}

// The scalar kernel: the same 2-D walk, one element a thread a trip.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    lrd_fwd_scalar_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const int64_t* __restrict__ kw, uint32_t row_len,
                          uint32_t first, uint32_t row_stride, uint32_t cut,
                          float scale, float slope) {
  const FwdArgs f = fwd_args(kw, cut, scale, slope);
  const uint32_t row = blockIdx.y;
  const int64_t row_base = static_cast<int64_t>(row) * row_len;
  const uint32_t a0 = first + row * row_stride;
  const uint32_t trip = gridDim.x * kFwdThreads;
  for (uint32_t i = blockIdx.x * kFwdThreads + threadIdx.x; i < row_len;
       i += trip)
    fwd_element(x + row_base, y + row_base, i, a0 + i, f);
}

// ---------------------------------------------------------------- backward
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

// The forward's rows: one row of n (contiguous: gap 0), else n / block batch
// rows of block elements, global_stride apart; false when they do not fit
// the launch (more rows than a grid's y, a row past 32 bits).
inline bool fwd_rows(int64_t n, uint32_t block, uint32_t gap, uint32_t* rows,
                     uint32_t* row_len, uint32_t* row_stride) {
  const int64_t len = gap == 0 ? n : block;
  const int64_t count = gap == 0 ? 1 : n / block;
  if (len >= (int64_t{1} << 32) || count > 65535) return false;
  *rows = static_cast<uint32_t>(count);
  *row_len = static_cast<uint32_t>(len);
  *row_stride = block + gap;
  return true;
}

template <typename T>
int launch_fwd(const void* x, void* y, const void* kw, int64_t n,
               uint32_t base, uint32_t h_local, uint32_t h_global,
               uint32_t h0, uint32_t wc, uint32_t cut, float scale,
               float slope, int unroll, uint32_t ctas, void* stream) {
  uint32_t offset, block, gap, rows, row_len, row_stride;
  if (!row_blocks(n, base, h_local, h_global, h0, wc, &offset, &block, &gap) ||
      !fwd_rows(n, block, gap, &rows, &row_len, &row_stride) || ctas == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const T*>(x);
  auto* ys = static_cast<T*>(y);
  const auto* k = static_cast<const int64_t*>(kw);
  const dim3 grid(ctas, rows);
  if (unroll == 0) {
    lrd_fwd_scalar_kernel<T><<<grid, kFwdThreads, 0, s>>>(
        xs, ys, k, row_len, offset, row_stride, cut, scale, slope);
    return static_cast<int>(cudaGetLastError());
  }
  // The vector kernel's preconditions (ops/dropout.launch_plan): 16-byte
  // aligned data, vectors on global indices that are multiples of the
  // width, rows of whole vectors, and at least one vector.
  constexpr uint32_t kWidth = Vector<T>::kWidth;
  const bool fits =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0 && offset % kWidth == 0 &&
      row_len >= kWidth &&
      (rows == 1 || (row_len % kWidth == 0 && row_stride % kWidth == 0));
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  if (unroll == 2)
    lrd_fwd_vector_kernel<T, 2><<<grid, kFwdThreads, 0, s>>>(
        xs, ys, k, row_len, offset, row_stride, cut, scale, slope);
  else if (unroll == 4)
    lrd_fwd_vector_kernel<T, 4><<<grid, kFwdThreads, 0, s>>>(
        xs, ys, k, row_len, offset, row_stride, cut, scale, slope);
  else
    return static_cast<int>(cudaErrorInvalidValue);
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
                float slope, int unroll, uint32_t ctas, void* stream) {
  return launch_fwd<float>(x, y, kw, n, base, h_local, h_global, h0, wc, cut,
                           scale, slope, unroll, ctas, stream);
}

int lrd_fwd_bf16(const void* x, void* y, const void* kw, int64_t n,
                 uint32_t base, uint32_t h_local, uint32_t h_global,
                 uint32_t h0, uint32_t wc, uint32_t cut, float scale,
                 float slope, int unroll, uint32_t ctas, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, y, kw, n, base, h_local, h_global, h0,
                                   wc, cut, scale, slope, unroll, ctas, stream);
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
