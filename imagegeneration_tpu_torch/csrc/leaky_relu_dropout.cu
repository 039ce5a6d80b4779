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
// Both passes walk the tensor the same way, from one launch plan
// (ops/dropout.launch_plan), and move 16 bytes per access: 8 bf16 or 4
// float32 values a vector, each thread issuing the loads of U vectors (U = 2
// or 4, from the plan) before it hashes any of them, so that an SM keeps
// tens of KB in flight (the backward loads U vectors of x and U of g); the
// plan gives each CTA a single trip of kThreads * U vectors (such grids ran
// level with a copy of the same bytes, a few % ahead of one persistent
// wave). The tensor is walked as rows of a 2-D (row, offset) grid: one row
// for a contiguous tensor (one device, or data parallelism alone), one per
// batch row of a spatial shard, so that the global index is first + offset
// with no division (a vector never straddles a row: the plan checks that
// W*C is a multiple of the vector). The hash takes the same bits with less
// integer work:
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
// tensor whose data (x, and g and dx in the backward) is not 16-byte
// aligned, or whose rows or index do not fall on vector boundaries, takes
// the scalar kernel of its pass, the same walk one element at a time.
//
// The backward moves 3 tensors' bytes (1.5x the forward's) with the same
// integer work an element, so its bound is the bytes with more room to
// spare; it computes dx = keep ? (x >= 0 ? g*scale : (g*scale)*slope) : 0
// in float32 with __fmul_rn (no FMA contraction), the plain version's bits.
//
// C interface: raw pointers, the element count, the index base, the row
// block (h_local, h_global, h0, wc), the plan (unroll: 0 for the scalar
// kernel, else U; CTAs along a row) and the CUDA stream; each entry point
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue,
// before any launch, for a row block that does not fit or a plan the tensor
// does not allow).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, uint32_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, uint32_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, uint32_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, uint32_t i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

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

// The mask's key words as the folded hash takes them, and the pass's
// float32 constants.
struct MaskArgs {
  uint32_t kx;    // k0 ^ (k0 >> 16)
  uint32_t k1s;   // k1 << 24
  uint32_t cuts;  // cut << 24
  float scale;
  float slope;
};

__device__ __forceinline__ MaskArgs mask_args(const int64_t* kw, uint32_t cut,
                                              float scale, float slope) {
  const uint32_t k0 = static_cast<uint32_t>(kw[0]);
  const uint32_t k1 = static_cast<uint32_t>(kw[1]);
  return {k0 ^ (k0 >> 16), k1 << 24, cut << 24, scale, slope};
}

// The first hash step of an element at global index idx (any index).
__device__ __forceinline__ bool keep_at(uint32_t idx, const MaskArgs& f) {
  return keep_bit(idx ^ (idx >> 16) ^ f.kx, f.k1s, f.cuts);
}

__device__ __forceinline__ float fwd_value(float v, bool keep,
                                           const MaskArgs& f) {
  const float l = v >= 0.f ? v : __fmul_rn(v, f.slope);
  return keep ? __fmul_rn(l, f.scale) : 0.f;
}

__device__ __forceinline__ float bwd_value(float v, float g, bool keep,
                                           const MaskArgs& f) {
  const float gs = __fmul_rn(g, f.scale);
  const float d = v >= 0.f ? gs : __fmul_rn(gs, f.slope);
  return keep ? d : 0.f;
}

// One 16-byte vector whose first element has global index a (a multiple of
// the width): element j's first hash step is h1 ^ j. bf16: element 2m in
// the low half of word m, 2m + 1 in the high half.
__device__ __forceinline__ uint4 fwd_vector(uint4 q, uint32_t a,
                                            const MaskArgs& f, float) {
  const uint32_t h1 = a ^ (a >> 16) ^ f.kx;
  float v[4] = {__uint_as_float(q.x), __uint_as_float(q.y),
                __uint_as_float(q.z), __uint_as_float(q.w)};
#pragma unroll
  for (uint32_t j = 0; j < 4; ++j)
    v[j] = fwd_value(v[j], keep_bit(h1 ^ j, f.k1s, f.cuts), f);
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 fwd_vector(uint4 q, uint32_t a,
                                            const MaskArgs& f, __nv_bfloat16) {
  const uint32_t h1 = a ^ (a >> 16) ^ f.kx;
  uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (uint32_t m = 0; m < 4; ++m) {
    const float lo = fwd_value(__uint_as_float(w[m] << 16),
                               keep_bit(h1 ^ (2 * m), f.k1s, f.cuts), f);
    const float hi = fwd_value(__uint_as_float(w[m] & 0xFFFF0000u),
                               keep_bit(h1 ^ (2 * m + 1), f.k1s, f.cuts), f);
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    w[m] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 bwd_vector(uint4 qx, uint4 qg, uint32_t a,
                                            const MaskArgs& f, float) {
  const uint32_t h1 = a ^ (a >> 16) ^ f.kx;
  const float g[4] = {__uint_as_float(qg.x), __uint_as_float(qg.y),
                      __uint_as_float(qg.z), __uint_as_float(qg.w)};
  float v[4] = {__uint_as_float(qx.x), __uint_as_float(qx.y),
                __uint_as_float(qx.z), __uint_as_float(qx.w)};
#pragma unroll
  for (uint32_t j = 0; j < 4; ++j)
    v[j] = bwd_value(v[j], g[j], keep_bit(h1 ^ j, f.k1s, f.cuts), f);
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// bf16: all 8 elements of x and g unpacked before any is computed, which
// ran 1-4% faster at the small SNDCGAN sites than the forward's word by
// word form (tools/dropout_times.py, PERF.md).
__device__ __forceinline__ uint4 bwd_vector(uint4 qx, uint4 qg, uint32_t a,
                                            const MaskArgs& f, __nv_bfloat16) {
  const uint32_t h1 = a ^ (a >> 16) ^ f.kx;
  const uint32_t wx[4] = {qx.x, qx.y, qx.z, qx.w};
  const uint32_t wg[4] = {qg.x, qg.y, qg.z, qg.w};
  float v[8], g[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[2 * m] = __uint_as_float(wx[m] << 16);
    v[2 * m + 1] = __uint_as_float(wx[m] & 0xFFFF0000u);
    g[2 * m] = __uint_as_float(wg[m] << 16);
    g[2 * m + 1] = __uint_as_float(wg[m] & 0xFFFF0000u);
  }
#pragma unroll
  for (uint32_t j = 0; j < 8; ++j)
    v[j] = bwd_value(v[j], g[j], keep_bit(h1 ^ j, f.k1s, f.cuts), f);
  uint32_t w[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * m], v[2 * m + 1]);
    w[m] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The vector kernels. Row r = blockIdx.y holds row_len elements at x + r *
// row_len, of global indices first + r * row_stride + offset; its
// row_len / kWidth vectors are walked by the gridDim.x CTAs of the row,
// kUnroll vectors a thread a trip (the thread's vectors kThreads apart, so
// that each load instruction of a warp covers 512 contiguous bytes). The
// row's last row_len % kWidth elements (only on a one-row launch) are the
// scalar tail.
template <typename T, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    lrd_fwd_vector_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const int64_t* __restrict__ kw, uint32_t row_len,
                          uint32_t first, uint32_t row_stride, uint32_t cut,
                          float scale, float slope) {
  constexpr uint32_t kWidth = Vector<T>::kWidth;
  const MaskArgs f = mask_args(kw, cut, scale, slope);
  const uint32_t row = blockIdx.y;
  const int64_t row_base = static_cast<int64_t>(row) * row_len;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row_base);
  uint4* yv = reinterpret_cast<uint4*>(y + row_base);
  const uint32_t a0 = first + row * row_stride;
  const uint32_t vectors = row_len / kWidth;
  const uint32_t trip = gridDim.x * kThreads * kUnroll;
  for (uint32_t v0 = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       v0 < vectors; v0 += trip) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = v0 + u * kThreads;
      if (v < vectors) q[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = v0 + u * kThreads;
      if (v < vectors) yv[v] = fwd_vector(q[u], a0 + v * kWidth, f, T());
    }
  }
  const uint32_t tail = row_len - vectors * kWidth;
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const uint32_t i = vectors * kWidth + threadIdx.x;
    store_f32(y + row_base, i,
              fwd_value(load_f32(x + row_base, i), keep_at(a0 + i, f), f));
  }
}

template <typename T, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    lrd_bwd_vector_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          T* __restrict__ dx, const int64_t* __restrict__ kw,
                          uint32_t row_len, uint32_t first,
                          uint32_t row_stride, uint32_t cut, float scale,
                          float slope) {
  constexpr uint32_t kWidth = Vector<T>::kWidth;
  const MaskArgs f = mask_args(kw, cut, scale, slope);
  const uint32_t row = blockIdx.y;
  const int64_t row_base = static_cast<int64_t>(row) * row_len;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row_base);
  const uint4* gv = reinterpret_cast<const uint4*>(g + row_base);
  uint4* dv = reinterpret_cast<uint4*>(dx + row_base);
  const uint32_t a0 = first + row * row_stride;
  const uint32_t vectors = row_len / kWidth;
  const uint32_t trip = gridDim.x * kThreads * kUnroll;
  for (uint32_t v0 = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       v0 < vectors; v0 += trip) {
    uint4 qx[kUnroll], qg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = v0 + u * kThreads;
      if (v < vectors) {
        qx[u] = __ldg(xv + v);
        qg[u] = __ldg(gv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t v = v0 + u * kThreads;
      if (v < vectors)
        dv[v] = bwd_vector(qx[u], qg[u], a0 + v * kWidth, f, T());
    }
  }
  const uint32_t tail = row_len - vectors * kWidth;
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const uint32_t i = vectors * kWidth + threadIdx.x;
    store_f32(dx + row_base, i,
              bwd_value(load_f32(x + row_base, i), load_f32(g + row_base, i),
                        keep_at(a0 + i, f), f));
  }
}

// The scalar kernels: the same 2-D walk, one element a thread a trip.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrd_fwd_scalar_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const int64_t* __restrict__ kw, uint32_t row_len,
                          uint32_t first, uint32_t row_stride, uint32_t cut,
                          float scale, float slope) {
  const MaskArgs f = mask_args(kw, cut, scale, slope);
  const int64_t row_base = static_cast<int64_t>(blockIdx.y) * row_len;
  const uint32_t a0 = first + blockIdx.y * row_stride;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < row_len;
       i += gridDim.x * kThreads)
    store_f32(y + row_base, i,
              fwd_value(load_f32(x + row_base, i), keep_at(a0 + i, f), f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrd_bwd_scalar_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          T* __restrict__ dx, const int64_t* __restrict__ kw,
                          uint32_t row_len, uint32_t first,
                          uint32_t row_stride, uint32_t cut, float scale,
                          float slope) {
  const MaskArgs f = mask_args(kw, cut, scale, slope);
  const int64_t row_base = static_cast<int64_t>(blockIdx.y) * row_len;
  const uint32_t a0 = first + blockIdx.y * row_stride;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < row_len;
       i += gridDim.x * kThreads)
    store_f32(dx + row_base, i,
              bwd_value(load_f32(x + row_base, i), load_f32(g + row_base, i),
                        keep_at(a0 + i, f), f));
}

// A launch's grid: its rows, their length and global stride, and the first
// global index; false when the row block does not fit (h_local rows at h0
// inside h_global, a whole number of rows) or the rows do not fit the
// launch (more rows than a grid's y, a row past 32 bits).
struct Grid {
  uint32_t rows, row_len, first, row_stride;
};

inline bool grid_of(int64_t n, uint32_t base, uint32_t h_local,
                    uint32_t h_global, uint32_t h0, uint32_t wc, Grid* grid) {
  const uint64_t block = static_cast<uint64_t>(h_local) * wc;
  if (h_local == 0 || wc == 0 || h0 + h_local > h_global ||
      static_cast<uint64_t>(n) % block != 0)
    return false;
  // a whole map is one contiguous row; a shard one row per batch row
  const bool whole = h_local == h_global;
  const int64_t len = whole ? n : static_cast<int64_t>(block);
  const int64_t count = whole ? 1 : n / static_cast<int64_t>(block);
  if (len >= (int64_t{1} << 32) || count > 65535) return false;
  *grid = {static_cast<uint32_t>(count), static_cast<uint32_t>(len),
           base + h0 * wc, static_cast<uint32_t>(h_global * wc)};
  return true;
}

// The vector kernels' preconditions (ops/dropout.launch_plan): 16-byte
// aligned data, vectors on global indices that are multiples of the width,
// rows of whole vectors, and at least one vector.
template <typename T>
inline bool vectors_fit(const Grid& grid,
                        std::initializer_list<const void*> data) {
  constexpr uint32_t kWidth = Vector<T>::kWidth;
  for (const void* p : data)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return grid.first % kWidth == 0 && grid.row_len >= kWidth &&
         (grid.rows == 1 ||
          (grid.row_len % kWidth == 0 && grid.row_stride % kWidth == 0));
}

template <typename T>
int launch_fwd(const void* x, void* y, const void* kw, int64_t n,
               uint32_t base, uint32_t h_local, uint32_t h_global,
               uint32_t h0, uint32_t wc, uint32_t cut, float scale,
               float slope, int unroll, uint32_t ctas, void* stream) {
  Grid g;
  if (!grid_of(n, base, h_local, h_global, h0, wc, &g) || ctas == 0 ||
      (unroll != 0 && !vectors_fit<T>(g, {x, y})))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const T*>(x);
  auto* ys = static_cast<T*>(y);
  const auto* k = static_cast<const int64_t*>(kw);
  const dim3 grid(ctas, g.rows);
  if (unroll == 0)
    lrd_fwd_scalar_kernel<T><<<grid, kThreads, 0, s>>>(
        xs, ys, k, g.row_len, g.first, g.row_stride, cut, scale, slope);
  else if (unroll == 2)
    lrd_fwd_vector_kernel<T, 2><<<grid, kThreads, 0, s>>>(
        xs, ys, k, g.row_len, g.first, g.row_stride, cut, scale, slope);
  else if (unroll == 4)
    lrd_fwd_vector_kernel<T, 4><<<grid, kThreads, 0, s>>>(
        xs, ys, k, g.row_len, g.first, g.row_stride, cut, scale, slope);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, const void* kw,
               int64_t n, uint32_t base, uint32_t h_local, uint32_t h_global,
               uint32_t h0, uint32_t wc, uint32_t cut, float scale,
               float slope, int unroll, uint32_t ctas, void* stream) {
  Grid gr;
  if (!grid_of(n, base, h_local, h_global, h0, wc, &gr) || ctas == 0 ||
      (unroll != 0 && !vectors_fit<T>(gr, {x, g, dx})))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const T*>(x);
  const auto* gs = static_cast<const T*>(g);
  auto* dxs = static_cast<T*>(dx);
  const auto* k = static_cast<const int64_t*>(kw);
  const dim3 grid(ctas, gr.rows);
  if (unroll == 0)
    lrd_bwd_scalar_kernel<T><<<grid, kThreads, 0, s>>>(
        xs, gs, dxs, k, gr.row_len, gr.first, gr.row_stride, cut, scale, slope);
  else if (unroll == 2)
    lrd_bwd_vector_kernel<T, 2><<<grid, kThreads, 0, s>>>(
        xs, gs, dxs, k, gr.row_len, gr.first, gr.row_stride, cut, scale, slope);
  else if (unroll == 4)
    lrd_bwd_vector_kernel<T, 4><<<grid, kThreads, 0, s>>>(
        xs, gs, dxs, k, gr.row_len, gr.first, gr.row_stride, cut, scale, slope);
  else
    return static_cast<int>(cudaErrorInvalidValue);
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
                float slope, int unroll, uint32_t ctas, void* stream) {
  return launch_bwd<float>(x, g, dx, kw, n, base, h_local, h_global, h0, wc,
                           cut, scale, slope, unroll, ctas, stream);
}

int lrd_bwd_bf16(const void* x, const void* g, void* dx, const void* kw,
                 int64_t n, uint32_t base, uint32_t h_local, uint32_t h_global,
                 uint32_t h0, uint32_t wc, uint32_t cut, float scale,
                 float slope, int unroll, uint32_t ctas, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dx, kw, n, base, h_local, h_global,
                                   h0, wc, cut, scale, slope, unroll, ctas,
                                   stream);
}

const char* lrd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
