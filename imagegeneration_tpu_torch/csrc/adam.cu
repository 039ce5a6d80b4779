// Keras-form Adam apply over a list of float32 leaves, one launch, in place;
// the moments m and v float32 or bfloat16.
//
// Replaces the TPU kernel `_kernel` / `fused_adam_leaf` of
// imagegeneration_tpu/ops/pallas/adam.py:69, which applies one leaf:
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p + (-alpha * m') / (sqrt(v') + eps)
//
// alpha = lr * sqrt(1 - b2^t) / (1 - b1^t) is read from a 1-element float32
// device tensor (the counterpart of the TPU kernel's SMEM scalar), so the
// launch needs no host sync.
//
// Bound on the H100: device-memory bandwidth. Each element reads p, g, m, v
// and writes p, m, v: 28 bytes, 20 with bfloat16 moments. An optimizer apply is many leaves, most of
// them biases and norm scales of 3-512 elements, for which a launch of its
// own costs far more than their bytes. So one launch applies a whole table
// of leaves:
//
// - The table (`AdamTable`) goes by value as the kernel's parameters
//   (CUDA 12.1+ takes up to 32,764 bytes): per leaf the p, g, m, v
//   pointers, the element count, the quad body and the index of the
//   leaf's first chunk. A list longer than one table is several launches.
// - Each leaf is cut into chunks of `chunk` elements (a multiple of 4,
//   counted from the start of its body). A persistent grid, as many CTAs as
//   the card holds at once, walks the chunks grid-stride; a CTA finds a
//   chunk's leaf by binary search in the prefix of chunk counts, which
//   never reads past `first_chunk[leaves]`.
// - A chunk's part of the leaf's body moves in quads of 4 elements: p and g
//   as float4 (16-byte loads and stores), m and v as float4 or, bfloat16,
//   as one 8-byte uint2 each; the scalar head before the body and the tail
//   after it element by element. A leaf whose four tensors do not sit at
//   the same element phase of their quads has an empty body and goes
//   scalar throughout.
// - p, m and v are updated in place (each element read and written by one
//   thread), so the optimizer keeps one copy of its state.
//
// The launch plan (bodies, chunks, groups) is computed in Python
// (ops/adam.py `launch_groups`, tested on the CPU); `adam_multi_f32` only
// checks it and returns cudaErrorInvalidValue, launching nothing, if it is
// not one this kernel covers exactly.
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn): nvcc may not contract them into FMAs, so the
// kernel evaluates the same IEEE float32 expressions, in the same order, as
// the plain PyTorch version in ops/adam.py, bit for bit.
//
// bfloat16 moments (the JAX package's `moment_dtype=jnp.bfloat16`, which
// its Pallas kernel never takes: imagegeneration_tpu/train/common.py:125
// sends them to the inline XLA formula) are widened to float32 exactly,
// updated by the same expressions, the parameter update taken from the
// float32 values, and stored with __float2bfloat16_rn (round to nearest
// even, as torch's and XLA's casts). The kernel is a template on the
// moment type; its float32 form is the one above.
//
// C interface: the table and the CUDA stream; `adam_multi_f32` and
// `adam_multi_bf16` launch the two forms and return cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "the leaf table goes by value as kernel parameters: CUDA 12.1+ takes 32,764 bytes"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 512;  // TABLE_LEAVES in ops/adam.py
constexpr int kMaxParamBytes = 32764;
constexpr int kMaxDevices = 64;

// Mirrored field for field by `AdamTable` in ops/adam.py (ctypes); the
// padding is explicit and the layout is asserted here and checked against
// the ctypes one when the library is loaded (`adam_table_layout`). m and v
// point to float or __nv_bfloat16, as the form launched says.
struct AdamTable {
  const float* alpha;
  float b1;
  float b2;
  float one_minus_b1;
  float one_minus_b2;
  float eps;
  int32_t leaves;
  int32_t chunk;
  int32_t pad0;
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t body_end[kMaxLeaves];
  int32_t body_begin[kMaxLeaves];
  int32_t first_chunk[kMaxLeaves + 1];
  int32_t pad1;
};

static_assert(offsetof(AdamTable, alpha) == 0, "AdamTable layout");
static_assert(offsetof(AdamTable, b1) == 8, "AdamTable layout");
static_assert(offsetof(AdamTable, eps) == 24, "AdamTable layout");
static_assert(offsetof(AdamTable, leaves) == 28, "AdamTable layout");
static_assert(offsetof(AdamTable, chunk) == 32, "AdamTable layout");
static_assert(offsetof(AdamTable, p) == 40, "AdamTable layout");
static_assert(offsetof(AdamTable, g) == 4136, "AdamTable layout");
static_assert(offsetof(AdamTable, m) == 8232, "AdamTable layout");
static_assert(offsetof(AdamTable, v) == 12328, "AdamTable layout");
static_assert(offsetof(AdamTable, n) == 16424, "AdamTable layout");
static_assert(offsetof(AdamTable, body_end) == 20520, "AdamTable layout");
static_assert(offsetof(AdamTable, body_begin) == 24616, "AdamTable layout");
static_assert(offsetof(AdamTable, first_chunk) == 26664, "AdamTable layout");
static_assert(offsetof(AdamTable, pad1) == 28716, "AdamTable layout");
static_assert(sizeof(AdamTable) == 28720, "AdamTable layout");
static_assert(sizeof(AdamTable) <= kMaxParamBytes, "AdamTable exceeds the parameter limit");

struct Coefs {
  float neg_alpha, b1, b2, one_minus_b1, one_minus_b2, eps;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v,
                                             const Coefs& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.one_minus_b2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(__fmul_rn(c.neg_alpha, m), __fadd_rn(__fsqrt_rn(v), c.eps));
  p = __fadd_rn(p, upd);
}

// Moments as float32 in registers: a float is itself; a bfloat16 widens
// exactly and narrows rounding to nearest even.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename M>
__device__ __forceinline__ M narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Quad j of moments from a quad-aligned address: one float4, or one
// 8-byte uint2 of bfloat16s (element 0 in the low half of .x).
__device__ __forceinline__ float4 load_quad(const float* m, int64_t j) {
  return reinterpret_cast<const float4*>(m)[j];
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* m, int64_t j) {
  const uint2 raw = reinterpret_cast<const uint2*>(m)[j];
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store_quad(float* m, int64_t j, const float4& q) {
  reinterpret_cast<float4*>(m)[j] = q;
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* m, int64_t j, const float4& q) {
  uint2 raw;
  raw.x = bf16_bits(q.x) | (bf16_bits(q.y) << 16);
  raw.y = bf16_bits(q.z) | (bf16_bits(q.w) << 16);
  reinterpret_cast<uint2*>(m)[j] = raw;
}

template <typename M>
__device__ __forceinline__ void adam_scalar(float* p, const float* g, M* m, M* v,
                                            int64_t i, const Coefs& c) {
  float pi = p[i], mi = widen(m[i]), vi = widen(v[i]);
  adam_element(pi, g[i], mi, vi, c);
  p[i] = pi;
  m[i] = narrow<M>(mi);
  v[i] = narrow<M>(vi);
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const __grid_constant__ AdamTable t) {
  const Coefs c{-__ldg(t.alpha), t.b1, t.b2, t.one_minus_b1, t.one_minus_b2, t.eps};
  const int total = t.first_chunk[t.leaves];
  for (int chunk = blockIdx.x; chunk < total; chunk += gridDim.x) {
    // The leaf of this chunk: the last i < leaves with first_chunk[i] <= chunk.
    int lo = 0, hi = t.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.first_chunk[mid] <= chunk) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int leaf = lo;
    const int k = chunk - t.first_chunk[leaf];
    const bool last = chunk + 1 == t.first_chunk[leaf + 1];
    const int64_t n = t.n[leaf];
    const int64_t body_begin = t.body_begin[leaf];
    const int64_t body_end = t.body_end[leaf];
    // Chunk k covers [start, stop): [start, vec_start) and [vec_stop, stop)
    // scalar, [vec_start, vec_stop) in quads (ops/adam.py `chunk_bounds`).
    const int64_t start = k == 0 ? 0 : body_begin + static_cast<int64_t>(k) * t.chunk;
    const int64_t stop = last ? n : body_begin + static_cast<int64_t>(k + 1) * t.chunk;
    const int64_t vec_start = start > body_begin ? start : body_begin;
    const int64_t body_stop = stop < body_end ? stop : body_end;
    const int64_t vec_stop = body_stop > vec_start ? body_stop : vec_start;
    float* p = t.p[leaf];
    const float* g = t.g[leaf];
    M* m = static_cast<M*>(t.m[leaf]);
    M* v = static_cast<M*>(t.v[leaf]);

    float4* p4 = reinterpret_cast<float4*>(p + vec_start);
    const float4* g4 = reinterpret_cast<const float4*>(g + vec_start);
    M* mq = m + vec_start;
    M* vq = v + vec_start;
    const int64_t quads = (vec_stop - vec_start) >> 2;
    for (int64_t j = threadIdx.x; j < quads; j += kThreads) {
      float4 pj = p4[j], mj = load_quad(mq, j), vj = load_quad(vq, j);
      const float4 gj = __ldg(g4 + j);
      adam_element(pj.x, gj.x, mj.x, vj.x, c);
      adam_element(pj.y, gj.y, mj.y, vj.y, c);
      adam_element(pj.z, gj.z, mj.z, vj.z, c);
      adam_element(pj.w, gj.w, mj.w, vj.w, c);
      p4[j] = pj;
      store_quad(mq, j, mj);
      store_quad(vq, j, vj);
    }
    for (int64_t i = start + threadIdx.x; i < vec_start; i += kThreads) {
      adam_scalar(p, g, m, v, i, c);
    }
    for (int64_t i = vec_stop + threadIdx.x; i < stop; i += kThreads) {
      adam_scalar(p, g, m, v, i, c);
    }
  }
}

// Whether an element at `offset` of a tensor of `width`-byte elements
// starting at `ptr` begins a quad: an address multiple of 4 * width.
bool quad_aligned(const void* ptr, int64_t offset, int width) {
  return (reinterpret_cast<uintptr_t>(ptr) + static_cast<uintptr_t>(width * offset)) %
             (4 * width) == 0;
}

// Whether the table is a plan the kernel's form for `moment_width`-byte
// moments covers exactly: every leaf non-empty with four element-aligned
// pointers, a body of whole quads aligned in all four (or none, then
// starting at 0), and as many chunks in the prefix as its elements from the
// body's start need.
bool plan_ok(const AdamTable& t, int moment_width) {
  if (t.leaves < 1 || t.leaves > kMaxLeaves || t.chunk < 4 || t.chunk % 4 != 0 ||
      t.alpha == nullptr || t.first_chunk[0] != 0) {
    return false;
  }
  for (int i = 0; i < t.leaves; ++i) {
    const int64_t n = t.n[i], begin = t.body_begin[i], end = t.body_end[i];
    if (n < 1 || !t.p[i] || !t.g[i] || !t.m[i] || !t.v[i]) return false;
    if (reinterpret_cast<uintptr_t>(t.p[i]) % 4 || reinterpret_cast<uintptr_t>(t.g[i]) % 4 ||
        reinterpret_cast<uintptr_t>(t.m[i]) % moment_width ||
        reinterpret_cast<uintptr_t>(t.v[i]) % moment_width) {
      return false;
    }
    if (begin < 0 || begin > end || end > n || (end - begin) % 4 != 0) return false;
    if (end > begin) {
      if (!quad_aligned(t.p[i], begin, 4) || !quad_aligned(t.g[i], begin, 4) ||
          !quad_aligned(t.m[i], begin, moment_width) ||
          !quad_aligned(t.v[i], begin, moment_width)) {
        return false;
      }
    } else if (begin != 0) {
      return false;
    }
    int64_t chunks = (n - begin + t.chunk - 1) / t.chunk;
    if (chunks < 1) chunks = 1;
    if (static_cast<int64_t>(t.first_chunk[i + 1]) - t.first_chunk[i] != chunks) return false;
  }
  return true;
}

// CTAs of the persistent grid of the form for moments M on the current
// device: as many as its SMs hold at once (the occupancy API), computed
// once per device.
template <typename M>
cudaError_t grid_ctas(int* ctas) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_multi_kernel<M>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *ctas = cached[dev];
  return cudaSuccess;
}

// `table_ptr` points to an AdamTable (typed void: the struct has internal
// linkage, and the entry points must not).
template <typename M>
int launch(const void* table_ptr, void* stream) {
  const AdamTable* table = static_cast<const AdamTable*>(table_ptr);
  if (table == nullptr || !plan_ok(*table, static_cast<int>(sizeof(M)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ctas = 0;
  const cudaError_t err = grid_ctas<M>(&ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = table->first_chunk[table->leaves];
  const int grid = total < ctas ? total : ctas;
  adam_multi_kernel<M><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*table);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Byte offsets of AdamTable's fields in declaration order, then its size:
// the ctypes mirror in ops/adam.py is checked against these on load.
int adam_table_layout(int64_t* out, int capacity) {
  const int64_t values[] = {
      offsetof(AdamTable, alpha),        offsetof(AdamTable, b1),
      offsetof(AdamTable, b2),           offsetof(AdamTable, one_minus_b1),
      offsetof(AdamTable, one_minus_b2), offsetof(AdamTable, eps),
      offsetof(AdamTable, leaves),       offsetof(AdamTable, chunk),
      offsetof(AdamTable, pad0),         offsetof(AdamTable, p),
      offsetof(AdamTable, g),            offsetof(AdamTable, m),
      offsetof(AdamTable, v),            offsetof(AdamTable, n),
      offsetof(AdamTable, body_end),     offsetof(AdamTable, body_begin),
      offsetof(AdamTable, first_chunk),  offsetof(AdamTable, pad1),
      sizeof(AdamTable)};
  const int count = static_cast<int>(sizeof(values) / sizeof(values[0]));
  for (int i = 0; i < count && i < capacity; ++i) out[i] = values[i];
  return count;
}

// The persistent grid's CTA count on the current device of the float32-
// (bf16_moments = 0) or bfloat16-moment form, or minus a CUDA error code.
int adam_grid_ctas(int bf16_moments) {
  int ctas = 0;
  const cudaError_t err =
      bf16_moments ? grid_ctas<__nv_bfloat16>(&ctas) : grid_ctas<float>(&ctas);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

// The form with float32 moments.
int adam_multi_f32(const void* table_ptr, void* stream) {
  return launch<float>(table_ptr, stream);
}

// The form with bfloat16 moments (p and g float32).
int adam_multi_bf16(const void* table_ptr, void* stream) {
  return launch<__nv_bfloat16>(table_ptr, stream);
}

const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
