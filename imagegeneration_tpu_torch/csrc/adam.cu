// Keras-form Adam apply on one float32 leaf, in place.
//
// Replaces the TPU kernel `_kernel` / `fused_adam_leaf` of
// imagegeneration_tpu/ops/pallas/adam.py:
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p + (-alpha * m') / (sqrt(v') + eps)
//
// alpha = lr * sqrt(1 - b2^t) / (1 - b1^t) is read from a 1-element float32
// device tensor (the counterpart of the TPU kernel's SMEM scalar), so the
// launch needs no host sync.
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn): nvcc may not contract them into FMAs, so the
// kernel evaluates the same IEEE float32 expressions, in the same order, as
// the plain PyTorch version in ops/adam.py.
//
// Bound on the H100: device-memory bandwidth. Each element reads p, g, m, v
// and writes p, m, v: 28 bytes. The update is written in place (p, m and v
// are both read and written at the same index by the same thread), which
// keeps the optimizer state at one copy.
//
// C interface: raw pointers, the element count and the CUDA stream; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ m, float* __restrict__ v,
                            const float* __restrict__ alpha, int64_t n,
                            float b1, float b2, float one_minus_b1,
                            float one_minus_b2, float eps) {
  const float neg_alpha = -alpha[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float mi =
        __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
    m[i] = mi;
    v[i] = vi;
    const float upd = __fdiv_rn(__fmul_rn(neg_alpha, mi),
                                __fadd_rn(__fsqrt_rn(vi), eps));
    p[i] = __fadd_rn(p[i], upd);
  }
}

}  // namespace

extern "C" {

int adam_f32(void* p, const void* g, void* m, void* v, const void* alpha,
             int64_t n, float b1, float b2, float one_minus_b1,
             float one_minus_b2, float eps, void* stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  adam_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(alpha), n, b1, b2, one_minus_b1, one_minus_b2,
      eps);
  return static_cast<int>(cudaGetLastError());
}

const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
