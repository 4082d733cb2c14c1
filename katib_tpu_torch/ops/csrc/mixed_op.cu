// Softmax-weighted mixed-op contraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel katib_tpu/ops/mixed_op.py::_kernel, which
// contracts an (n_ops, 512) tile of the stacked primitive outputs against
// the (1, n_ops) weight row on the MXU.  Here one launch covers a whole DARTS
// edge group (the nn.vmap axis of the JAX cell):
//
//     out[e, m] = sum_{o = 0 .. n_ops-1} w[e, o] * x[e, o, m]
//
// with w float32 (E, n_ops), x contiguous (E, n_ops, M) in bf16 or f32, out
// (E, M) in x's dtype, and the sum accumulated in f32 in the order o = 0, 1, ...
//
// Bound: device-memory bandwidth.  The kernel reads (n_ops + 1) * M elements
// per edge for n_ops * M fused multiply-adds, about 0.5 FLOP per byte in bf16
// against the ~295 FLOP per byte the card needs to be compute-bound.  So the
// design only has to stream bytes well: each thread loads 16 bytes of every
// operand row (8 bf16 or 4 f32 values) with all n_ops loads issued before the
// first FMA, keeps the edge's weight row in registers, and writes 16 bytes.
// No shared memory, no tensor cores.  Rows whose length or base address does
// not allow 16-byte access take a scalar path that masks the ragged tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOps = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// values of T in one 16-byte access
template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);
};

// x: (E, n_ops, M) with M % Pack<T>::kN == 0 and 16-byte aligned rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
mixed_op_vec_kernel(const float* __restrict__ w, const T* __restrict__ x,
                    T* __restrict__ out, int n_ops, int64_t m) {
  constexpr int kN = Pack<T>::kN;
  const int e = blockIdx.y;
  float wr[kMaxOps];
#pragma unroll
  for (int o = 0; o < kMaxOps; ++o) wr[o] = o < n_ops ? w[e * n_ops + o] : 0.f;

  const int64_t n_vec = m / kN;
  const uint4* xe = reinterpret_cast<const uint4*>(x + (int64_t)e * n_ops * m);
  uint4* oe = reinterpret_cast<uint4*>(out + (int64_t)e * m);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint4 rows[kMaxOps];
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o)
      if (o < n_ops) rows[o] = __ldcs(xe + o * n_vec + i);
    float acc[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = 0.f;
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o)
      if (o < n_ops) {
        const T* v = reinterpret_cast<const T*>(&rows[o]);
#pragma unroll
        for (int j = 0; j < kN; ++j) acc[j] = fmaf(wr[o], to_f32(v[j]), acc[j]);
      }
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < kN; ++j) r[j] = from_f32<T>(acc[j]);
    __stcs(oe + i, res);
  }
}

// any M, any alignment: one element per thread per iteration
template <typename T>
__global__ void __launch_bounds__(kThreads)
mixed_op_scalar_kernel(const float* __restrict__ w, const T* __restrict__ x,
                       T* __restrict__ out, int n_ops, int64_t m) {
  const int e = blockIdx.y;
  float wr[kMaxOps];
#pragma unroll
  for (int o = 0; o < kMaxOps; ++o) wr[o] = o < n_ops ? w[e * n_ops + o] : 0.f;

  const T* xe = x + (int64_t)e * n_ops * m;
  T* oe = out + (int64_t)e * m;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    float vals[kMaxOps];
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o)
      if (o < n_ops) vals[o] = to_f32(xe[o * m + i]);
    float acc = 0.f;
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o)
      if (o < n_ops) acc = fmaf(wr[o], vals[o], acc);
    oe[i] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const float* w, const T* x, T* out, int e, int n_ops, int64_t m,
                   cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  const bool vec = m % kN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t work = vec ? m / kN : m;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;
  const dim3 grid((unsigned)blocks, (unsigned)e);
  if (vec)
    mixed_op_vec_kernel<T><<<grid, kThreads, 0, stream>>>(w, x, out, n_ops, m);
  else
    mixed_op_scalar_kernel<T><<<grid, kThreads, 0, stream>>>(w, x, out, n_ops, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take.
int katib_mixed_op_sum(const void* w, const void* x, void* out, int e, int n_ops,
                       long long m, int dtype, void* stream) {
  if (e < 1 || e > 65535 || n_ops < 1 || n_ops > kMaxOps || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return (int)launch<float>(wf, static_cast<const float*>(x), static_cast<float*>(out), e,
                              n_ops, (int64_t)m, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(wf, static_cast<const __nv_bfloat16*>(x),
                                      static_cast<__nv_bfloat16*>(out), e, n_ops, (int64_t)m, s);
  return (int)cudaErrorInvalidValue;
}

const char* katib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
