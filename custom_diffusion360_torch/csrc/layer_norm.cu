// LayerNorm over the last axis for Hopper (sm_90a).
//
// Replaces custom_diffusion360_tpu/ops/norms.py::layer_norm_fused (kernel
// _ln_kernel, pallas_call :64): y = (x - mean) * rsqrt(var + eps) * scale +
// bias over rows of C channels, f32 statistics, f32 scale/bias, output in
// the input dtype (bf16 or f32).
//
// Bound on the H100: memory. One read of x and one write of y; the
// statistics are a few flops per byte.
//
// Design: one warp per row, 8 rows per 256-thread block. Each lane walks
// the row in 16-byte vectors (8 bf16 or 4 f32; the wrapper checks
// C % 8 == 0 and 16-byte aligned bases, so every vector is aligned). Three
// passes over the row: the mean, the centred sum of squares (two-pass, no
// E[x^2] - E[x]^2 cancellation), then normalize + affine; the second and
// third passes re-read a row of at most a few KB from L1. The TPU kernel's
// C % 128 rule is a lane rule and does not apply here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  long long rows, int C, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float s = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) s += to_f(v[j]);
  }
  const float mean = warp_sum(s) / (float)C;

  float ss = 0.f;
  for (int c = lane * V; c < C; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = to_f(v[j]) - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);

  for (int c = lane * V; c < C; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* v = reinterpret_cast<const T*>(&raw);
    __align__(16) T out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = from_f<T>((to_f(v[j]) - mean) * rstd * scale[c + j] + bias[c + j]);
    }
    *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* y,
           long long rows, int C, float eps, cudaStream_t stream) {
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  layer_norm_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x and y (rows, C) contiguous in one dtype (0 = bf16, 1 = f32), C % 8 == 0,
// 16-byte aligned; scale and bias (C,) f32. Returns a cudaError_t
// (0 = launched), -1 for an unknown dtype.
extern "C" int cd360_layer_norm(const void* x, const float* scale,
                                const float* bias, void* y, long long rows,
                                int C, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(x, scale, bias, y, rows, C, eps, s);
  if (dtype == 1) return launch<float>(x, scale, bias, y, rows, C, eps, s);
  return -1;
}
