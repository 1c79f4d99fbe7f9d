// LayerNorm over the last axis for Hopper (sm_90a).
//
// Replaces custom_diffusion360_tpu/ops/norms.py::layer_norm_fused (kernel
// _ln_kernel, pallas_call :64): y = (x - mean) * rsqrt(var + eps) * scale +
// bias over rows of C channels, f32 statistics, scale and bias in bf16 or
// f32 (read as they are: the wrapper makes no f32 copies), output in the
// input dtype (bf16 or f32).
//
// Bound on the H100: memory. One read of x and one write of y; the
// statistics are a few flops per byte.
//
// Design: one warp per row, 8 rows per 256-thread block. Lane l reads the
// row's 16-byte vectors l, l + 32, ... (8 bf16 or 4 f32 each; the wrapper
// checks C % 8 == 0 and 16-byte aligned bases, so every vector is aligned).
// Rows of C <= MAX_C_REGS stay in registers (NV vectors a lane, as few as C
// needs: at most 8 of bf16 or 16 of f32, 64 floats, so narrow rows leave
// registers for more rows in flight): x is read from device memory once, the mean and
// then the centred sum of squares come from the registers (two-pass, no
// E[x^2] - E[x]^2 cancellation), then normalise, affine and write. Wider rows
// (NV = 0) make the same three passes over the row, re-reading it from L1.
// Scale and bias are read in their own dtype as vectors aligned with the x
// vectors (8 bf16 x: 16 bytes of bf16 or 32 of f32 parameters; 4 f32 x: 8
// or 16 bytes). The TPU kernel's C % 128 rule is a lane rule and does not
// apply here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int MAX_C_REGS = 2048;  // widest row held in registers

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

// V consecutive elements of T (bf16 or f32) at p, aligned to V * sizeof(T)
// bytes, as floats: one or two 16-byte loads, or one 8-byte load
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[V]) {
  constexpr int BYTES = V * (int)sizeof(T);
  if constexpr (BYTES >= 16) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
  } else {
    static_assert(BYTES == 8, "8-byte parameter vectors");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
  }
}

// y[c .. c + V) from the V floats of x at c
template <typename T, typename P, int V>
__device__ __forceinline__ void write_vec(T* __restrict__ yr, const P* __restrict__ scale,
                                          const P* __restrict__ bias, int c, const float (&xv)[V],
                                          float mean, float rstd) {
  float sc[V], bi[V];
  load_vec<P, V>(scale + c, sc);
  load_vec<P, V>(bias + c, bi);
  __align__(16) T out[V];
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = from_f<T>((xv[j] - mean) * rstd * sc[j] + bi[j]);
  *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(out);
}

// NV > 0: the row in registers, NV vectors a lane (C <= 32 * V * NV);
// NV = 0: any C, three passes over the row
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                  const P* __restrict__ bias, T* __restrict__ y, long long rows, int C,
                  float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  const int nvec = C / V;

  if constexpr (NV > 0) {
    float xv[NV][V];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nvec) load_vec<T, V>(xr + (i * 32 + lane) * V, xv[i]);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) s += xv[i][j];
      }
    }
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = xv[i][j] - mean;
          ss += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nvec)
        write_vec<T, P, V>(yr, scale, bias, (i * 32 + lane) * V, xv[i], mean, rstd);
    }
  } else {
    float s = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float xv[V];
      load_vec<T, V>(xr + c, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) s += xv[j];
    }
    const float mean = warp_sum(s) / (float)C;
    float ss = 0.f;
    for (int c = lane * V; c < C; c += 32 * V) {
      float xv[V];
      load_vec<T, V>(xr + c, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = xv[j] - mean;
        ss += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / (float)C + eps);
    for (int c = lane * V; c < C; c += 32 * V) {
      float xv[V];
      load_vec<T, V>(xr + c, xv);
      write_vec<T, P, V>(yr, scale, bias, c, xv, mean, rstd);
    }
  }
}

template <typename T, typename P, int NV>
void launch_nv(const void* x, const void* scale, const void* bias, void* y, long long rows, int C,
               float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  layer_norm_kernel<T, P, NV><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(scale), static_cast<const P*>(bias),
      static_cast<T*>(y), rows, C, eps);
}

// the register path sized to the row: as few vectors a lane as C needs (up
// to 8; f32 rows of 9-16 take 16), so narrow rows leave registers for more
// rows in flight per SM; the loop past MAX_C_REGS
template <typename T, typename P>
int launch(const void* x, const void* scale, const void* bias, void* y, long long rows, int C,
           float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int per_lane = (C / V + 31) / 32;
#define CD360_LN_NV(nv) launch_nv<T, P, nv>(x, scale, bias, y, rows, C, eps, stream)
  if (C > MAX_C_REGS) CD360_LN_NV(0);
  else if (per_lane <= 1) CD360_LN_NV(1);
  else if (per_lane == 2) CD360_LN_NV(2);
  else if (per_lane == 3) CD360_LN_NV(3);
  else if (per_lane == 4) CD360_LN_NV(4);
  else if (per_lane == 5) CD360_LN_NV(5);
  else if (per_lane == 6) CD360_LN_NV(6);
  else if (per_lane == 7) CD360_LN_NV(7);
  else if (per_lane == 8) CD360_LN_NV(8);
  else CD360_LN_NV(MAX_C_REGS / (32 * V));  // f32 only: 9-16 vectors a lane
#undef CD360_LN_NV
  return (int)cudaGetLastError();
}

}  // namespace

// x and y (rows, C) contiguous in one dtype, scale and bias (C,) contiguous
// in one dtype (0 = bf16, 1 = f32 for both codes); C % 8 == 0 and every base
// 16-byte aligned. Returns a cudaError_t (0 = launched), -1 for an unknown
// dtype.
extern "C" int cd360_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                                long long rows, int C, float eps, int dtype, int param_dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && param_dtype == 0) return launch<bf16, bf16>(x, scale, bias, y, rows, C, eps, s);
  if (dtype == 0 && param_dtype == 1) return launch<bf16, float>(x, scale, bias, y, rows, C, eps, s);
  if (dtype == 1 && param_dtype == 0) return launch<float, bf16>(x, scale, bias, y, rows, C, eps, s);
  if (dtype == 1 && param_dtype == 1)
    return launch<float, float>(x, scale, bias, y, rows, C, eps, s);
  return -1;
}
