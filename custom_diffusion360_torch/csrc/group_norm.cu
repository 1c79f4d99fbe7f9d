// GroupNorm (+ optional SiLU) on channels-last activations for Hopper
// (sm_90a).
//
// Replaces custom_diffusion360_tpu/ops/norms.py::group_norm_fused (kernel
// _gn_kernel, pallas_call :209): x (N, HW, C), G groups of cg = C / G
// channels, statistics per (sample, group) over HW x cg elements in f32,
// then y = (x - mean) * rstd * scale + bias, optionally y * sigmoid(y), in
// the input dtype (bf16 or f32).
//
// Bound on the H100: memory. The function reads x once and writes y once;
// this kernel reads x three times (mean, centred variance, apply), so it
// can reach at best 2/3 of the byte bound.
//
// Design: the TPU kernel keeps one sample's whole (HW, C) slab in VMEM and
// takes E[x^2] - E[x]^2 in one pass. Neither carries over: a block has far
// less shared memory than the VAE encoder's 512^2 x 128 slab, and over its
// 1,048,576 elements per group the one-pass form loses digits in f32. So
// the reduction is split: each block sums a chunk of rows of one sample
// (threads own fixed 16-byte channel vectors, accumulate in registers,
// then fold per group in shared memory) into a per-(sample, chunk, group)
// partial; a combine kernel adds the chunk partials in double. The first
// round gives the mean, the second the sum of squared deviations from it
// (two-pass, so no cancellation), and the variance is clamped at 0 as in
// models/nn.group_norm. A grid-stride elementwise pass then normalizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int APPLY_THREADS = 256;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// One block per (chunk, sample): rows [chunk * R, min(HW, (chunk + 1) * R)).
// Thread t owns channel vector v = t % VC and walks rows t / VC, + rpp, ...
// (rpp = blockDim.x / VC rows in parallel). centred = 0 sums x; 1 sums
// (x - mean[n, g])^2. partial: (N, nchunks, G) f32.
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x,
                                  const float* __restrict__ mean, float* __restrict__ partial,
                                  int HW, int C, int G, int R, int centred) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float s_grp[];  // G floats
  const int n = blockIdx.y;
  const int chunk = blockIdx.x;
  const int nchunks = gridDim.x;
  const int VC = C / V;
  const int cg = C / G;
  const int rpp = blockDim.x / VC;
  for (int g = threadIdx.x; g < G; g += blockDim.x) s_grp[g] = 0.f;
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rpp * VC) {
    const int v = t % VC;
    const int c0 = v * V;
    float shift[V];
#pragma unroll
    for (int j = 0; j < V; ++j) shift[j] = centred ? mean[n * G + (c0 + j) / cg] : 0.f;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    const int r0 = chunk * R;
    const int r1 = min(HW, r0 + R);
    const T* xs = x + (long long)n * HW * C + c0;
    for (int r = r0 + t / VC; r < r1; r += rpp) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + (long long)r * C);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = to_f(e[j]) - shift[j];
        acc[j] += centred ? d * d : d;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) atomicAdd(&s_grp[(c0 + j) / cg], acc[j]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    partial[((long long)n * nchunks + chunk) * G + g] = s_grp[g];
  }
}

// One thread per (sample, group): add the chunk partials in double.
// mode 0: out = mean; mode 1: out = rsqrt(max(var, 0) + eps).
__global__ void gn_combine_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int NG, int G, int nchunks, double count, float eps,
                                  int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NG) return;
  const int n = i / G;
  const int g = i % G;
  double s = 0.0;
  for (int k = 0; k < nchunks; ++k) s += (double)partial[((long long)n * nchunks + k) * G + g];
  const double m = s / count;
  out[i] = mode == 0 ? (float)m : rsqrtf(fmaxf((float)m, 0.f) + eps);
}

template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y, int HW, int C,
                int G, int act) {
  constexpr int V = 16 / sizeof(T);
  const int VC = C / V;
  const int cg = C / G;
  const long long per_sample = (long long)HW * VC;
  const int n = blockIdx.y;
  const long long base = (long long)n * per_sample;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < per_sample;
       i += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % VC) * V;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (base + i) * V);
    const T* e = reinterpret_cast<const T*>(&raw);
    __align__(16) T out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j;
      const int g = n * G + c / cg;
      float v = (to_f(e[j]) - mean[g]) * rstd[g] * scale[c] + bias[c];
      if (act) v = v / (1.f + expf(-v));
      out[j] = from_f<T>(v);
    }
    *reinterpret_cast<uint4*>(y + (base + i) * V) = *reinterpret_cast<const uint4*>(out);
  }
}

template <typename T>
int launch(const void* xv, const float* scale, const float* bias, void* yv,
           float* partial, float* mean, float* rstd, int N, int HW, int C, int G,
           int nchunks, float eps, int act, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int VC = C / V;
  int threads = VC > 256 ? ((VC + 31) / 32) * 32 : 256;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const int R = (HW + nchunks - 1) / nchunks;
  const dim3 pgrid(nchunks, N);
  const size_t smem = (size_t)G * sizeof(float);
  const double count = (double)HW * (double)(C / G);
  const int NG = N * G;
  const int cblocks = (NG + 127) / 128;

  gn_partial_kernel<T><<<pgrid, threads, smem, stream>>>(x, mean, partial, HW, C, G, R, 0);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  gn_combine_kernel<<<cblocks, 128, 0, stream>>>(partial, mean, NG, G, nchunks, count, eps, 0);
  if ((rc = (int)cudaGetLastError())) return rc;
  gn_partial_kernel<T><<<pgrid, threads, smem, stream>>>(x, mean, partial, HW, C, G, R, 1);
  if ((rc = (int)cudaGetLastError())) return rc;
  gn_combine_kernel<<<cblocks, 128, 0, stream>>>(partial, rstd, NG, G, nchunks, count, eps, 1);
  if ((rc = (int)cudaGetLastError())) return rc;

  const long long per_sample = (long long)HW * VC;
  long long bx = (per_sample + APPLY_THREADS - 1) / APPLY_THREADS;
  const long long cap = (132LL * 8 + N - 1) / N;
  if (bx > cap) bx = cap;
  gn_apply_kernel<T><<<dim3((unsigned)bx, N), APPLY_THREADS, 0, stream>>>(
      x, mean, rstd, scale, bias, y, HW, C, G, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x and y (N, HW, C) contiguous in one dtype (0 = bf16, 1 = f32), C % 8 ==
// 0, G divides C, 16-byte aligned; scale and bias (C,) f32; scratch:
// partial (N, nchunks, G), mean and rstd (N, G), all f32. act 1 fuses SiLU.
// Five launches on ``stream``. Returns the first cudaError_t (0 = all
// launched), -1 for an unknown dtype.
extern "C" int cd360_group_norm(const void* x, const float* scale, const float* bias,
                                void* y, float* partial, float* mean, float* rstd,
                                int N, int HW, int C, int G, int nchunks, float eps,
                                int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<bf16>(x, scale, bias, y, partial, mean, rstd, N, HW, C, G, nchunks, eps,
                        act, s);
  if (dtype == 1)
    return launch<float>(x, scale, bias, y, partial, mean, rstd, N, HW, C, G, nchunks, eps,
                         act, s);
  return -1;
}
