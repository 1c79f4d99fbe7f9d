// GroupNorm (+ optional SiLU) on channels-last activations for Hopper
// (sm_90a), in two launches.
//
// Replaces custom_diffusion360_tpu/ops/norms.py::group_norm_fused (kernel
// _gn_kernel, pallas_call :209): x (N, HW, C), G groups of cg = C / G
// channels, statistics per (sample, group) over HW x cg elements in f32,
// then y = (x - mean) * rstd * scale + bias, optionally y * sigmoid(y), in
// the input dtype (bf16 or f32). Scale and bias are read in their own dtype
// (bf16 or f32, both the same): the wrapper makes no copies.
//
// Bound on the H100: memory. The function reads x once and writes y once;
// this kernel reads x twice (statistics, apply), so at shapes past the 50 MB
// L2 it can reach at best 2/3 of the byte bound (below that the second read
// mostly hits L2).
//
// Design. The TPU kernel keeps one sample's whole (HW, C) slab in VMEM and
// takes E[x^2] - E[x]^2 in one pass. Neither carries over: a block has far
// less shared memory than the VAE's 512^2 x 128 slab, and over its 10^6
// elements per group the one-pass form loses digits in f32.
//   1. Statistics, one read of x: one block per (row chunk, sample); the
//      wrapper sizes chunks so the batch fills about one wave (132 blocks)
//      and every thread has at least four rows (ops/norms.py::gn_chunks).
//      Threads own fixed 16-byte channel vectors and walk the chunk's rows,
//      four loads in flight. Sums are shifted by a per-group value, the mean
//      of the group's channels in the chunk's first row (close to the group
//      mean, so sum (x - K)^2 - (sum (x - K))^2 / n cancels no digits that
//      matter). They are folded without atomics (shared-memory float atomics
//      on a few addresses serialise: some 240 threads a group), per channel
//      through shared memory and per group by a warp with shuffles, and
//      written per (sample, chunk, group) as (mean, M2 = sum of squared
//      deviations); the count follows from the chunk's rows.
//   2. Apply, one read and one write: each block first loads its sample's
//      chunk partials into shared memory (all at once, so one memory
//      latency and not a chain of them), merges them with Chan's parallel
//      formula (M2 = M2a + M2b + d^2 na nb / n: sums of non-negative terms,
//      no cancellation), 256 / G threads per group and then a short serial
//      merge, folds mean, rstd, scale and bias into a per-channel a, b in
//      shared memory, and then streams y = x a + b (SiLU fused) over its
//      share of the sample's 16-byte vectors, four in flight; about four
//      blocks per SM over the batch, so each block's prologue is paid for
//      many rows.
// No host synchronisation, no cooperative launch, no atomics to device
// memory: both launches capture in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int STATS_THREADS = 1024;  // at most; rows in parallel x vectors a row
constexpr int APPLY_THREADS = 256;
constexpr int UNROLL = 4;            // 16-byte loads in flight a thread
constexpr int SMS = 132;             // H100 SXM streaming multiprocessors
constexpr int MAX_PARTIALS = SMS * 32;  // chunks x groups a sample (ops/norms.py::gn_chunks)

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// V values of T from 16 bytes, as floats
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a): count, mean, M2
__device__ __forceinline__ void chan(float& na, float& ma, float& m2a, float nb, float mb,
                                     float m2b) {
  const float n = na + nb;
  const float d = mb - ma;
  const float w = nb / n;
  ma = fmaf(d, w, ma);
  m2a += m2b + d * d * na * w;
  na = n;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block (chunk, sample): rows [chunk * R, min(HW, (chunk + 1) * R)). Thread
// t owns channel vector v = t % VC and walks rows t / VC, + rpp, ... (rpp =
// blockDim.x / VC rows in parallel). partial: (N, gridDim.x, G) of (mean,
// M2). No atomics: per-element sums go through shared memory (red, rpp x C)
// and warps fold channels into groups with shuffles.
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial, int HW, int C, int G,
                int R) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float s_stats[];
  float* shift = s_stats;                              // [G], then red at an even offset
  float2* red = reinterpret_cast<float2*>(s_stats + G + (G & 1));  // [rpp][C]
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int VC = C / V, cg = C / G;
  const int rpp = blockDim.x / VC;
  const int r0 = chunk * R, r1 = min(HW, r0 + R);
  const T* xs = x + (long long)n * HW * C;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, warps = blockDim.x / 32;

  // the shift: each group's mean over the chunk's first row (a warp a group)
  for (int g = warp; g < G; g += warps) {
    float s = 0.f;
    for (int c = lane; c < cg; c += 32) s += to_f(xs[(long long)r0 * C + g * cg + c]);
    s = warp_sum(s);
    if (lane == 0) shift[g] = s / (float)cg;
  }
  __syncthreads();

  if (t < rpp * VC) {
    const int c0 = (t % VC) * V;
    float k[V], a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      k[j] = shift[(c0 + j) / cg];
      a1[j] = a2[j] = 0.f;
    }
    const T* p = xs + c0;
    int r = r0 + t / VC;
    for (; r + (UNROLL - 1) * rpp < r1; r += UNROLL * rpp) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(p + (long long)(r + u * rpp) * C));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float e[V];
        unpack<T, V>(raw[u], e);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = e[j] - k[j];
          a1[j] += d;
          a2[j] = fmaf(d, d, a2[j]);
        }
      }
    }
    for (; r < r1; r += rpp) {
      float e[V];
      unpack<T, V>(__ldg(reinterpret_cast<const uint4*>(p + (long long)r * C)), e);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = e[j] - k[j];
        a1[j] += d;
        a2[j] = fmaf(d, d, a2[j]);
      }
    }
    float2* row = red + (t / VC) * C + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) row[j] = make_float2(a1[j], a2[j]);
  }
  __syncthreads();
  // per channel, over the row offsets, into red's first row (each column
  // is read and written by one thread only)
  for (int c = t; c < C; c += blockDim.x) {
    float2 s = red[c];
    for (int q = 1; q < rpp; ++q) {
      const float2 v = red[q * C + c];
      s.x += v.x;
      s.y += v.y;
    }
    red[c] = s;
  }
  __syncthreads();
  // per group, a warp a group
  const float cnt = (float)(r1 - r0) * (float)cg;
  for (int g = warp; g < G; g += warps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < cg; c += 32) {
      const float2 v = red[g * cg + c];
      s1 += v.x;
      s2 += v.y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float m1 = s1 / cnt;  // mean - shift
      partial[((long long)n * gridDim.x + chunk) * G + g] =
          make_float2(shift[g] + m1, fmaxf(s2 - s1 * m1, 0.f));
    }
  }
}

// Block (i, sample) of gridDim.x per sample; partial from gn_stats_kernel
// with nchunks chunks of R rows.
template <typename T, typename P>
__global__ void __launch_bounds__(APPLY_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ partial,
                const P* __restrict__ scale, const P* __restrict__ bias, T* __restrict__ y,
                int HW, int C, int G, int nchunks, int R, float eps, int act) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float s_apply[];
  float* ca = s_apply;          // [C] rstd * scale
  float* cb = ca + C;           // [C] bias - mean * rstd * scale
  float* s_mean = cb + C;       // [G]
  float* s_rstd = s_mean + G;   // [G]
  float* s_part = s_rstd + G;   // [nsub][G][3]: count, mean, M2
  const int part_floats = 3 * (APPLY_THREADS / G) * G;
  // [nchunks][G], after s_part, at an even float offset (8-byte aligned)
  float2* s_chunks = reinterpret_cast<float2*>(s_part + part_floats + (part_floats & 1));
  const int n = blockIdx.y;
  const int VC = C / V, cg = C / G;
  const int t = threadIdx.x;

  // 1. merge the sample's chunk partials per group: all of them into
  // shared memory first, then nsub threads a group, each over every
  // nsub-th chunk, then one thread a group over the nsub
  const float2* ps = partial + (long long)n * nchunks * G;
  for (int i = t; i < nchunks * G; i += blockDim.x) s_chunks[i] = ps[i];
  __syncthreads();
  const int nsub = blockDim.x / G;
  const int g = t % G, sub = t / G;
  if (sub < nsub) {
    float cn = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = sub; k < nchunks; k += nsub) {
      const float2 p = s_chunks[k * G + g];
      const float nb = (float)(min(HW, (k + 1) * R) - k * R) * (float)cg;
      chan(cn, mean, m2, nb, p.x, p.y);
    }
    float* out = s_part + 3 * (sub * G + g);
    out[0] = cn;
    out[1] = mean;
    out[2] = m2;
  }
  __syncthreads();
  if (t < G) {
    float cn = 0.f, mean = 0.f, m2 = 0.f;
    for (int s = 0; s < nsub; ++s) {
      const float* in = s_part + 3 * (s * G + t);
      if (in[0] > 0.f) chan(cn, mean, m2, in[0], in[1], in[2]);
    }
    s_mean[t] = mean;
    s_rstd[t] = rsqrtf(fmaxf(m2 / cn, 0.f) + eps);
  }
  __syncthreads();
  for (int c = t; c < C; c += blockDim.x) {
    const int gc = c / cg;
    const float a = s_rstd[gc] * to_f(scale[c]);
    ca[c] = a;
    cb[c] = to_f(bias[c]) - s_mean[gc] * a;
  }
  __syncthreads();

  // 2. normalise this block's share of the sample's vectors
  const long long per_sample = (long long)HW * VC;
  const T* xs = x + (long long)n * HW * C;
  T* ys = y + (long long)n * HW * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + t; i < per_sample; i += UNROLL * stride) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long iu = i + u * stride;
      if (iu < per_sample) raw[u] = __ldg(reinterpret_cast<const uint4*>(xs) + iu);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long iu = i + u * stride;
      if (iu >= per_sample) break;
      const int c0 = (int)(iu % VC) * V;
      float e[V];
      unpack<T, V>(raw[u], e);
      __align__(16) T out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = fmaf(e[j], ca[c0 + j], cb[c0 + j]);
        if (act) v = v / (1.f + __expf(-v));
        out[j] = from_f<T>(v);
      }
      reinterpret_cast<uint4*>(ys)[iu] = *reinterpret_cast<const uint4*>(out);
    }
  }
}

template <typename T, typename P>
int launch(const void* xv, const void* scale, const void* bias, void* yv, float* partial, int N,
           int HW, int C, int G, int nchunks, float eps, int act, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int VC = C / V;
  if (VC > STATS_THREADS || G > APPLY_THREADS || C % G || nchunks < 1 ||
      nchunks * G > MAX_PARTIALS)
    return -1;
  const int rpp = VC >= STATS_THREADS ? 1 : STATS_THREADS / VC;
  const int threads = ((rpp * VC + 31) / 32) * 32;
  const int R = (HW + nchunks - 1) / nchunks;
  const int chunks = (HW + R - 1) / R;  // <= nchunks, none empty
  float2* part = reinterpret_cast<float2*>(partial);

  // shift[G] and the per-element sums, rpp x C float2 (at most 64 KB + 1 KB)
  const size_t stats_smem = (size_t)(G + 1) * sizeof(float) + (size_t)rpp * C * sizeof(float2);
  int rc = 0;
  static bool stats_attr = false;
  if (!stats_attr) {
    rc = (int)cudaFuncSetAttribute(gn_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)((APPLY_THREADS + 1) * sizeof(float) +
                                         STATS_THREADS * V * sizeof(float2)));
    if (rc) return rc;
    stats_attr = true;
  }
  gn_stats_kernel<T><<<dim3(chunks, N), threads, stats_smem, stream>>>(x, part, HW, C, G, R);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  const size_t smem = (size_t)(2 * C + 2 * G + 3 * (APPLY_THREADS / G) * G + 1 +
                               2 * chunks * G) * sizeof(float);
  if (smem > 48 * 1024) {
    // wide rows: allow the per-channel a, b past 48 KB (set once per size
    // reached; not a stream operation)
    static size_t attr_bytes = 48 * 1024;
    if (smem > attr_bytes) {
      rc = (int)cudaFuncSetAttribute(gn_apply_kernel<T, P>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc) return rc;
      attr_bytes = smem;
    }
  }
  const long long per_sample = (long long)HW * VC;
  long long bx = (per_sample + APPLY_THREADS * UNROLL - 1) / (APPLY_THREADS * UNROLL);
  const long long cap = (SMS * 4LL + N - 1) / N;  // about four 256-thread blocks an SM
  if (bx > cap) bx = cap;
  gn_apply_kernel<T, P><<<dim3((unsigned)bx, N), APPLY_THREADS, smem, stream>>>(
      x, part, static_cast<const P*>(scale), static_cast<const P*>(bias), y, HW, C, G, chunks, R,
      eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

// x and y (N, HW, C) contiguous in one dtype (0 = bf16, 1 = f32), C % 8 ==
// 0, C / (16 / element size) <= 1024, G <= 256 divides C, 16-byte aligned;
// scale and bias (C,) contiguous in one dtype (param_dtype: 0 = bf16, 1 =
// f32); partial: scratch of N * nchunks * G * 2 floats, nchunks * G <=
// 132 * 32. act 1 fuses SiLU.
// Two launches on ``stream``. Returns the first cudaError_t (0 = both
// launched), -1 for an unknown dtype or a shape it does not take.
extern "C" int cd360_group_norm(const void* x, const void* scale, const void* bias, void* y,
                                float* partial, int N, int HW, int C, int G, int nchunks,
                                float eps, int act, int dtype, int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CD360_GN(T, P) \
  launch<T, P>(x, scale, bias, y, partial, N, HW, C, G, nchunks, eps, act, s)
  if (dtype == 0 && param_dtype == 0) return CD360_GN(bf16, bf16);
  if (dtype == 0 && param_dtype == 1) return CD360_GN(bf16, float);
  if (dtype == 1 && param_dtype == 0) return CD360_GN(float, bf16);
  if (dtype == 1 && param_dtype == 1) return CD360_GN(float, float);
#undef CD360_GN
  return -1;
}
