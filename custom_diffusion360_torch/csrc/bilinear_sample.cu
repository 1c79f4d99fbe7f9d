// Bilinear sampling of channels-last feature maps for Hopper (sm_90a).
//
// Replaces custom_diffusion360_tpu/ops/onehot_sample.py::bilinear_sample_pallas
// (kernel _sample_kernel, pallas_call :263): M maps (M, H, W, C) sampled at a
// grid (M, P, 2) in [-1, 1] (x indexes W, y indexes H), align_corners=True,
// zero padding, f32 accumulation, out (M, P, C) in the map dtype.
//
// Bound on the H100: memory. Each output element needs 4 reads that mostly
// hit L2 (one map is 2.6-5.3 MB at the FeatureNeRF shapes) and one write to
// device memory; the (M, P, C) output (1-2 GB per pose block at 1024^2) is
// the traffic that counts.
//
// Design: a 4-corner gather instead of the TPU's one-hot matmul (the one-hot
// form does H*W/4 times the needed work, which only pays on a matrix unit).
// One block per (map, tile of PTS points): the corner indices and weights are
// computed once per point into shared memory, then each warp walks a point's
// channel row with 16-byte vectors (8 bf16) when the row is 16-byte aligned,
// scalar loads otherwise (odd C). Blocks of one map are adjacent in the grid,
// so a map stays resident in L2 while its points are sampled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int PTS = 64;       // points per block
constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
bilinear_kernel(const T* __restrict__ feats, const float* __restrict__ grid,
                T* __restrict__ out, int H, int W, int C, int P, int vec) {
  __shared__ int s_idx[PTS][4];
  __shared__ float s_w[PTS][4];
  const int m = blockIdx.y;
  const int p0 = blockIdx.x * PTS;

  for (int i = threadIdx.x; i < PTS; i += blockDim.x) {
    const int p = p0 + i;
    float gx = 0.f, gy = 0.f;
    if (p < P) {
      gx = grid[((long long)m * P + p) * 2];
      gy = grid[((long long)m * P + p) * 2 + 1];
    }
    const float ix = (gx + 1.0f) * 0.5f * (float)(W - 1);
    const float iy = (gy + 1.0f) * 0.5f * (float)(H - 1);
    const float x0 = floorf(ix);
    const float y0 = floorf(iy);
    const float tx = ix - x0;
    const float ty = iy - y0;
    const float xs[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
    const float ys[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
    const float ws[4] = {(1.f - tx) * (1.f - ty), tx * (1.f - ty),
                         (1.f - tx) * ty, tx * ty};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = p < P && xs[c] >= 0.f && xs[c] <= (float)(W - 1) &&
                         ys[c] >= 0.f && ys[c] <= (float)(H - 1);
      const int xi = (int)fminf(fmaxf(xs[c], 0.f), (float)(W - 1));
      const int yi = (int)fminf(fmaxf(ys[c], 0.f), (float)(H - 1));
      s_idx[i][c] = yi * W + xi;
      s_w[i][c] = valid ? ws[c] : 0.f;
    }
  }
  __syncthreads();

  const T* fm = feats + (long long)m * H * W * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < PTS; i += THREADS / 32) {
    const int p = p0 + i;
    if (p >= P) break;
    T* orow = out + ((long long)m * P + p) * C;
    const T* r0 = fm + (long long)s_idx[i][0] * C;
    const T* r1 = fm + (long long)s_idx[i][1] * C;
    const T* r2 = fm + (long long)s_idx[i][2] * C;
    const T* r3 = fm + (long long)s_idx[i][3] * C;
    const float w0 = s_w[i][0], w1 = s_w[i][1], w2 = s_w[i][2], w3 = s_w[i][3];
    if (vec) {
      constexpr int V = 16 / sizeof(T);
      for (int c = lane * V; c < C; c += 32 * V) {
        const uint4 a = *reinterpret_cast<const uint4*>(r0 + c);
        const uint4 b = *reinterpret_cast<const uint4*>(r1 + c);
        const uint4 d = *reinterpret_cast<const uint4*>(r2 + c);
        const uint4 e = *reinterpret_cast<const uint4*>(r3 + c);
        const T* ta = reinterpret_cast<const T*>(&a);
        const T* tb = reinterpret_cast<const T*>(&b);
        const T* td = reinterpret_cast<const T*>(&d);
        const T* te = reinterpret_cast<const T*>(&e);
        __align__(16) T res[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          res[j] = from_f<T>(w0 * to_f(ta[j]) + w1 * to_f(tb[j]) +
                             w2 * to_f(td[j]) + w3 * to_f(te[j]));
        }
        *reinterpret_cast<uint4*>(orow + c) = *reinterpret_cast<const uint4*>(res);
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        orow[c] = from_f<T>(w0 * to_f(r0[c]) + w1 * to_f(r1[c]) +
                            w2 * to_f(r2[c]) + w3 * to_f(r3[c]));
      }
    }
  }
}

template <typename T>
int launch(const void* feats, const float* grid, void* out, int M, int H,
           int W, int C, int P, int vec, cudaStream_t stream) {
  dim3 g((P + PTS - 1) / PTS, M);
  bilinear_kernel<T><<<g, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), grid, static_cast<T*>(out), H, W, C, P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// feats (M, H, W, C) and out (M, P, C) contiguous in one dtype (0 = bf16,
// 1 = f32); grid (M, P, 2) contiguous f32. vec != 0 selects 16-byte vector
// access (the caller checks C * sizeof(T) % 16 == 0 and 16-byte aligned
// bases). Returns a cudaError_t (0 = launched), -1 for an unknown dtype.
extern "C" int cd360_bilinear_sample(const void* feats, const float* grid,
                                     void* out, int M, int H, int W, int C,
                                     int P, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(feats, grid, out, M, H, W, C, P, vec, s);
  if (dtype == 1) return launch<float>(feats, grid, out, M, H, W, C, P, vec, s);
  return -1;
}
