// Backward of the bilinear sampling of channels-last feature maps, for
// Hopper (sm_90a): dFeats = W^T g.
//
// Replaces the VJP of custom_diffusion360_tpu/ops/onehot_sample.py::
// bilinear_sample_pallas (_pallas_vjp_bwd :224-231, the one-hot W^T g
// contraction beside pallas_call :263). g (M, P, C) is the cotangent of the
// sampled (M, P, C) output at grid (M, P, 2) in [-1, 1] (x indexes W, y
// indexes H), align_corners=True; each point adds its 4 corner weights
// times g[m, p, :] to the map rows it read. Corners outside the map
// contributed zero in the forward and get nothing here. The grid's
// cotangent is zero (the caller stops its gradient) and is not computed.
//
// Bound on the H100: memory. The function reads g once and writes the
// (M, H, W, C) gradient once; the scatter's read-modify-writes mostly hit
// L2 (one map is 2.6-5.3 MB at the FeatureNeRF shapes).
//
// Design: the forward's 4-corner gather turned around. One block per
// (map, tile of PTS points) computes the corner indices and weights once
// per point into shared memory; each warp walks a point's channel row of g
// (16-byte vector loads when aligned) and adds w * g into an f32 (M, H*W, C)
// accumulator with atomicAdd, skipping zero weights. The wrapper zeroes the
// accumulator first and casts it to the map dtype after. The atomics make
// the summation order, and so the last bits of the result, vary from run to
// run: hold the result to a tolerance, not to bitwise equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int PTS = 64;       // points per block
constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
bilinear_bwd_kernel(const T* __restrict__ g, const float* __restrict__ grid,
                    float* __restrict__ acc, int H, int W, int C, int P, int vec) {
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

  float* am = acc + (long long)m * H * W * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < PTS; i += THREADS / 32) {
    const int p = p0 + i;
    if (p >= P) break;
    const T* grow = g + ((long long)m * P + p) * C;
    float w[4];
    float* rows[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      w[c] = s_w[i][c];
      rows[c] = am + (long long)s_idx[i][c] * C;
    }
    if (vec) {
      constexpr int V = 16 / sizeof(T);
      for (int c = lane * V; c < C; c += 32 * V) {
        const uint4 raw = *reinterpret_cast<const uint4*>(grow + c);
        const T* gv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (w[k] == 0.f) continue;
#pragma unroll
          for (int j = 0; j < V; ++j) atomicAdd(rows[k] + c + j, w[k] * to_f(gv[j]));
        }
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        const float gc = to_f(grow[c]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (w[k] != 0.f) atomicAdd(rows[k] + c, w[k] * gc);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* g, const float* grid, float* acc, int M, int H, int W, int C,
           int P, int vec, cudaStream_t stream) {
  dim3 blocks((P + PTS - 1) / PTS, M);
  bilinear_bwd_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(g), grid, acc, H, W, C, P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// g (M, P, C) contiguous in dtype (0 = bf16, 1 = f32); grid (M, P, 2) and
// acc (M, H, W, C) contiguous f32, acc zeroed by the caller. vec != 0
// selects 16-byte loads of g (the caller checks C * sizeof(T) % 16 == 0
// and a 16-byte aligned base). Returns a cudaError_t (0 = launched), -1 for
// an unknown dtype.
extern "C" int cd360_bilinear_sample_bwd(const void* g, const float* grid, float* acc,
                                         int M, int H, int W, int C, int P, int dtype,
                                         int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(g, grid, acc, M, H, W, C, P, vec, s);
  if (dtype == 1) return launch<float>(g, grid, acc, M, H, W, C, P, vec, s);
  return -1;
}
