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
// Bound on the H100: memory. The function reads g once (127 MB a launch at
// both FeatureNeRF training shapes) and writes the (M, H, W, C) gradient
// once. Next comes the scatter itself: up to 4 * P * C f32
// read-modify-writes, about 1 M warp-wide shared-memory ones per SM at
// those shapes when no two points in a row share a pixel.
//
// Design: ownership instead of atomics, so the result is the same bit for
// bit from run to run.
//   - A block owns (map m, a slice of CS = 32 channels, a band of at most
//     MAX_PIX pixels, a run of points) and keeps its part of the output as
//     an f32 accumulator in shared memory, [pixel][channel] (lane = channel,
//     no bank conflicts). Maps of more than MAX_PIX pixels take several
//     bands; each band walks all points of its slice (g is read once per
//     band; bands of one slice are adjacent in the grid, so the second read
//     mostly hits L2).
//   - Warp specialisation: one producer warp, NW consumer warps, a ring of
//     STAGES tiles of TP points. The producer's lanes load a tile's grid
//     points (all in flight at once) and compute each point's four corners
//     (pixel in the band and owner warp, packed; -1 off the map or the band)
//     and weights; g's (TP x CS) tile arrives by TMA (a 2-D map over (C, M *
//     P), zero fill past C and past M * P) when g's rows are 16-byte
//     aligned, else by the warp's own loads (odd C). A full mbarrier per
//     stage takes the producer's arrive and the TMA bytes, an empty one an
//     arrive per consumer warp.
//   - Consumer warp w owns the band's pixels (x, y) with (x + 6y) mod NW = w:
//     a point's four corners belong to four warps, a 3 x 3 cluster of
//     pixels to nine. The projected ray samples of the training path crowd
//     a few pixels of each map, and consecutive points mostly share one;
//     warps that owned runs of rows left such a crowd to three or four
//     warps, each adding two corners a point through chained shared-memory
//     read-modify-writes.
//     For 32 points of a tile at a time each lane picks its point's corner
//     that the warp owns, if any; the warp ballots them and walks the set
//     bits in point order, BATCH at a time (their shuffles of pixel and
//     weight and their shared loads of g[p, c] in flight together), with
//     one FMA each into a running sum kept in a register while the points
//     stay on one pixel, parked in the accumulator (a plain store, then a
//     plain load of the next pixel) when they move. No two threads touch
//     one accumulator address, and each address takes its sums in point
//     order: no atomics, global or shared.
//   - The flush writes the band once, coalesced, in the output dtype. When
//     the grid would leave SMs idle the points are split across blocks
//     (ops/onehot_sample.py::bwd_plan picks the count): each split writes
//     an f32 workspace and bilinear_bwd_merge_kernel sums the splits in
//     order 0, 1, ... and writes the output dtype.
// The wrapper allocates the output (and the workspace) with torch.empty:
// no zero fill and no cast launch.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CS = 32;              // channels per block: lane = channel
constexpr int TP = 128;             // points per tile
constexpr int STAGES = 4;           // tiles in flight
constexpr int NW = 16;              // consumer warps
constexpr int THREADS = 32 * (NW + 1);
constexpr int MAX_PIX = 1024;       // pixels per band: a 128 KB f32 accumulator
constexpr int BATCH = 8;            // owned points a consumer warp fetches at once

// shared-memory layout (bytes from the 128-byte aligned base): barriers, the
// ring of g tiles, the ring of corners (int4 packed pixels, float4 weights),
// the accumulator
template <typename T>
struct Layout {
  static constexpr int OFF_G = 128;
  static constexpr int G_BYTES = TP * CS * (int)sizeof(T);
  static constexpr int OFF_IDX = OFF_G + STAGES * G_BYTES;
  static constexpr int OFF_W = OFF_IDX + STAGES * TP * 16;
  static constexpr int OFF_ACC = OFF_W + STAGES * TP * 16;
  static int bytes(int band_pix) { return OFF_ACC + band_pix * CS * 4; }
};

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// One point's corners, each packed as (pixel of the band << 5) | owner warp,
// or -1 when outside the map or the band [q0, q0 + pix), and their weights,
// as the forward kernel and the JAX one-hot matrix compute them. The owner
// of (x, y) is (x + 6y) mod NW, so the four corners of a point have owners
// o, o + 1, o + 6, o + 7: four different warps, on four different SM
// sub-partitions (warp mod 4).
__device__ __forceinline__ void corners(float gx, float gy, int H, int W, int q0, int pix,
                                        int4& idx, float4& wt) {
  const float ix = (gx + 1.0f) * 0.5f * (float)(W - 1);
  const float iy = (gy + 1.0f) * 0.5f * (float)(H - 1);
  const float fx = floorf(ix), fy = floorf(iy);
  const float tx = ix - fx, ty = iy - fy;
  // clamped to [-2, W] before the int conversion: both corners keep their
  // validity, huge coordinates cannot overflow, NaN ones land on -2 (none)
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H);
  int packed[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = x0 + (k & 1), y = y0 + (k >> 1);
    const int rel = y * W + x - q0;
    const bool mine = x >= 0 && x < W && y >= 0 && y < H && rel >= 0 && rel < pix;
    packed[k] = mine ? (rel << 5) | ((x + 6 * y) % NW) : -1;
  }
  idx = make_int4(packed[0], packed[1], packed[2], packed[3]);
  wt = make_float4((1.f - tx) * (1.f - ty), tx * (1.f - ty), (1.f - tx) * ty, tx * ty);
}

// grid (bands * slices, M, splits): blockIdx.x = band + bands * slice. With
// one split the block writes out (M, H, W, C) in TO; else its f32 partial to
// ws[split] (splits, M, H, W, C).
template <typename TG, typename TO>
__global__ void __launch_bounds__(THREADS, 2)
bilinear_bwd_kernel(const __grid_constant__ CUtensorMap tm_g, const TG* __restrict__ g,
                    const float* __restrict__ grid, TO* __restrict__ out,
                    float* __restrict__ ws, int M, int H, int W, int C, int P, int band_pix,
                    int tiles_per_split, int vec) {
  using L = Layout<TG>;
  // declared in the shared window (no generic-pointer arithmetic), so the
  // accumulator's loads and stores compile to LDS / STS
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_u32(smem);  // [STAGES] each
  const uint32_t empty = full + 8 * STAGES;
  TG* s_g = reinterpret_cast<TG*>(smem + L::OFF_G);
  int4* s_idx = reinterpret_cast<int4*>(smem + L::OFF_IDX);
  float4* s_w = reinterpret_cast<float4*>(smem + L::OFF_W);
  float* acc = reinterpret_cast<float*>(smem + L::OFF_ACC);

  const int HW = H * W;
  const int bands = (HW + band_pix - 1) / band_pix;
  const int band = blockIdx.x % bands, slice = blockIdx.x / bands;
  const int m = blockIdx.y, split = blockIdx.z;
  const int c0 = slice * CS, q0 = band * band_pix;
  const int pix = min(band_pix, HW - q0);  // this band's pixels
  const int p_begin = split * tiles_per_split * TP;
  const int p_end = min(P, p_begin + tiles_per_split * TP);
  const int n_tiles = p_end > p_begin ? (p_end - p_begin + TP - 1) / TP : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < pix * CS / 4; i += THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (warp == NW) {
    // ---- producer warp: corners and weights, and g's tile ----
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
      const int pt0 = p_begin + t * TP;
      float2 xy[TP / 32];
#pragma unroll
      for (int i = 0; i < TP / 32; ++i) {  // the tile's loads first, all in flight
        const int p = pt0 + 32 * i + lane;
        xy[i] = p < p_end ? *reinterpret_cast<const float2*>(grid + 2 * ((size_t)m * P + p))
                          : make_float2(nanf(""), nanf(""));  // no corner
      }
#pragma unroll
      for (int i = 0; i < TP / 32; ++i) {
        int4 idx;
        float4 wt;
        corners(xy[i].x, xy[i].y, H, W, q0, pix, idx, wt);
        s_idx[s * TP + 32 * i + lane] = idx;
        s_w[s * TP + 32 * i + lane] = wt;
      }
      TG* dst = s_g + s * TP * CS;
      if (!vec) {  // g's rows not 16-byte aligned: the warp's own loads
        const int c = c0 + lane;
        for (int i = 0; i < TP; ++i) {
          const int p = pt0 + i;
          dst[i * CS + lane] =
              p < p_end && c < C ? g[((size_t)m * P + p) * C + c] : from_f<TG>(0.f);
        }
      }
      __syncwarp();
      if (lane == 0) {
        if (vec) {
          mbar_expect_tx(full + 8 * s, L::G_BYTES);
          tma_load_2d(smem_u32(dst), &tm_g, full + 8 * s, c0, m * P + pt0);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warps: the pixels whose owner is this warp ----
    int cur = -1;  // the pixel whose running sum is in `val`
    float val = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      const TG* gt = s_g + s * TP * CS;
      for (int k = 0; k < TP; k += 32) {
        const int4 id = s_idx[s * TP + k + lane];
        const float4 w = s_w[s * TP + k + lane];
        int myq = -1;  // lane l: this warp's corner of point k + l, if it owns one
        float myw = 0.f;
        if ((id.x & 31) == warp) myq = id.x >> 5, myw = w.x;
        else if ((id.y & 31) == warp) myq = id.y >> 5, myw = w.y;
        else if ((id.z & 31) == warp) myq = id.z >> 5, myw = w.z;
        else if ((id.w & 31) == warp) myq = id.w >> 5, myw = w.w;
        unsigned todo = __ballot_sync(0xffffffffu, myq >= 0);
        while (todo) {  // BATCH points at a time, in point order
          int b[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            b[u] = todo ? __ffs(todo) - 1 : -1;
            todo &= todo - 1;
          }
          int q[BATCH];
          float wk[BATCH], gv[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {  // independent: their latencies overlap
            const int bu = max(b[u], 0);
            q[u] = __shfl_sync(0xffffffffu, myq, bu);
            wk[u] = __shfl_sync(0xffffffffu, myw, bu);
            gv[u] = to_f(gt[(k + bu) * CS + lane]);
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            if (b[u] < 0) break;
            if (q[u] != cur) {  // another pixel: park the running sum, fetch this one's
              if (cur >= 0) acc[cur * CS + lane] = val;
              val = acc[q[u] * CS + lane];
              cur = q[u];
            }
            val = fmaf(wk[u], gv[u], val);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (cur >= 0) acc[cur * CS + lane] = val;
  }
  __syncthreads();

  // ---- flush: the band once, 32 channels of a pixel per warp store ----
  const int c = c0 + lane;
  if (c >= C) return;
  const size_t row0 = (size_t)m * HW + q0;
  if (gridDim.z == 1) {
    for (int i = warp; i < pix; i += NW + 1)
      out[(row0 + i) * C + c] = from_f<TO>(acc[i * CS + lane]);
  } else {
    float* part = ws + (size_t)split * M * HW * C;
    for (int i = warp; i < pix; i += NW + 1) part[(row0 + i) * C + c] = acc[i * CS + lane];
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order, in TO
template <typename TO>
__global__ void __launch_bounds__(256)
bilinear_bwd_merge_kernel(const float* __restrict__ ws, TO* __restrict__ out, long long n,
                          int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * n + i];
    out[i] = from_f<TO>(v);
  }
}

template <typename TG, typename TO>
int launch(const void* g, const float* grid, void* out, float* ws, int M, int H, int W, int C,
           int P, int vec, int band_pix, int splits, cudaStream_t stream) {
  if (band_pix < 1 || band_pix > MAX_PIX || splits < 1) return -4;
  CUtensorMap tm_g = {};
  vec = vec && M > 0 && P > 0;
  if (vec) {  // g as (C, M * P), boxes of (CS channels, TP points)
    EncodeTiledFn fn = encode_fn();
    if (fn == nullptr) return -2;
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)M * P};
    const cuuint64_t st[1] = {(cuuint64_t)C * sizeof(TG)};
    const cuuint32_t box[2] = {CS, TP};
    const cuuint32_t unit[2] = {1, 1};
    const CUtensorMapDataType dt = sizeof(TG) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (fn(&tm_g, dt, 2, const_cast<void*>(g), dims, st, box, unit,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -3;
  }
  const int smem = Layout<TG>::bytes(band_pix);
  // the shared-memory attribute once per device (not a stream operation, but
  // kept out of every launch so that a CUDA-graph capture sees launches only)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(bilinear_bwd_kernel<TG, TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<TG>::bytes(MAX_PIX));
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) attr_set[dev] = true;
  }
  const int HW = H * W;
  const int bands = (HW + band_pix - 1) / band_pix;
  const int slices = (C + CS - 1) / CS;
  const int tiles_per_split = ((P + TP - 1) / TP + splits - 1) / splits;
  bilinear_bwd_kernel<TG, TO><<<dim3(bands * slices, M, splits), THREADS, smem, stream>>>(
      tm_g, static_cast<const TG*>(g), grid, static_cast<TO*>(out), ws, M, H, W, C, P,
      band_pix, tiles_per_split, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)M * HW * C;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  bilinear_bwd_merge_kernel<TO><<<blocks > 0 ? blocks : 1, 256, 0, stream>>>(
      ws, static_cast<TO*>(out), n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// g (M, P, C) contiguous in g_dtype and out (M, H, W, C) contiguous in
// out_dtype (0 = bf16, 1 = f32); grid (M, P, 2) contiguous f32 with an
// 8-byte aligned base. vec != 0
// loads g's tiles by TMA (the caller checks C * itemsize % 16 == 0 and a
// 16-byte aligned base). Bands of band_pix (<= 1024) pixels; splits > 1
// needs ws, (splits, M, H, W, C) f32, and adds the merge launch; splits == 1
// does not read ws (may be null). Points split in runs of
// ceil(ceil(P / 128) / splits) tiles of 128 (ops/onehot_sample.py::
// bilinear_sample_bwd_split_plain). Returns a cudaError_t (0 = launched), -1
// for an unknown dtype, -2 if the driver has no cuTensorMapEncodeTiled, -3 if
// it refused the map, -4 for a band or split count out of range.
extern "C" int cd360_bilinear_sample_bwd(const void* g, const float* grid, void* out, float* ws,
                                         int M, int H, int W, int C, int P, int g_dtype,
                                         int out_dtype, int vec, int band_pix, int splits,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0 && out_dtype == 0)
    return launch<bf16, bf16>(g, grid, out, ws, M, H, W, C, P, vec, band_pix, splits, s);
  if (g_dtype == 0 && out_dtype == 1)
    return launch<bf16, float>(g, grid, out, ws, M, H, W, C, P, vec, band_pix, splits, s);
  if (g_dtype == 1 && out_dtype == 0)
    return launch<float, bf16>(g, grid, out, ws, M, H, W, C, P, vec, band_pix, splits, s);
  if (g_dtype == 1 && out_dtype == 1)
    return launch<float, float>(g, grid, out, ws, M, H, W, C, P, vec, band_pix, splits, s);
  return -1;
}
