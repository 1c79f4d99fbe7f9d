// SAME-padded, stride-1 3x3 convolution for Hopper (sm_90a), NHWC bf16 in and
// out, f32 accumulation, optional bias fused into the epilogue: an implicit
// GEMM on wgmma with every operand moved by TMA.
//
// Replaces the TPU kernel of custom_diffusion360_tpu:
//   ops/conv3x3.py::conv3x3_gemm (_conv3x3_fwd_impl, pallas_call :119)
//
// out[b, y, x, n] = bias[n] + sum_{ky, kx, c} in[b, y+ky-1, x+kx-1, c] * w[n, ky, kx, c]
// with zeros outside the image. The weight comes re-laid as (N, 3, 3, C) =
// (N, 9 C), K-major (the wrapper does that once per parameter tensor).
//
// Bound on the H100: tensor-core operations, 2 * 9 * C FLOP per output value
// at 989 TFLOP/s. At the VAE decoder's shapes (C, N in {128, 256, 512},
// 128^2 .. 1024^2 pixels) that is 500-2300 FLOP per byte of input and
// output, far above the card's ~295 ridge point.
//
// Design. GEMM rows M = output pixels, columns N = output channels, depth
// K = 9 taps x C, stepped in chunks of 64 input channels (128 bytes: one
// 128-byte swizzle row).
//   - Tiles: a block tile is TH x TW = 8 x 16 = 128 pixels of one image by
//     BN = 256 output channels (128 when N is not a multiple of 256). The
//     grid is persistent: one block per SM walks the tiles (channels
//     fastest, then x, y, image), so a tile's epilogue overlaps the loads
//     of the next one.
//   - Operands through TMA (maps encoded per call from
//     ops/conv3x3.py::conv3x3_map_args): A for (tap, chunk) is one box of
//     (64 ch, TW, TH, 1) from a 4-D map over x's (C, W, H, B) at
//     (c0, x0 + kx - 1, y0 + ky - 1, b). TMA zero-fills the box where it
//     leaves the image, so SAME padding needs no padded copy and no masking;
//     the halo's reuse across the 9 taps comes from L2. The box lands as 128
//     K-major rows of 128 bytes with the 128-byte swizzle, the layout a
//     wgmma descriptor reads. B is a (64, BN) box of a 2-D map over the
//     (9 C, N) weight at (tap * C + c0, n0).
//   - Warp specialisation: warpgroup 0 is the producer (setmaxnreg 40); one
//     thread of it keeps a ring of STAGES (A, B) stages in flight, each with
//     a full (TMA transaction bytes) and an empty (one arrive per consumer
//     warpgroup) mbarrier. Warpgroups 1 and 2 are consumers (setmaxnreg
//     232), 64 pixel rows each: 4 x wgmma.m64nBNk16 per stage into an f32
//     accumulator in registers (BN / 2 floats a thread), one commit group
//     kept in flight while the next stage is awaited; a stage is released
//     when the group that read it has completed.
//   - Epilogue: + bias, bf16, staged with the 128-byte swizzle in the
//     warpgroup's own 8 KB buffer, one TMA store per 64 output channels of
//     its (64 ch, TW, TH / 2, 1) box.
//
// Resources (nvcc -Xptxas -v, printed by chip_smoke.py's [build] lines):
// 384 threads, 1 block per SM; dynamic shared memory 4 stages x (16 KB of A
// + BN x 128 bytes of B) + 16 KB of epilogue staging + 1 KB alignment slack
// (209 KB at BN = 256, 145 KB at BN = 128).

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TW = 16, TH = 8;  // pixel tile: BM = 128 GEMM rows
constexpr int BM = TW * TH;
constexpr int KC = 64;          // input channels per stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;    // 64 pixel rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * KC * 2;
constexpr int EPI_BYTES = 64 * 128;  // one warpgroup's 64 rows x 64 channels

template <int BN>
struct Layout {
  static constexpr int B_BYTES = BN * KC * 2;
  static constexpr int OFF_B = STAGES * A_BYTES;
  static constexpr int OFF_EPI = OFF_B + STAGES * B_BYTES;
  static constexpr int OFF_BAR = OFF_EPI + CONSUMERS * EPI_BYTES;
  static constexpr int SMEM = 1024 + OFF_BAR + 8 * 2 * STAGES;  // 1 KB: alignment slack
};

// acc (64 x BN) (+)= A (64 x 16) B (16 x BN), both K-major smem
template <int BN>
__device__ __forceinline__ void mma_k16(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                        int accumulate);
template <>
__device__ __forceinline__ void mma_k16<128>(float (&acc)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  wgmma_m64n128k16_ss(acc, da, db, accumulate);
}
template <>
__device__ __forceinline__ void mma_k16<256>(float (&acc)[128], uint64_t da, uint64_t db,
                                             int accumulate) {
  wgmma_m64n256k16_ss(acc, da, db, accumulate);
}

struct Tile {
  int b, y0, x0, n0;
};

// tile index -> (image, pixel origin, channel origin): channels fastest,
// then x, y, image
__device__ __forceinline__ Tile tile_of(int t, int n_tiles_n, int tiles_x, int tiles_y, int bn) {
  Tile r;
  r.n0 = (t % n_tiles_n) * bn;
  int m = t / n_tiles_n;
  r.x0 = (m % tiles_x) * TW;
  m /= tiles_x;
  r.y0 = (m % tiles_y) * TH;
  r.b = m / tiles_y;
  return r;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_o, const bf16* __restrict__ bias, int C,
               int tiles_x, int tiles_y, int n_tiles_n, int n_tiles) {
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle is a function of the address bits: 1024-byte atoms
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_full = s_base + L::OFF_BAR;     // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // [STAGES]
  const int chunks = C / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = tile_of(t, n_tiles_n, tiles_x, tiles_y, BN);
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
          for (int c = 0; c < chunks; ++c, ++it) {
            const int s = it % STAGES;
            mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar_full + 8 * s, A_BYTES + L::B_BYTES);
            tma_load_4d(s_base + s * A_BYTES, &tm_x, bar_full + 8 * s, c * KC, tl.x0 + kx - 1,
                        tl.y0 + ky - 1, tl.b);
            tma_load_2d(s_base + L::OFF_B + s * L::B_BYTES, &tm_w, bar_full + 8 * s,
                        tap * C + c * KC, tl.n0);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 pixel rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int k_iters = 9 * chunks;
    unsigned char* stage = smem + L::OFF_EPI + wg * EPI_BYTES;
    const uint32_t stage_addr = s_base + L::OFF_EPI + wg * EPI_BYTES;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile tl = tile_of(tile, n_tiles_n, tiles_x, tiles_y, BN);
      for (int k = 0; k < k_iters; ++k, ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        const uint32_t a_addr = s_base + s * A_BYTES + wg * (64 * 128);
        const uint32_t b_addr = s_base + L::OFF_B + s * L::B_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          mma_k16<BN>(acc, sw128_desc(a_addr + kk * 32), sw128_desc(b_addr + kk * 32),
                      (k | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done: release it
        fence_regs(acc);
        if (k > 0 && t == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));

      // epilogue: this thread holds rows r0 = warp * 16 + lane / 4 and r0 + 8
      // of the warpgroup's 64, channels 8j + 2 (lane % 4) + {0, 1}; one
      // swizzled 64-channel slab at a time through the staging buffer
      const int r0 = warp * 16 + lane / 4;
#pragma unroll
      for (int slab = 0; slab < BN / 64; ++slab) {
        // the previous store has read the buffer (thread 0 waited for it)
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = slab * 8 + j;
          float b0 = 0.f, b1 = 0.f;
          if (bias != nullptr) {
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(bias + tl.n0 + jj * 8 + (lane & 3) * 2);
            b0 = __low2float(bb);
            b1 = __high2float(bb);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = r0 + 8 * i;
            const int off = r * 128 + ((j ^ (r & 7)) << 4) + (lane & 3) * 4;
            *reinterpret_cast<uint32_t*>(stage + off) =
                pack_bf16x2(acc[4 * jj + 2 * i] + b0, acc[4 * jj + 2 * i + 1] + b1);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (t == 0)
          tma_store_4d(&tm_o, stage_addr, tl.n0 + slab * 64, tl.x0, tl.y0 + wg * (TH / 2), tl.b);
      }
    }
  }
}

bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rank,
            const long long* dims, const long long* strides, const long long* box) {
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) st[i] = (cuuint64_t)strides[i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, st, bx, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_o,
           const bf16* bias, int B, int H, int W, int C, int N, cudaStream_t stream) {
  // the shared-memory attribute and the SM count once per device (kept out
  // of every launch so that a CUDA-graph capture sees launches only)
  static bool attr_set[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(conv3x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const int tiles_x = W / TW, tiles_y = H / TH, n_tiles_n = N / BN;
  const int n_tiles = B * tiles_y * tiles_x * n_tiles_n;
  const int grid = n_tiles < sms[dev] ? n_tiles : sms[dev];
  conv3x3_kernel<BN><<<grid, THREADS, Layout<BN>::SMEM, stream>>>(
      tm_x, tm_w, tm_o, bias, C, tiles_x, tiles_y, n_tiles_n, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), w (N, 3, 3, C), bias (N) or null, out (B, H, W, N): all
// contiguous bf16, 16-byte aligned (bias 4-byte aligned). maps: 27 values
// from ops/conv3x3.py::conv3x3_map_args, the dims, byte strides and box of
// the three TMA maps in turn: x (C, W, H, B) 4 + 3 + 4, w (9 C, N) 2 + 1 + 2,
// out (N, W, H, B) 4 + 3 + 4. Returns a cudaError_t (0 = launched), -1 for
// maps this kernel was not built for, -2 if libcuda has no
// cuTensorMapEncodeTiled, -3 if it refused a map.
extern "C" int cd360_conv3x3(const void* x, const void* w, const void* bias, void* out,
                             const long long* maps, void* stream) {
  const long long *xd = maps, *xs = maps + 4, *xb = maps + 7;
  const long long *wd = maps + 11, *ws = maps + 13, *wb = maps + 14;
  const long long *od = maps + 16, *os = maps + 20, *ob = maps + 23;
  const long long C = xd[0], W = xd[1], H = xd[2], B = xd[3], N = od[0], BN = wb[1];
  if (xb[0] != KC || xb[1] != TW || xb[2] != TH || xb[3] != 1 || wb[0] != KC ||
      (BN != 128 && BN != 256) || ob[0] != 64 || ob[1] != TW || ob[2] != TH / 2 || ob[3] != 1 ||
      C % KC || W % TW || H % TH || N % BN || B <= 0 || wd[0] != 9 * C || wd[1] != N ||
      od[1] != W || od[2] != H || od[3] != B || ws[0] != 18 * C)
    return -1;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap tm_x, tm_w, tm_o;
  if (!encode(fn, &tm_x, x, 4, xd, xs, xb) || !encode(fn, &tm_w, w, 2, wd, ws, wb) ||
      !encode(fn, &tm_o, out, 4, od, os, ob))
    return -3;
  const bf16* b = static_cast<const bf16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BN == 256) return launch<256>(tm_x, tm_w, tm_o, b, (int)B, (int)H, (int)W, (int)C, (int)N, s);
  return launch<128>(tm_x, tm_w, tm_o, b, (int)B, (int)H, (int)W, (int)C, (int)N, s);
}
