// SAME-padded, stride-1 3x3 convolution for Hopper (sm_90a), NHWC bf16 in and
// out, f32 accumulation, optional bias fused into the epilogue.
//
// Replaces the TPU kernel of custom_diffusion360_tpu:
//   ops/conv3x3.py::conv3x3_gemm (_conv3x3_fwd_impl, pallas_call :119)
//
// out[b, y, x, n] = bias[n] + sum_{ky, kx, c} in[b, y+ky-1, x+kx-1, c] * w[n, ky, kx, c]
// with zeros outside the image. The weight comes re-laid as (N, 3, 3, C) (the
// wrapper does that once per parameter tensor).
//
// Bound on the H100: tensor-core operations. At the VAE decoder's shapes
// (C, N in {128, 256, 512}, 128^2 .. 1024^2 pixels) a conv does 2 * 9 * C
// FLOP per output value against 2 * (C + N) bytes per pixel of input and
// output: 500-2300 FLOP per byte, far above the card's ~295 ridge point.
//
// Design (implicit GEMM on mma.sync m16n8k16, as csrc/attention.cu): GEMM rows
// M = output pixels, columns N = output channels, depth K = 9 * C. One block
// owns an 8 x 16 pixel tile of one image (128 rows) and 128 output channels,
// 8 warps each holding a 64 x 32 f32 accumulator in registers. The depth runs
// in chunks of 16 input channels: a chunk stages the tile's input with its
// one-pixel halo (10 x 18 pixels; cp.async with a zero source size fills the
// pixels outside the image, so the conv needs no padded copy of its input)
// and the 128 x (9 x 16) weight slice in shared memory, double-buffered, and
// the 9 taps read shifted windows of the same staged halo through ldmatrix
// row addresses. Pixel and weight rows are padded by 16 bytes so the eight
// row addresses of an ldmatrix hit distinct banks.
//
// Not yet done (later work): wgmma/TMA, larger tiles, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8, TW = 16;             // output pixel tile: 128 GEMM rows per block
constexpr int BN = 128;                    // output channels per block
constexpr int BKC = 16;                    // input channels per stage
constexpr int HW_ = TW + 2;                // staged halo row width
constexpr int HALO = (TH + 2) * HW_;       // 180 staged input pixels
constexpr int LDA = BKC + 8;               // bf16 pitch of a staged pixel
constexpr int KW = 9 * BKC;                // weight columns per stage, tap-major
constexpr int LDB = KW + 8;                // bf16 pitch of a staged weight row
constexpr int THREADS = 256;               // 8 warps: 2 along M x 4 along N
constexpr int A_STAGE = HALO * LDA;        // elements
constexpr int B_STAGE = BN * LDB;
constexpr size_t SMEM = (size_t)2 * (A_STAGE + B_STAGE) * sizeof(bf16);

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// c += a (16x16 row-major bf16) * b (16x8 col-major bf16), f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// one depth chunk [c0, c0 + BKC) into a stage: the halo tile of the input
// (zero outside the image) and the block's weight slice
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int H, int W, int C,
                                           int y0, int x0, int n0, int c0) {
  for (int i = threadIdx.x; i < HALO * (BKC / 8); i += THREADS) {
    const int pix = i / (BKC / 8);
    const int part = i % (BKC / 8);
    const int gy = y0 + pix / HW_ - 1;
    const int gx = x0 + pix % HW_ - 1;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = x + ((long long)min(max(gy, 0), H - 1) * W + min(max(gx, 0), W - 1)) * C +
                      c0 + part * 8;
    cp_async16(sA + pix * LDA + part * 8, src, inside ? 16 : 0);
  }
  for (int i = threadIdx.x; i < BN * 9 * (BKC / 8); i += THREADS) {
    const int n = i / (9 * (BKC / 8));
    const int r = i % (9 * (BKC / 8));
    const int tap = r / (BKC / 8);
    const int part = r % (BKC / 8);
    const bf16* src = w + ((long long)(n0 + n) * 9 + tap) * C + c0 + part * 8;
    cp_async16(sB + n * LDB + tap * BKC + part * 8, src, 16);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C,
               int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [2][HALO][LDA]
  bf16* sB = sA + 2 * A_STAGE;                // [2][BN][LDB]

  const int tiles_x = W / TW;
  const int tiles_per_img = (H / TH) * tiles_x;
  const int b = blockIdx.x / tiles_per_img;
  const int t = blockIdx.x % tiles_per_img;
  const int y0 = (t / tiles_x) * TH;
  const int x0 = (t % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const bf16* xb = x + (long long)b * H * W * C;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 2;  // pixel rows [wm * 4, wm * 4 + 4) of the tile
  const int wn = warp / 2;  // channels [wn * 32, wn * 32 + 32) of the block

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_chunks = C / BKC;
  load_stage(sA, sB, xb, w, H, W, C, y0, x0, n0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < n_chunks) {
      load_stage(sA + (st ^ 1) * A_STAGE, sB + (st ^ 1) * B_STAGE, xb, w, H, W, C, y0, x0, n0,
                 (kc + 1) * BKC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = sA + st * A_STAGE;
    const bf16* Bs = sB + st * B_STAGE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // B: this warp's 32 channels at this tap (four 8-channel tiles)
      unsigned bb[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bb[nj], Bs + n * LDB + tap * BKC + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A rows: the 16 pixels of tile row wm * 4 + mi, shifted by the tap
        unsigned a[4];
        const int hp = (wm * 4 + mi + ky) * HW_ + (lane & 15) + kx;
        ldsm_x4(a, As + hp * LDA + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma16816(acc[mi][2 * nj], a, bb[nj][0], bb[nj][1]);
          mma16816(acc[mi][2 * nj + 1], a, bb[nj][2], bb[nj][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  // epilogue: this thread holds pixels (lane / 4) and (lane / 4 + 8) of each
  // tile row, channels 2 * (lane % 4) + {0, 1} of each 8-channel group
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[n]);
      b1 = __bfloat162float(bias[n + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int y = y0 + wm * 4 + mi;
      const int xa = x0 + (lane >> 2);
      bf16* row = out + (((long long)b * H + y) * W) * N + n;
      *reinterpret_cast<unsigned*>(row + (long long)xa * N) =
          pack_bf16x2(acc[mi][nt][0] + b0, acc[mi][nt][1] + b1);
      *reinterpret_cast<unsigned*>(row + (long long)(xa + 8) * N) =
          pack_bf16x2(acc[mi][nt][2] + b0, acc[mi][nt][3] + b1);
    }
  }
}

}  // namespace

// x (B, H, W, C), w (N, 3, 3, C), bias (N) or null, out (B, H, W, N): all
// contiguous bf16. Needs H % 8 == 0, W % 16 == 0, C % 16 == 0, N % 128 == 0.
// Returns a cudaError_t (0 = launched), or -1 for shapes it does not take.
extern "C" int cd360_conv3x3(const void* x, const void* w, const void* bias, void* out, int B,
                             int H, int W, int C, int N, void* stream) {
  if (H % TH || W % TW || C % BKC || N % BN || B <= 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * (H / TH) * (W / TW), N / BN);
  conv3x3_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), H, W, C, N);
  return (int)cudaGetLastError();
}
