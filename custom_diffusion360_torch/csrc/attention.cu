// Non-causal softmax attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernels of custom_diffusion360_tpu:
//   ops/block_attention.py::block_attention_qkv_fused (pallas_call :275)
//   ops/block_attention.py::block_attention            (pallas_call :123, :143)
//   jax.experimental.pallas.ops.tpu.flash_attention    (reached via ops/attention.py:149)
//
// out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h,j]) v[b,h,j], keys
// j >= kv_len masked out (weight exactly 0, as the TPU kernels' -1e30 logit).
//
// Bound on the H100: tensor-core operations (4*n*m*d FLOP per head) at the
// UNet shapes (d = 64, n = m in {1024, 4096}) and the VAE bottleneck
// (d = 512, n = m = 16384); the bytes (q, k, v read once, out written once)
// are 30-250x below the ridge point.
//
// Design (FlashAttention-2 layout on mma.sync m16n8k16): one block owns BQ
// query rows of one (batch, head); K/V tiles of BK keys stream through shared
// memory, double-buffered with cp.async and read with ldmatrix (V transposed
// on load), so no (n, m) score matrix reaches device memory and any m works.
// Each warp owns 16 query rows and D / DSPLIT output columns: S = Q K^T, the
// online softmax (running max and sum in f32, base-2 exponent) and the f32 O
// accumulator stay in registers, and the S fragments are re-packed as the
// bf16 A operand of P.V without touching shared memory. Operands are read in
// place through explicit (batch, head, seq) strides, so the packed
// (b, n, 3, h, d) output of the UNet's fused to_qkv needs no transpose or
// split copy. KV tiles past kv_len are skipped (their weights are exactly 0).
// Rows are padded by 16 bytes so the eight row addresses of an ldmatrix hit
// distinct banks. Two instantiations:
//   d = 64 (UNet, 70 calls per UNet evaluation): BQ = BK = 64, 4 warps, Q
//     fragments held in registers for the whole KV loop;
//   d = 512 (VAE, one call per decode): a 16 x 512 f32 accumulator does not
//     fit one warp's registers, so DSPLIT = 2 warps share each row group,
//     each accumulating 256 columns (128 registers a thread). Both compute the
//     full S of their rows (the Q K^T work is done twice, 1.5x the FLOP of
//     the bound) and re-read Q fragments from shared memory each KV tile.
//
// Not yet done (later work): wgmma/TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

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
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

template <int D_, int DSPLIT_, int BQ_, int BK_>
struct Cfg {
  static constexpr int D = D_, DSPLIT = DSPLIT_, BQ = BQ_, BK = BK_;
  static constexpr int ROW_WARPS = BQ / 16;
  static constexpr int NW = ROW_WARPS * DSPLIT;
  static constexpr int THREADS = NW * 32;
  static constexpr int DW = D / DSPLIT;  // output columns per warp
  static constexpr int LD = D + 8;       // bf16 pitch of the Q/K/V tiles
  static constexpr bool kQInRegs = D <= 128;
  static constexpr size_t kSmem = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);  // Q + 2 stages of K, V
};

// rows [row0, row0 + ROWS) of a (seq, D) operand into smem; rows >= valid
// are zero-filled (the global address is clamped to a valid row)
template <class C, int ROWS>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src, long long stride,
                                           int row0, int valid) {
  for (int i = threadIdx.x; i < ROWS * (C::D / 8); i += C::THREADS) {
    const int r = i / (C::D / 8);
    const int c = (i % (C::D / 8)) * 8;
    const int row = row0 + r;
    const bf16* g = src + (long long)min(row, valid - 1) * stride + c;
    cp_async16(dst + r * C::LD + c, g, row < valid ? 16 : 0);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int N, int M,
                int kv_len, float scale, long long qsb, long long qsh, long long qsn,
                long long ksb, long long ksh, long long ksn, long long vsb,
                long long vsh, long long vsn, long long osb, long long osh,
                long long osn) {
  constexpr int D = C::D, BK = C::BK, LD = C::LD, DW = C::DW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + C::BQ * LD;  // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]

  const int q0 = blockIdx.x * C::BQ;
  const bf16* qb = q + blockIdx.z * qsb + blockIdx.y * qsh;
  const bf16* kb = k + blockIdx.z * ksb + blockIdx.y * ksh;
  const bf16* vb = v + blockIdx.z * vsb + blockIdx.y * vsh;
  bf16* ob = o + blockIdx.z * osb + blockIdx.y * osh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % C::ROW_WARPS;  // this warp's 16 query rows
  const int c0 = (warp / C::ROW_WARPS) * DW;  // and its output columns

  load_async<C, C::BQ>(sQ, qb, qsn, q0, N);
  load_async<C, BK>(sK, kb, ksn, 0, M);
  load_async<C, BK>(sV, vb, vsn, 0, M);
  cp_async_commit();

  // ldmatrix row address of this lane in the warp's Q rows
  const bf16* sQw = sQ + (rg * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  unsigned qf[C::kQInRegs ? D / 16 : 1][4];
  float acc[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2

  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      load_async<C, BK>(sK + (st ^ 1) * BK * LD, kb, ksn, (kt + 1) * BK, M);
      load_async<C, BK>(sV + (st ^ 1) * BK * LD, vb, vsn, (kt + 1) * BK, M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (C::kQInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], sQw + kk * 16);
      }
    }
    const bf16* Ks = sK + st * BK * LD;
    const bf16* Vs = sV + st * BK * LD;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, sQw + kk * 16);
      }
#pragma unroll
      for (int nt = 0; nt < BK / 16; ++nt) {
        unsigned b[4];
        ldsm_x4(b, Ks + (nt * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma16816(s[2 * nt], a, b[0], b[1]);
        mma16816(s[2 * nt + 1], a, b[2], b[3]);
      }
    }

    // online softmax; this thread holds rows lane/4 and lane/4 + 8
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + j * 8 + (lane & 3) * 2 + (e & 1);
        const float val = key < kv_len ? s[j][e] * sl2 : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m_run[0] - mx[0]), exp2f(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O[:, c0:c0+DW] += P V[:, c0:c0+DW], P re-packed from the S fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DW / 16; ++dn) {
        unsigned b[4];
        ldsm_x4_trans(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                             dn * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * dn], a, b[0], b[1]);
        mma16816(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // all warps are done with stage st before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int r0 = q0 + rg * 16 + (lane >> 2);
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
    const int col = c0 + j * 8 + (lane & 3) * 2;
    if (r0 < N)
      *reinterpret_cast<unsigned*>(ob + (long long)r0 * osn + col) =
          pack_bf16x2(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<unsigned*>(ob + (long long)r1 * osn + col) =
          pack_bf16x2(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <class C>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int N, int M,
           int kv_len, float scale, const long long* st, cudaStream_t stream) {
  auto kern = attn_fwd_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, C::THREADS, C::kSmem, stream>>>(q, k, v, o, N, M, kv_len, scale, st[0], st[1],
                                               st[2], st[3], st[4], st[5], st[6], st[7],
                                               st[8], st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out in turn;
// the head-dim stride is 1. Returns a cudaError_t (0 = launched), or -1 for a
// head dim this library was not built for.
extern "C" int cd360_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int N, int M, int D,
                                   int kv_len, float scale,
                                   const long long* strides, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<Cfg<64, 1, 64, 64>>(qp, kp, vp, op, B, H, N, M, kv_len, scale, strides, s);
  if (D == 512)
    return launch<Cfg<512, 2, 64, 32>>(qp, kp, vp, op, B, H, N, M, kv_len, scale, strides, s);
  return -1;
}
