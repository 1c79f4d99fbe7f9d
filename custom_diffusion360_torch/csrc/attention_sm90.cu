// Non-causal softmax attention forward at head dim 64 for Hopper (sm_90a),
// bf16 in/out: wgmma for both products, TMA for every operand, one producer
// warp and two consumer warpgroups.
//
// Replaces the TPU kernels of custom_diffusion360_tpu at d = 64 (the UNet's
// and the pose blocks' self-attention):
//   ops/block_attention.py::block_attention_qkv_fused (pallas_call :275)
//   ops/block_attention.py::block_attention            (pallas_call :123, :143)
// (d = 512, the VAE bottleneck, is csrc/attention512_sm90.cu.)
//
// out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h,j]) v[b,h,j], keys
// j >= kv_len masked out (weight exactly 0, as the TPU kernels' -1e30 logit).
//
// Bound on the H100: tensor-core operations, 4 * b * h * n * kv_len * d FLOP
// at 989 TFLOP/s (the bytes, q/k/v read once and out written once, are
// 30-60x below the ridge at the UNet shapes). At d = 64 the softmax's
// exponentials (16 a clock per SM) take as many clocks as the two products,
// so the design keeps the tensor cores and the MUFU busy at once.
//
// Design. One block owns BQ = 128 query rows of one (batch, head) and walks
// the keys in tiles of BK = 128:
//   - Operands through TMA: four 4-D tensor maps over (d, seq, head, batch),
//     encoded on the host from the tensors' own byte strides (the Python
//     wrapper computes them: ops/block_attention.py::tma_map_args), so the
//     packed (b, n, 3, h, d) to_qkv view, contiguous (b, h, n, d) and the
//     (b, n, h, d) views all load in place. 128-byte swizzle (a d = 64 bf16
//     row is exactly 128 bytes), the layout wgmma reads without bank
//     conflicts; TMA's zero fill past the sequence ends replaces row clamping
//     and its clipped store writes the ragged last tile.
//   - Warp specialisation: warpgroup 0 is the producer (setmaxnreg 40); one
//     thread of it loads Q once and keeps a ring of STAGES K/V tiles in
//     flight, each stage with a full (TMA transaction bytes) and an empty
//     (one arrive per consumer warpgroup) mbarrier. Warpgroups 1 and 2 are
//     consumers (setmaxnreg 232), 64 query rows each.
//   - S = Q K^T: 4 x wgmma.m64n128k16, Q and K both K-major from shared
//     memory. The online softmax runs on the f32 accumulator in registers
//     (running max and sum, base-2 exponent, kv_len mask on the last tile).
//     P is packed to bf16 in registers and is the register A operand of
//     O += P V: 8 x wgmma.m64n64k16 with V an MN-major B operand from shared
//     memory. No S or P touches shared or device memory.
//   - Overlap: within a consumer warpgroup, tile kt's S = Q K^T and tile
//     kt-1's O += P V are issued together and the softmax of tile kt runs
//     while P V is still on the tensor cores (FlashAttention-3's
//     intra-warpgroup pipeline); between the two consumer warpgroups, named
//     barriers hand the right to issue wgmma back and forth (ping-pong), so
//     one's exponentials run while the other's products hold the tensor
//     cores. A stage is released only once the next tile's S is under way,
//     so a 3-stage K/V ring keeps two tiles' loads ahead of the consumers.
//   - Epilogue: 1/l, bf16, staged (swizzled) in the warpgroup's own Q rows,
//     one TMA store per warpgroup.
//
// Resources (nvcc -Xptxas -v on the H100 build, printed by chip_smoke.py's
// [build] lines): 168 registers a thread at launch (384 threads, 1 block per
// SM; setmaxnreg then gives the producer 40 and the consumers 232), no
// spills, 16 barriers; 113 KB + 1 KB alignment slack of dynamic shared
// memory (Q 16 KB, 3 stages of K and V 32 KB each). Its SASS holds 24 HGMMA
// and 3 UTMALDG (cuobjdump -sass). The mbarrier, TMA and wgmma helpers are
// shared with conv3x3.cu through sm90.cuh.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;        // head dim: one 128-byte row
constexpr int BQ = 128;      // query rows per block
constexpr int BK = 128;      // keys per K/V tile
constexpr int STAGES = 3;    // K/V ring depth
constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 query rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int TILE_Q = BQ * D * 2;   // bytes
constexpr int TILE_KV = BK * D * 2;  // bytes of one K or V tile
constexpr int OFF_K = TILE_Q;
constexpr int OFF_V = OFF_K + STAGES * TILE_KV;
constexpr int OFF_BAR = OFF_V + STAGES * TILE_KV;
constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);  // 1 KB: alignment slack

// named barriers over both consumer warpgroups (256 threads): wait for
// the other's arrival / arrive without waiting
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the MUFU (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 128) = Q (64 rows at q_addr) K^T (128 keys at k_addr): 4 k-steps
// of 16, 32 bytes apart along the swizzled 128-byte rows; one commit group
__device__ __forceinline__ void qk_tile(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(sc, sw128_desc(q_addr + kk * 32), sw128_desc(k_addr + kk * 32), kk);
  wgmma_commit();
}

// O += P V (128 keys at v_addr): P's accumulator blocks 2kk, 2kk + 1 are the
// register A operand of k-step kk, 16 keys = 2048 bytes of V rows; one
// commit group
__device__ __forceinline__ void pv_tile(float (&o)[32], const uint32_t (&pa)[BK / 16][4],
                                        uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n64k16_rs(o, pa[kk], sw128_desc(v_addr + kk * 2048));
  wgmma_commit();
}

// The online softmax of tile kt on its S accumulator, in place: mask keys
// >= kv_len, update the running max m (raw scores) and sum l of this
// thread's two rows, leave P = 2^((s - m) * scale * log2 e) in sc and the
// factor O must be rescaled by in alpha. Accumulator layout: sc[4j + e] is
// row (e < 2 ? r : r + 8), key kt * BK + 8j + 2 * (lane % 4) + (e & 1); a
// row's 128 keys lie in the 4 threads of a quad.
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2], int kt,
                                               int kv_len, int lane, float sl2) {
  if ((kt + 1) * BK > kv_len) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + j * 8 + (lane & 3) * 2 + (e & 1);
        if (key >= kv_len) sc[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m_run[i] - mx[i]) * sl2);  // 0 on the first tile (m = -inf)
    m_run[i] = mx[i];
  }
  const float mb[2] = {mx[0] * sl2, mx[1] * sl2};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -mb[e >> 1]));
      rs[e >> 1] += sc[4 * j + e];
    }
  }
  l_run[0] = l_run[0] * alpha[0] + rs[0];
  l_run[1] = l_run[1] * alpha[1] + rs[1];
}

// P (f32 accumulator layout) -> the bf16 register A fragments of P V
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 int N, int kv_len, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle is a function of the address bits: 1024-byte atoms
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + OFF_BAR;
  const uint32_t bar_full = bar_q + 8;                // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // [STAGES]

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = (kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
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
      mbar_expect_tx(bar_q, TILE_Q);
      tma_load_4d(s_base, &tm_q, bar_q, 0, q0, head, batch);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bar_empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * TILE_KV);
        tma_load_4d(s_base + OFF_K + s * TILE_KV, &tm_k, bar_full + 8 * s, 0, kt * BK, head,
                    batch);
        tma_load_4d(s_base + OFF_V + s * TILE_KV, &tm_v, bar_full + 8 * s, 0, kt * BK, head,
                    batch);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const uint32_t q_addr = s_base + wg * (64 * D * 2);
    const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // this thread's rows: warp * 16 + lane / 4 (index 0) and + 8 (index 1)
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    // Software pipeline (FlashAttention-3's intra-warpgroup overlap): while
    // the tensor cores run tile kt's S = Q K^T and tile kt-1's O += P V, this
    // warpgroup waits only for S, runs tile kt's softmax on it, then waits
    // for P V, rescales O and releases tile kt-1's stage.
    float sc[64];             // S, then P, of the newest tile (f32)
    uint32_t pa[BK / 16][4];  // P of the tile whose P V is next (bf16)
    float alpha[2];
    // Ping-pong between the two consumer warpgroups (named barriers 3, 4):
    // each issues its wgmma only in its turn and then hands the turn over,
    // so one's softmax runs while the other's products hold the tensor
    // cores. Warpgroup 1 gives warpgroup 0 the first turn.
    const int my_turn = 3 + wg, other_turn = 4 - wg;
    if (wg == 1) named_arrive(other_turn);
    mbar_wait(bar_full, 0);
    named_sync(my_turn);
    wgmma_fence();
    qk_tile(sc, q_addr, s_base + OFF_K);
    named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(sc, m_run, l_run, alpha, 0, kv_len, lane, sl2);
    pack_p(pa, sc);
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int s = kt % STAGES, prev = (kt - 1) % STAGES;
      mbar_wait(bar_full + 8 * s, (kt / STAGES) & 1);
      fence_regs(sc);
      fence_regs(o);
      named_sync(my_turn);
      wgmma_fence();
      qk_tile(sc, q_addr, s_base + OFF_K + s * TILE_KV);
      pv_tile(o, pa, s_base + OFF_V + prev * TILE_KV);
      named_arrive(other_turn);
      wgmma_wait<1>();  // S of tile kt (committed first) is done
      fence_regs(sc);
      online_softmax(sc, m_run, l_run, alpha, kt, kv_len, lane, sl2);
      wgmma_wait<0>();  // P V of tile kt-1 is done: O is ours, its stage free
      fence_regs(o);
      if (t == 0) mbar_arrive(bar_empty + 8 * prev);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack_p(pa, sc);
    }
    fence_regs(o);
    named_sync(my_turn);
    wgmma_fence();
    pv_tile(o, pa, s_base + OFF_V + ((n_tiles - 1) % STAGES) * TILE_KV);
    if (wg == 0) named_arrive(other_turn);  // warpgroup 1's last turn; nothing after it
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: O / l in bf16, staged with the 128-byte swizzle in this
    // warpgroup's own Q rows (its last wgmma has completed), one TMA store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
    unsigned char* stage = smem + wg * (64 * D * 2);
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int off = r * 128 + ((j ^ (r & 7)) << 4) + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(stage + off) =
            pack_bf16x2(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0 && q0 + wg * 64 < N) tma_store_4d(&tm_o, q_addr, 0, q0 + wg * 64, head, batch);
  }
}

// a 4-D map over (d = 64, seq, head, batch) with byte strides (seq, head,
// batch), boxes of 64 x rows, 128-byte swizzle, zero fill out of bounds
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int seq, int heads, int batch,
            const long long* strides, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                            (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, st, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, out (B, H, N, 64) and k, v (B, H, M, 64) bf16 with a unit head-dim
// stride; strides: 12 byte strides, (seq, head, batch) for q, k, v, out in
// turn, each a multiple of 16 (ops/block_attention.py::tma_map_args).
// Returns a cudaError_t (0 = launched), -2 if the driver has no
// cuTensorMapEncodeTiled, -3 if it refused a map.
extern "C" int cd360_attention_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int N, int M, int kv_len, float scale,
                                    const long long* strides, void* stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode(fn, &tm_q, q, N, H, B, strides, BQ) || !encode(fn, &tm_k, k, M, H, B, strides + 3, BK) ||
      !encode(fn, &tm_v, v, M, H, B, strides + 6, BK) ||
      !encode(fn, &tm_o, o, N, H, B, strides + 9, 64))
    return -3;
  // the shared-memory attribute once per device (not a stream operation, but
  // kept out of every launch so that a CUDA-graph capture sees launches only)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(attn_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) attr_set[dev] = true;
  }
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_sm90_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(tm_q, tm_k, tm_v,
                                                                               tm_o, N, kv_len, scale);
  return (int)cudaGetLastError();
}
