// Non-causal softmax attention forward at head dim 512 for Hopper (sm_90a),
// bf16 in/out, f32 softmax statistics: wgmma for both products, TMA for
// every operand, one producer warp and two consumer warpgroups, and the keys
// split across blocks when the grid is under one wave.
//
// Replaces the TPU kernels of custom_diffusion360_tpu at d = 512 (the VAE's
// one-head mid-block attention: 4096 tokens in the training encoder, 16384
// in the 1024^2 decoder):
//   ops/block_attention.py::block_attention       (pallas_call :123, :143)
//   ops/block_attention.py::block_attention_bnhd  (pallas_call :218)
//   jax.experimental.pallas.ops.tpu.flash_attention (reached via ops/attention.py:149)
// Head dim 64 is csrc/attention_sm90.cu.
//
// out[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h,j]) v[b,h,j], keys
// j >= kv_len masked out (weight exactly 0, as the TPU kernels' -1e30 logit).
//
// Bound on the H100: tensor-core operations, 4 * b * h * n * kv_len * 512
// FLOP at 989 TFLOP/s; the bytes (q, k, v read once, out written once) are
// 100-400x below the ridge at the launched shapes.
//
// Design. One block owns BQ = 64 query rows of one (batch, head) and walks
// its keys in tiles of BK = 32:
//   - Operands through TMA: 4-D maps over (d, seq, head, batch) encoded from
//     the tensors' own byte strides (ops/block_attention.py::tma_map_args),
//     so contiguous (b, h, n, d) and the (b, n, h, d) views load in place.
//     A 128-byte-swizzled box row is at most 128 bytes, so a 512-wide row is
//     eight 64-column boxes: Q is 8 boxes x 64 rows, each K and V tile 8
//     boxes x 32 rows. TMA's zero fill past the sequence replaces row
//     clamping; its clipped store writes a ragged last query tile.
//   - Warp specialisation: warpgroups 0 and 1 are the consumers
//     (setmaxnreg 232: 128 accumulator registers of O, 16 of S, 8 of P),
//     warpgroup 2 the producer (setmaxnreg 40). A lone producer warp (288
//     threads) did not raise the register budget: ptxas still gave 168
//     and spilled. The producer's one thread loads Q once and keeps K and
//     V tiles in flight in two rings of 2 stages each, every stage with a
//     full (TMA transaction bytes) and an empty (one arrive per consumer
//     warpgroup) mbarrier: a K stage is free once its S is computed, a V
//     stage once its P V is, so each ring runs a tile ahead.
//   - S = Q K^T computed once, split over d: warpgroup w reduces over
//     d in [256w, 256w + 256), 16 k-steps of wgmma.m64n32k16 with Q and K
//     K-major from shared memory, into a 64 x 32 f32 partial. Each writes
//     its partial into its own shared-memory slot (two slots per warpgroup,
//     alternating by tile, so one named barrier a tile orders the exchange),
//     and after a named barrier over the 256 consumer threads adds the
//     other's. Both then hold the same full S (a + b == b + a) and run the
//     same online softmax: running max and sum in f32, base-2 exponent, the
//     kv_len mask on the last live tile. Repeating the softmax costs one
//     exponential per 2048 FLOP of products at d = 512.
//   - O += P V split over output columns: P is packed to bf16 in registers
//     as the register-A operand; warpgroup w accumulates O[:, 256w, +256)
//     with 2 x wgmma.m64n256k16 per tile, V an MN-major B operand whose
//     descriptor steps 4096 bytes (one 32-row box) between its 64-column
//     atoms. 128 f32 accumulator registers a thread.
//   - Overlap (FlashAttention-3's intra-warpgroup pipeline): tile i's S and
//     tile i-1's P V are issued together; the exchange and softmax of tile i
//     run while P V is still on the tensor cores.
//   - Keys split across blocks (the wrapper's split_count): when
//     ceil(n / 64) * b * h blocks leave SMs idle, gridDim.y = splits blocks
//     share a query tile, each over a contiguous run of key tiles, and write
//     f32 O (not divided by l) and each row's (max * scale * log2 e, sum) to
//     a workspace; attn512_merge_kernel then forms out = sum_s 2^(m_s - M)
//     O_s / sum_s 2^(m_s - M) l_s, giving a split with no live key (kv_len at
//     or before its first key: m = -inf, l = 0) a weight of exactly 0. With
//     one split the block divides by l, converts to bf16 in its own Q boxes
//     (128-byte swizzle) and TMA-stores: no second launch.
//
// Resources (nvcc -Xptxas -v on the H100 build, printed by chip_smoke.py's
// [build] lines): attn512_kernel 168 registers a thread at launch (384
// threads, one block per SM; setmaxnreg then gives the producer 40 and the
// consumers 232), no spills, 16 barriers; attn512_merge_kernel 32
// registers, no spills. Its SASS holds 36 HGMMA, 24 UTMALDG and 4 UTMASTG
// (cuobjdump -sass). Shared memory: Q 64 KB, K and V 2 x 32 KB each, the S
// exchange 4 x 8 KB, 9 mbarriers, 1 KB alignment slack: 230 472 bytes of
// the 232 448 a block may have.
//
// Not kept: a 2-block cluster sharing each K/V tile by multicast TMA (half
// the L2 traffic) was slower at every launched shape (PERF.md, PR 7).

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 512;                 // head dim
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per K/V tile
constexpr int STAGES = 2;              // depth of the K ring and of the V ring
constexpr int HALF = D / 2;            // d (and output columns) per consumer warpgroup
constexpr int BOXES = D / 64;          // 128-byte column boxes of a row
constexpr int PRODUCER = 256;          // first thread of the producer warpgroup
constexpr int THREADS = PRODUCER + 128;
constexpr int BOX_Q = BQ * 128;        // bytes of one 64-column box of Q (or of O)
constexpr int BOX_KV = BK * 128;       // bytes of one 64-column box of a K or V tile
constexpr int TILE_Q = BOXES * BOX_Q;
constexpr int TILE_KV = BOXES * BOX_KV;
constexpr int XCH = BQ * BK * 4;       // one warpgroup's partial S (f32)
constexpr int OFF_K = TILE_Q;
constexpr int OFF_V = OFF_K + STAGES * TILE_KV;
constexpr int OFF_X = OFF_V + STAGES * TILE_KV;
constexpr int OFF_BAR = OFF_X + 4 * XCH;
constexpr int N_BARS = 1 + 4 * STAGES;
constexpr int SMEM = 1024 + OFF_BAR + 8 * N_BARS;  // 1 KB: alignment slack
static_assert(SMEM <= 232448, "more shared memory than a block may have");

// named barriers (id 0 is __syncthreads): 1 over both consumer warpgroups,
// 2 + wg over one warpgroup
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the MUFU (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// partial S (64 x 32) = Q[:, 256w, +256) K[:, 256w, +256)^T: the four 64-column
// boxes of this warpgroup's half of d, 4 k-steps of 16 each (32 bytes apart
// along the swizzled 128-byte rows); one commit group
__device__ __forceinline__ void qk_partial(float (&sc)[16], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int c = 0; c < HALF / 64; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n32k16_ss(sc, sw128_desc(q_addr + c * BOX_Q + kk * 32),
                         sw128_desc(k_addr + c * BOX_KV + kk * 32), c | kk);
  }
  wgmma_commit();
}

// O[:, 256w, +256) += P V (32 keys; v_addr: the first of this warpgroup's four
// 64-column boxes, BOX_KV apart): k-step kk is 16 keys = 2048 bytes of rows;
// one commit group
__device__ __forceinline__ void pv_tile(float (&o)[128], const uint32_t (&pa)[BK / 16][4],
                                        uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n256k16_rs(o, pa[kk], sw128_desc(v_addr + kk * 2048, BOX_KV));
  wgmma_commit();
}

// S = this warpgroup's partial + the other's, through shared memory: thread
// t's 16 values as four float4 at [q * 128 + t] (conflict-free). The slots
// alternate by tile, so the other warpgroup has read tile i - 2's values
// (before the barrier of tile i - 1) when this one overwrites them.
__device__ __forceinline__ void exchange_s(float (&sc)[16], float4* mine, const float4* other,
                                           int i, int t) {
  mine += (i & 1) * (XCH / 16);
  other += (i & 1) * (XCH / 16);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    mine[q * 128 + t] = make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2], sc[4 * q + 3]);
  bar_sync(1, 256);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = other[q * 128 + t];
    sc[4 * q] += x.x;
    sc[4 * q + 1] += x.y;
    sc[4 * q + 2] += x.z;
    sc[4 * q + 3] += x.w;
  }
}

// The online softmax of key tile kt on the full S, in place: mask keys >=
// kv_len, update the running max m (raw scores) and this thread's share of
// the running sum l of its two rows, leave P = 2^((s - m) * scale * log2 e)
// in sc and O's rescale factor in alpha. Accumulator layout: sc[4j + e] is
// row (e < 2 ? r : r + 8), key kt * BK + 8j + 2 * (lane % 4) + (e & 1); a
// row's 32 keys lie in the 4 threads of a quad.
__device__ __forceinline__ void online_softmax(float (&sc)[16], float (&m_run)[2],
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
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[16]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// grid (ceil(N / BQ), splits, B * H); split y takes key tiles
// [y * tiles_per_split, +tiles_per_split) below kv_len. With one split the
// block writes out through tm_o; else O (f32, not divided by l) to
// ws[y][b * H + h][row][:] and (m * scale * log2 e, l) to ml[y][b * H + h][row][:],
// rows padded to gridDim.x * BQ.
__global__ void __launch_bounds__(THREADS, 1)
attn512_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ ws, float* __restrict__ ml, int H, int kv_len,
               int tiles_per_split, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle is a function of the address bits: 1024-byte atoms
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + OFF_BAR;
  const uint32_t full_k = bar_q + 8;                 // [STAGES] each
  const uint32_t empty_k = full_k + 8 * STAGES;
  const uint32_t full_v = empty_k + 8 * STAGES;
  const uint32_t empty_v = full_v + 8 * STAGES;

  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int head = blockIdx.z % H, batch = blockIdx.z / H;
  const int t_begin = split * tiles_per_split;
  const int live = (kv_len + BK - 1) / BK;
  const int n_tiles = max(0, min(live, t_begin + tiles_per_split) - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == PRODUCER && n_tiles > 0) {
      mbar_expect_tx(bar_q, TILE_Q);
      for (int c = 0; c < BOXES; ++c)
        tma_load_4d(s_base + c * BOX_Q, &tm_q, bar_q, 64 * c, q0, head, batch);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        const int key = (t_begin + i) * BK;
        mbar_wait(empty_k + 8 * s, free_parity);
        mbar_expect_tx(full_k + 8 * s, TILE_KV);
        for (int c = 0; c < BOXES; ++c)
          tma_load_4d(s_base + OFF_K + s * TILE_KV + c * BOX_KV, &tm_k, full_k + 8 * s, 64 * c,
                      key, head, batch);
        mbar_wait(empty_v + 8 * s, free_parity);
        mbar_expect_tx(full_v + 8 * s, TILE_KV);
        for (int c = 0; c < BOXES; ++c)
          tma_load_4d(s_base + OFF_V + s * TILE_KV + c * BOX_KV, &tm_v, full_v + 8 * s, 64 * c,
                      key, head, batch);
      }
    }
    return;
  }

  // ---- consumer warpgroups: d (for S) and output columns (for O) split in halves ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8 of the tile
  const size_t ws_row = ((size_t)split * gridDim.z + blockIdx.z) * (gridDim.x * BQ) + q0 + r0;
  if (n_tiles == 0) {
    // a split with no key below kv_len (split launches only): weight 0 in the merge
    if (wg == 0 && (lane & 3) == 0) {
      *reinterpret_cast<float2*>(ml + 2 * ws_row) = make_float2(-INFINITY, 0.f);
      *reinterpret_cast<float2*>(ml + 2 * (ws_row + 8)) = make_float2(-INFINITY, 0.f);
    }
    return;
  }
  const uint32_t q_addr = s_base + wg * (HALF / 64) * BOX_Q;
  const uint32_t k_half = s_base + OFF_K + wg * (HALF / 64) * BOX_KV;
  const uint32_t v_half = s_base + OFF_V + wg * (HALF / 64) * BOX_KV;
  float4* xch_mine = reinterpret_cast<float4*>(smem + OFF_X + wg * 2 * XCH);
  const float4* xch_other = reinterpret_cast<const float4*>(smem + OFF_X + (1 - wg) * 2 * XCH);
  const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float sc[16];  // S, then P, of the newest tile (f32)
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;
  uint32_t pa[BK / 16][4];  // P of the tile whose P V is next (bf16)
  float alpha[2];  // O's rescale factors of the newest tile (unused for tile 0: O = 0)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  // tile 0: S only (peeled, so that no wgmma sits in a conditional branch)
  mbar_wait(full_k, 0);
  fence_regs(sc);
  wgmma_fence();
  qk_partial(sc, q_addr, k_half);
  wgmma_wait<0>();
  fence_regs(sc);
  if (t == 0) mbar_arrive(empty_k);
  exchange_s(sc, xch_mine, xch_other, 0, t);
  online_softmax(sc, m_run, l_run, alpha, t_begin, kv_len, lane, sl2);
  pack_p(pa, sc);
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % STAGES, prev = (i - 1) % STAGES;
    mbar_wait(full_k + 8 * s, (i / STAGES) & 1);
    mbar_wait(full_v + 8 * prev, ((i - 1) / STAGES) & 1);
    fence_regs(sc);
    fence_regs(o);
    wgmma_fence();
    qk_partial(sc, q_addr, k_half + s * TILE_KV);
    pv_tile(o, pa, v_half + prev * TILE_KV);
    wgmma_wait<1>();  // the partial S of tile i (committed first) is done
    fence_regs(sc);
    if (t == 0) mbar_arrive(empty_k + 8 * s);
    exchange_s(sc, xch_mine, xch_other, i, t);
    online_softmax(sc, m_run, l_run, alpha, t_begin + i, kv_len, lane, sl2);
    wgmma_wait<0>();  // P V of tile i - 1 is done: O is ours, its V stage free
    fence_regs(o);
    if (t == 0) mbar_arrive(empty_v + 8 * prev);
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    pack_p(pa, sc);
  }
  const int last = (n_tiles - 1) % STAGES;
  mbar_wait(full_v + 8 * last, ((n_tiles - 1) / STAGES) & 1);
  fence_regs(o);
  wgmma_fence();
  pv_tile(o, pa, v_half + last * TILE_KV);
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }

  if (splits > 1) {
    // O and (m, l) to the workspace; rows past N land in its padding
    float* row = ws + ws_row * D + wg * HALF + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(row + 8 * D + 8 * j) = make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (wg == 0 && (lane & 3) == 0) {
      *reinterpret_cast<float2*>(ml + 2 * ws_row) = make_float2(m_run[0] * sl2, l_run[0]);
      *reinterpret_cast<float2*>(ml + 2 * (ws_row + 8)) = make_float2(m_run[1] * sl2, l_run[1]);
    }
    return;
  }

  // one split: O / l in bf16, staged with the 128-byte swizzle in this
  // warpgroup's own Q boxes (only it reads them, and its last S is done),
  // four TMA stores
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  unsigned char* stage = smem + wg * (HALF / 64) * BOX_Q;
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const int off = (j / 8) * BOX_Q + r * 128 + (((j & 7) ^ (r & 7)) << 4) + (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(stage + off) =
          pack_bf16x2(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(2 + wg, 128);
  if (t == 0) {
    for (int c = 0; c < HALF / 64; ++c)
      tma_store_4d(&tm_o, q_addr + c * BOX_Q, wg * HALF + 64 * c, q0, head, batch);
  }
}

// out[b, h, n, :] = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s over the
// splits, M the largest m_s; a split with l_s = 0 (no live key) has weight
// exactly 0 and its O_s is not read. 64 threads a row, 8 columns each;
// out_st: out's (seq, head, batch) element strides.
__global__ void __launch_bounds__(256)
attn512_merge_kernel(const float* __restrict__ ws, const float* __restrict__ ml,
                     bf16* __restrict__ out, int BH, int H, int N, int n_pad, int splits,
                     long long st_seq, long long st_head, long long st_batch) {
  const int row = blockIdx.x * 4 + threadIdx.x / 64;
  if (row >= BH * N) return;
  const int bh = row / N, n = row % N;
  const int col = (threadIdx.x % 64) * 8;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) {
    const float2 e = *reinterpret_cast<const float2*>(ml + 2 * (((size_t)s * BH + bh) * n_pad + n));
    if (e.y > 0.f) mx = fmaxf(mx, e.x);
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = ((size_t)s * BH + bh) * n_pad + n;
    const float2 e = *reinterpret_cast<const float2*>(ml + 2 * r);
    if (!(e.y > 0.f)) continue;
    const float w = exp2f(e.x - mx);
    l += w * e.y;
    const float4* src = reinterpret_cast<const float4*>(ws + r * D + col);
    const float4 lo = src[0], hi = src[1];
    acc[0] += w * lo.x;
    acc[1] += w * lo.y;
    acc[2] += w * lo.z;
    acc[3] += w * lo.w;
    acc[4] += w * hi.x;
    acc[5] += w * hi.y;
    acc[6] += w * hi.z;
    acc[7] += w * hi.w;
  }
  const float inv = 1.f / l;
  uint4 v;
  v.x = pack_bf16x2(acc[0] * inv, acc[1] * inv);
  v.y = pack_bf16x2(acc[2] * inv, acc[3] * inv);
  v.z = pack_bf16x2(acc[4] * inv, acc[5] * inv);
  v.w = pack_bf16x2(acc[6] * inv, acc[7] * inv);
  const int h = bh % H, b = bh / H;
  *reinterpret_cast<uint4*>(out + b * st_batch + h * st_head + n * st_seq + col) = v;
}

// a 4-D map over (d = 512, seq, head, batch) with byte strides (seq, head,
// batch), boxes of 64 columns x rows, 128-byte swizzle, zero fill out of bounds
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int seq, int heads, int batch,
            const long long* strides, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                            (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, st, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, out (B, H, N, 512) and k, v (B, H, M, 512) bf16 with a unit head-dim
// stride; strides: 12 byte strides, (seq, head, batch) for q, k, v, out in
// turn, each a multiple of 16 (ops/block_attention.py::tma_map_args).
// splits > 1: ws (splits, B * H, ceil(N / 64) * 64, 512) and ml (splits,
// B * H, ceil(N / 64) * 64, 2) f32 workspaces, and a second (merge) launch;
// splits == 1: ws and ml are not read and may be null. The keys split in
// runs of ceil(ceil(M / 32) / splits) tiles of 32
// (ops/block_attention.py::attention_splitkv_plain).
// Returns a cudaError_t (0 = launched), -2 if the driver has no
// cuTensorMapEncodeTiled, -3 if it refused a map.
extern "C" int cd360_attention512(const void* q, const void* k, const void* v, void* o, void* ws,
                                  void* ml, int B, int H, int N, int M, int kv_len, float scale,
                                  int splits, const long long* strides, void* stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode(fn, &tm_q, q, N, H, B, strides, BQ) ||
      !encode(fn, &tm_k, k, M, H, B, strides + 3, BK) ||
      !encode(fn, &tm_v, v, M, H, B, strides + 6, BK) ||
      !encode(fn, &tm_o, o, N, H, B, strides + 9, BQ))
    return -3;
  // the shared-memory attribute once per device (not a stream operation, but
  // kept out of every launch so that a CUDA-graph capture sees launches only)
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(attn512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) attr_set[dev] = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_blocks = (N + BQ - 1) / BQ;
  const int tiles_per_split = ((M + BK - 1) / BK + splits - 1) / splits;
  attn512_kernel<<<dim3(q_blocks, splits, B * H), THREADS, SMEM, s>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(ws), static_cast<float*>(ml), H, kv_len,
      tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int rows = B * H * N;
  attn512_merge_kernel<<<(rows + 3) / 4, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(ml), static_cast<bf16*>(o), B * H,
      H, N, q_blocks * BQ, splits, strides[9] / 2, strides[10] / 2, strides[11] / 2);
  return (int)cudaGetLastError();
}
