// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV from bf16 Q, K,
// V, O, dO and the forward's fp32 log-sum-exp; fp32 accumulation, bf16 out.
//
// Replaces: the backward of the Pallas TPU kernel that
// ray_tpu/ops/attention.py `_flash` calls,
// jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_bwd_dkv`
// (pallas_call at flash_attention.py:1121) and `_flash_attention_bwd_dq`
// (:1456), tied to the forward by its custom_vjp. Same function: with
// P = exp(Q K^T * scale - lse) and D = rowsum(dO * O),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),
//   dK = dS^T Q * scale,  dQ = dS K * scale.
//
// What bounds it on this card: five S x S x D products per head (causal:
// half of them), about S/2 multiply-adds per byte read at S = 2048, far
// above the H100's ~295 operations per byte, so the tensor cores bound it:
// 1.1e11 operations at GPT-J's B=1, S=2048, H=16, Hd=256, causal, 0.0869 ms
// at 989 TFLOP/s. P, dP and dS never reach device memory.
//
// Translation: the TPU kernel carries its dK/dV and dQ sums across
// sequential grid steps in scratch memory. CTAs on Hopper run in parallel
// and carry nothing, so each sum is a loop inside one CTA, and the two sums
// are two kernels, as on the TPU (seven products where the bound counts
// five: both recompute S and dP). No atomics anywhere: the gradients are
// the same bits from run to run.
//   1. delta: D[b, h, i] = sum_d dO * O in fp32, one warp per row;
//   2. dK/dV: one CTA per (64-key tile, kv head, batch) loops over the
//      query heads of its grouped-query group and over the 64-query tiles
//      that can see its keys (causal: the diagonal tile and below);
//   3. dQ: one CTA per (128-query tile, head, batch) loops over the key
//      tiles up to the diagonal.
//
// Design, common to both (see hopper.cuh for the primitives): 384 threads,
// two consumer warpgroups and one producer warpgroup, which gives its
// registers to the consumers (setmaxnreg: 24 a thread for the producer,
// 240 for the consumers). One producer thread loads the stationary tiles
// once (K and V in dK/dV; Q and dO in dQ) and streams the others (Q and
// dO; K and V) through TMA rings with full/empty mbarriers, so the next
// tile is in flight while this one is multiplied. Every product is a
// wgmma: the first operand of a score product from shared memory
// (K-major), a probability or gradient from registers (the m64nNk16
// accumulator layout is the A-operand layout), and the
// contraction-along-rows operands (dO and Q in dK/dV, K in dQ) read
// MN-major through the descriptor's transpose bit.
//
// dK/dV: the two warpgroups share one 64-key tile instead of each taking
// its own, so that no product is computed twice and each thread holds one
// D-wide accumulator, not two (at head_dim 256 dK and dV together would
// take 256 fp32 registers a thread):
//   warpgroup 0: S^T = K Q^T, P^T = exp(S^T * scale - lse), P^T (fp32) to
//     shared memory for warpgroup 1, dV += P^T dO;
//   warpgroup 1: dP^T = V dO^T, dS^T = P^T * (dP^T - D), dK += dS^T Q.
// The two halves do the same tensor-core work. Named barriers hand P^T
// over (ready) and back (free). P and dS are rounded to bf16 once each,
// right before their products. The Q tile's lse and delta come with it,
// by TMA, into shared memory: read from device memory by every thread,
// they cost a quarter of the kernel's time. The ring has two stages: a
// third, which overlapping one tile's products with the next would need,
// has no room at head_dim 256.
// dQ: each warpgroup owns 64 query rows: S = Q K^T and dP = dO V^T from
// shared memory, dS in registers, dQ += dS K. As in the forward kernel,
// S and dP of key tile j issue together with dQ's product for tile j - 1,
// dS of tile j is computed under it, and the two warpgroups take turns to
// issue. K is read last, by dQ, so its ring has three stages and V's two.
// Key tiles are 64 wide at head_dim 64/128 and 32 at 256, where dQ alone
// takes 128 registers.
//
// Shared memory per CTA (plus 1 KB for alignment and barriers):
//   dK/dV: K, V (64 x D each), two stages of Q, dO (64 x D each), lse and
//          delta, P^T (64 x 64 fp32): 65.5 / 113.5 / 209.5 KB at head_dim
//          64 / 128 / 256;
//   dQ:    Q, dO (128 x D each), three stages of K and two of V (BN x D
//          each): 72 / 144 / 208 KB.
// `nvcc -Xptxas -v` (sm_90a, CUDA 12.8): every dK/dV and dQ instantiation
// 168 registers a thread at launch (384 threads; setmaxnreg then moves them
// as above), delta 26; 0 bytes spilled in all.
//
// Layout: BSHD. q/o/dO/dQ (B, Sq, H, D), k/v/dK/dV (B, Sk, KV, D), all
// contiguous and 16-byte aligned; lse and delta (B, H, Sq) fp32, lse in
// natural log as the forward writes it. Causal masking is top-left aligned
// (query i sees keys 0..i). Ragged tails: TMA reads rows past the sequence
// as zeros, P is set to exactly 0 for any query or key out of range, and
// no row past Sq or Sk is written.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 2 x 128 x 240 + 128 x 24 = 64,512 of 65,536
constexpr int KV_ROWS = 64;              // keys per dK/dV CTA
constexpr int KV_BM = 64;                // queries per dK/dV step
constexpr int Q_ROWS = 128;              // queries per dQ CTA
// A Q tile's lse or delta: a TMA box starts 16-byte aligned in device
// memory, so a box of KV_BM + 4 values starts at the tile's first row
// rounded down to 4, and 128-byte aligned in shared memory, so the two
// boxes lie STAT_ROW floats apart.
constexpr int STAT_BOX = KV_BM + 4;
constexpr int STAT_ROW = KV_BM + 32;
constexpr int DQ_K_STAGES = 3;           // the dQ kernel's K ring
constexpr int BAR_P_READY = 1;           // named barriers of the dK/dV kernel
constexpr int BAR_P_FREE = 2;
constexpr int BAR_TURN = 1;              // of the dQ kernel: 1, 2, the warpgroups' turns
constexpr float LOG2E = 1.4426950408889634f;

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp per row;
// rows run in (b, i, h) order. The lanes' fixed split and the fixed shuffle
// tree give the same sum every run.
__global__ void bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                 float* __restrict__ delta, int Sq, int H, int D, long rows) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* orow = o + row * D;
  const bf16* drow = dout + row * D;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bi = row / H;
    const long i = bi % Sq;
    const long b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// Stores a 64 x D accumulator (rows row0 + 16 * warp + lane / 4 [+ 8]) as
// bf16 times `mul`, skipping rows at or past n_rows.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long row_stride, const float (&acc)[D / 2],
                                           int row_lo, int n_rows, int t, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= n_rows) continue;
    bf16* p = base + (long)row * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

template <int D>
struct DkvSmem {
  static constexpr int KV = KV_ROWS * D * 2;  // one of K, V
  static constexpr int TILE = KV_BM * D * 2;  // one of Q, dO
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = 2 * KV;
  static constexpr int XBUF = RING + STAGES * STAGE;  // P^T, fp32, fragment order
  static constexpr int STAT = 2 * STAT_ROW * 4;         // lse and delta of one Q tile
  static constexpr int STATS = XBUF + KV_ROWS * KV_BM * 4;
  static constexpr int BARS = STATS + STAGES * STAT;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_lse,
                         const __grid_constant__ CUtensorMap tm_delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                         int KV, int causal, float scale) {
  using L = DkvSmem<D>;
  constexpr int BM = KV_BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  float* xbuf = reinterpret_cast<float*>(smem + L::XBUF);
  const uint32_t sK = base;
  const uint32_t sV = base + L::KV;
  const uint32_t sRing = base + L::RING;
  const uint32_t kv_full = base + L::BARS;
  const uint32_t full = kv_full + 8;          // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;   // + 8 * stage

  const int n0 = blockIdx.x * KV_ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int m_first = causal ? n0 / BM : 0;  // first query tile that sees key n0
  const int m_blocks = (Sq + BM - 1) / BM;
  const int n_mb = max(m_blocks - m_first, 0);
  const int n_iter = group * n_mb;  // (query head, query tile) steps

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(kv_full, 2 * L::KV);
      tma_load_tile<D, KV_ROWS>(sK, &tm_k, kv_full, kvh, n0, b);
      tma_load_tile<D, KV_ROWS>(sV, &tm_v, kv_full, kvh, n0, b);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int h = kvh * group + it / n_mb;
        const int m0 = (m_first + it % n_mb) * BM;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t st = sRing + s * L::STAGE;
        const uint32_t stat = base + L::STATS + s * L::STAT;
        const int row = (((b * H) + h) * Sq + m0) & ~3;  // of the (B, H, Sq) statistics
        mbar_expect_tx(full + 8 * s, L::STAGE + 2 * STAT_BOX * 4);
        tma_load_tile<D, BM>(st, &tm_q, full + 8 * s, h, m0, b);
        tma_load_tile<D, BM>(st + L::TILE, &tm_do, full + 8 * s, h, m0, b);
        tma_load_1d(stat, &tm_lse, full + 8 * s, row);
        tma_load_1d(stat + STAT_ROW * 4, &tm_delta, full + 8 * s, row);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_lo = n0 + warp * 16 + g;  // this thread's keys: key_lo, key_lo + 8
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int h = kvh * group + it / n_mb;
    const int m0 = (m_first + it % n_mb) * BM;
    const uint32_t sQ = sRing + s * L::STAGE;
    const uint32_t sdO = sQ + L::TILE;
    // the tile's lse (warpgroup 0) or delta (warpgroup 1), BM values; rows
    // past Sq hold the next head's values or zeros, and are masked
    const float* stat = reinterpret_cast<const float*>(smem + L::STATS + s * L::STAT) +
                        wg * STAT_ROW + ((((b * H) + h) * Sq + m0) & 3);
    mbar_wait(full + 8 * s, (it / STAGES) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 keys x
    // BM queries
    float st[BM / 2];
    const uint32_t sA = wg == 0 ? sK : sV;
    const uint32_t sB = wg == 0 ? sQ : sdO;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wgmma_ss<BM, 0>(st, desc_k<KV_ROWS>(sA, 0, kk), desc_k<BM>(sB, 0, kk), kk > 0);
    }
    wgmma_commit();
    // this thread's queries are m0 + 8 * j + 2 * t + (e & 1)
    float2 stat_v[BM / 8];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      stat_v[j] = make_float2(stat[8 * j + 2 * t], stat[8 * j + 2 * t + 1]);
    }
    wgmma_wait<0>();
    fence_regs(st);

    uint32_t a[BM / 16][4];
    if (wg == 0) {
      // P^T = exp(S^T * scale - lse), exactly 0 where masked
      const bool masked = m0 + BM > Sq || n0 + KV_ROWS > Sk || (causal && n0 + KV_ROWS - 1 > m0);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_l2 = ((e & 1) ? stat_v[j].y : stat_v[j].x) * LOG2E;
          float p = exp2f(st[4 * j + e] * scale_log2 - lse_l2);
          if (masked) {
            const int key = key_lo + 8 * (e >> 1);
            const int qi = m0 + 8 * j + 2 * t + (e & 1);
            if (qi >= Sq || key >= Sk || (causal && key > qi)) p = 0.f;
          }
          st[4 * j + e] = p;
        }
      }
      if (it > 0) bar_sync(BAR_P_FREE, CONSUMERS);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) xbuf[i * 128 + tid] = st[i];
      bar_arrive(BAR_P_READY, CONSUMERS);
    } else {
      // dS^T = P^T * (dP^T - delta), with warpgroup 0's P^T
      bar_sync(BAR_P_READY, CONSUMERS);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          st[i] = xbuf[i * 128 + tid] * (st[i] - ((e & 1) ? stat_v[j].y : stat_v[j].x));
        }
      }
      if (it + 1 < n_iter) bar_arrive(BAR_P_FREE, CONSUMERS);
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
#pragma unroll
    for (int c = 0; c < BM / 16; ++c) acc_to_a(a[c], st, c);
    const uint32_t sC = wg == 0 ? sdO : sQ;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BM / 16; ++c) wgmma_rs<D, 1>(acc, a[c], desc_mn<BM>(sC, 16 * c), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

  const long kv_stride = (long)KV * D;
  bf16* out = (wg == 0 ? dv : dk) + (long)b * Sk * kv_stride + (long)kvh * D;
  store_rows<D>(out, kv_stride, acc, key_lo, Sk, t, wg == 0 ? 1.f : scale);
}

template <int D, int BN>
struct DqSmem {
  static constexpr int Q = Q_ROWS * D * 2;  // one of Q, dO
  static constexpr int TILE = BN * D * 2;   // one of K, V
  static constexpr int K = 2 * Q;                     // K stages
  static constexpr int V = K + DQ_K_STAGES * TILE;    // V stages
  static constexpr int BARS = V + STAGES * TILE;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 2 * DQ_K_STAGES + 2 * STAGES);
};

template <int D, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
                        float scale) {
  using L = DqSmem<D, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + L::Q;
  const uint32_t q_full = base + L::BARS;
  const uint32_t full_k = q_full + 8;  // + 8 * stage
  const uint32_t empty_k = full_k + 8 * DQ_K_STAGES;
  const uint32_t full_v = empty_k + 8 * DQ_K_STAGES;
  const uint32_t empty_v = full_v + 8 * STAGES;

  // the heaviest causal tiles (last queries) start first
  const int m0 = (gridDim.x - 1 - blockIdx.x) * Q_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int n_end = causal ? min(Sk, m0 + Q_ROWS) : Sk;
  const int n_tiles = (n_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_K_STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, 2 * L::Q);
      tma_load_tile<D, Q_ROWS>(sQ, &tm_q, q_full, h, m0, b);
      tma_load_tile<D, Q_ROWS>(sdO, &tm_do, q_full, h, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int sk = it % DQ_K_STAGES, sv = it % STAGES;
        if (it >= DQ_K_STAGES) mbar_wait(empty_k + 8 * sk, ((it / DQ_K_STAGES) - 1) & 1);
        mbar_expect_tx(full_k + 8 * sk, L::TILE);
        tma_load_tile<D, BN>(base + L::K + sk * L::TILE, &tm_k, full_k + 8 * sk, kvh, it * BN, b);
        if (it >= STAGES) mbar_wait(empty_v + 8 * sv, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full_v + 8 * sv, L::TILE);
        tma_load_tile<D, BN>(base + L::V + sv * L::TILE, &tm_v, full_v + 8 * sv, kvh, it * BN, b);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_m0 = m0 + wg * 64;
  const int row_lo = wg_m0 + warp * 16 + g;  // this thread's rows: row_lo, row_lo + 8
  // causal: the warpgroup computes only the tiles that reach its rows
  const int n_act = causal ? (min(Sk, wg_m0 + 64) + BN - 1) / BN : n_tiles;
  const float scale_log2 = scale * LOG2E;

  // lse (log2 domain) and delta of this thread's rows
  float row_l[2], row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const long idx = ((long)b * H + h) * Sq + row;
    row_l[r] = row < Sq ? lse[idx] * LOG2E : 0.f;
    row_d[r] = row < Sq ? delta[idx] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];
  uint32_t pa[BN / 16][4];

  // As in the forward kernel: iteration it issues S_it = Q K_it^T and
  // dP_it = dO V_it^T together with dQ += dS_{it-1} K_{it-1}, and computes
  // dS_it while that product is in flight; the warpgroups take turns to
  // issue, and every wgmma is issued from straight-line code. K is read
  // last (by dQ), so its ring has a third stage.
  auto turn_begin = [&]() { bar_sync(BAR_TURN + wg, CONSUMERS); };
  auto turn_end = [&](bool last) {
    if (wg == 0 || !last) bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
  };
  auto issue_sdp = [&](int it) {
    const int sk = it % DQ_K_STAGES, sv = it % STAGES;
    const uint32_t sK = base + L::K + sk * L::TILE;
    const uint32_t sV = base + L::V + sv * L::TILE;
    mbar_wait(full_k + 8 * sk, (it / DQ_K_STAGES) & 1);
    mbar_wait(full_v + 8 * sv, (it / STAGES) & 1);
    // derived anew each tile: the 2 x D / 16 descriptors of Q and dO, kept
    // in registers across the loop, would spill at head_dim 256
    uint64_t q_desc = desc_k<Q_ROWS>(sQ, wg * 64, 0), do_desc = desc_k<Q_ROWS>(sdO, wg * 64, 0);
    opaque(q_desc);
    opaque(do_desc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wgmma_ss<BN, 0>(sc, q_desc + k_step<Q_ROWS>(kk), desc_k<BN>(sK, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wgmma_ss<BN, 0>(dp, do_desc + k_step<Q_ROWS>(kk), desc_k<BN>(sV, 0, kk), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_dq = [&](int it) {
    const uint32_t sK = base + L::K + (it % DQ_K_STAGES) * L::TILE;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs<D, 1>(acc, pa[c], desc_mn<BN>(sK, 16 * c), 1);
    wgmma_commit();
  };
  // dS = P * (dP - delta), P exactly 0 where masked, left in sc (fp32)
  auto grad = [&](int it) {
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(empty_v + 8 * (it % STAGES));
    const int n0 = it * BN;
    const bool masked = wg_m0 + 64 > Sq || n0 + BN > Sk || (causal && n0 + BN - 1 > wg_m0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(sc[4 * j + e] * scale_log2 - row_l[r]);
        if (masked) {
          const int row = row_lo + 8 * r;
          const int col = n0 + 8 * j + 2 * t + (e & 1);
          if (row >= Sq || col >= Sk || (causal && col > row)) p = 0.f;
        }
        sc[4 * j + e] = p * (dp[4 * j + e] - row_d[r]);
      }
    }
  };
  auto dq_done = [&](int it) {
    fence_regs(acc);
    mbar_arrive(empty_k + 8 * (it % DQ_K_STAGES));
  };
  auto pack_ds = [&]() {
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) acc_to_a(pa[c], sc, c);
  };

  mbar_wait(q_full, 0);
  if (wg == 1) bar_arrive(BAR_TURN + 0, CONSUMERS);
  turn_begin();
  issue_sdp(0);
  turn_end(false);
  wgmma_wait<0>();
  grad(0);
  pack_ds();
  for (int it = 1; it < n_act; ++it) {
    turn_begin();
    issue_sdp(it);
    issue_dq(it - 1);
    turn_end(false);
    wgmma_wait<1>();
    grad(it);
    wgmma_wait<0>();
    dq_done(it - 1);
    pack_ds();
  }
  turn_begin();
  issue_dq(n_act - 1);
  turn_end(n_act == n_tiles);
  wgmma_wait<0>();
  dq_done(n_act - 1);
  // causal tiles past this warpgroup's rows: release them, take the turns
  for (int it = n_act; it < n_tiles; ++it) {
    mbar_wait(full_k + 8 * (it % DQ_K_STAGES), (it / DQ_K_STAGES) & 1);
    mbar_arrive(empty_k + 8 * (it % DQ_K_STAGES));
    mbar_wait(full_v + 8 * (it % STAGES), (it / STAGES) & 1);
    mbar_arrive(empty_v + 8 * (it % STAGES));
    turn_begin();
    turn_end(it + 1 == n_tiles);
  }

  const long q_stride = (long)H * D;
  store_rows<D>(dq + (long)b * Sq * q_stride + (long)h * D, q_stride, acc, row_lo, Sq, t, scale);
}

// BN: keys per step of the dQ kernel.
template <int D, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int causal, float scale, cudaStream_t stream) {
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const long rows = (long)B * Sq * H;
  constexpr int DELTA_WARPS = 8;
  bwd_delta_kernel<<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS), DELTA_WARPS * 32, 0,
                     stream>>>(static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                               delta_, Sq, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  err = encode_bshd(&tm_q, q, B, Sq, H, D, KV_BM);
  if (err == cudaSuccess) err = encode_f32_1d(&tm_lse, lse, rows, STAT_BOX);
  if (err == cudaSuccess) err = encode_f32_1d(&tm_delta, delta, rows, STAT_BOX);
  if (err == cudaSuccess) err = encode_bshd(&tm_do, dout, B, Sq, H, D, KV_BM);
  if (err == cudaSuccess) err = encode_bshd(&tm_k, k, B, Sk, KV, D, KV_ROWS);
  if (err == cudaSuccess) err = encode_bshd(&tm_v, v, B, Sk, KV, D, KV_ROWS);
  if (err != cudaSuccess) return err;
  constexpr int smem_kv = DkvSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((Sk + KV_ROWS - 1) / KV_ROWS, KV, B);
  flash_bwd_dkv_kernel<D><<<grid_kv, THREADS, smem_kv, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Sq, Sk, H, KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = encode_bshd(&tm_q, q, B, Sq, H, D, Q_ROWS);
  if (err == cudaSuccess) err = encode_bshd(&tm_do, dout, B, Sq, H, D, Q_ROWS);
  if (err == cudaSuccess) err = encode_bshd(&tm_k, k, B, Sk, KV, D, BN);
  if (err == cudaSuccess) err = encode_bshd(&tm_v, v, B, Sk, KV, D, BN);
  if (err != cudaSuccess) return err;
  constexpr int smem_q = DqSmem<D, BN>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Sq + Q_ROWS - 1) / Q_ROWS, H, B);
  flash_bwd_dq_kernel<D, BN><<<grid_q, THREADS, smem_q, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse_, delta_, static_cast<bf16*>(dq), Sq, Sk, H, KV, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// delta is fp32 scratch of (B, H, Sq) elements that the caller allocates.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                                   int D, int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, H, KV,
                                 causal, scale, s);
    case 128:
      return (int)launch<128, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, H, KV,
                                  causal, scale, s);
    case 256:
      return (int)launch<256, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, H, KV,
                                  causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
