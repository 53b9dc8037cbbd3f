// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation and fp32 softmax statistics.
//
// Replaces: the Pallas TPU kernel that ray_tpu/ops/attention.py `_flash`
// calls, jax.experimental.pallas.ops.tpu.flash_attention.flash_attention
// (its forward pallas_call, flash_attention.py:758). Same function: exact
// softmax(Q K^T / sqrt(d) [+ causal mask]) V, computed as an online softmax
// over K/V tiles, plus the log-sum-exp of the scaled scores per query row.
//
// What bounds it on this card: at prefill lengths attention does about
// S/2 (causal) multiply-adds per byte of Q/K/V it reads, far above the
// H100's ~295 operations per byte, so the tensor cores bound it: at
// B=1, S=2048, causal, 4.3e10 operations (Llama, H=32, Hd=128, and GPT-J,
// H=16, Hd=256, alike) take 0.0348 ms at 989 TFLOP/s. The scores never
// reach device memory (online softmax in registers).
//
// Design. One CTA per (128-query tile, head, batch), the heaviest causal
// tiles (last queries) first; 384 threads: two consumer warpgroups of 64
// query rows each and one producer warpgroup, which gives its registers
// to the consumers (setmaxnreg: 24 a thread for the producer, 240 for the
// consumers).
//   - One producer thread loads the Q tile once and streams K and V tiles
//     through 2-stage rings in shared memory with TMA (cp.async.bulk.tensor,
//     128-byte swizzle). K and V have rings of their own, each stage guarded
//     by a "full" mbarrier (bytes landed) and an "empty" one (all 256
//     consumer threads done), so tiles are in flight while others are
//     multiplied. TMA reads rows past the sequence as zeros.
//   - Each consumer warpgroup runs S = Q K^T as wgmma m64nBNk16 with both
//     operands from shared memory (K-major descriptors), the online softmax
//     on the accumulators, and O += P V as wgmma m64nDk16 with P from
//     registers (the accumulator layout is the A-operand layout) and V read
//     MN-major through the descriptor's transpose bit.
//   - Overlap, as in FlashAttention-3: a warpgroup issues S for tile j and
//     P V for tile j - 1 together, and runs tile j's softmax while P V is
//     in flight; the two warpgroups take turns to issue (two named
//     barriers), so one's softmax runs under the other's products. Without
//     the turns both warpgroups wait on the same barriers and do their
//     softmax at the same time, leaving the tensor cores idle. Every wgmma
//     is issued from straight-line code: one issued under a branch makes
//     ptxas serialize them all (its C7518 note).
//   - A warpgroup skips the causal tiles that lie wholly above its rows.
//   - Registers: O is D/2 floats a thread, S BN/2 and P BN/4, so BN is 128
//     at head_dim 64/128 and 64 at 256 (GPT-J).
// Shared memory per CTA: Q 128 x D and two stages each of K and V (BN x D),
// plus 1 KB for alignment and the barriers: 81 / 161 / 193 KB at head_dim
// 64 / 128 / 256, so one CTA per SM. `nvcc -Xptxas -v` (sm_90a, CUDA 12.8)
// for each of the three: 168 registers a thread at launch (384 threads;
// setmaxnreg then moves them as above), 0 bytes spilled.
//
// Layout: BSHD. q/o (B, Sq, H, D), k/v (B, Sk, KV, D), all contiguous and
// 16-byte aligned; lse (B, H, Sq) fp32, natural log. Grouped-query
// attention reads kv head h / (H / KV) directly, with no repeated copy.
// Causal masking is top-left aligned (query i sees keys 0..i). Ragged
// tails: keys at or past Sk score -1e30, rows at or past Sq are not
// written.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_M = 128;  // query rows per CTA: 2 warpgroups x 64
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 2 x 128 x 240 + 128 x 24 = 64,512 of 65,536
constexpr int BAR_TURN = 1;  // named barriers 1, 2: the warpgroups' turns to issue
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, int BN>
struct Smem {
  static constexpr int Q = BLOCK_M * D * 2;
  static constexpr int TILE = BN * D * 2;  // one K or V tile
  static constexpr int K = Q;                        // K stages
  static constexpr int V = K + STAGES * TILE;        // V stages
  static constexpr int BARS = V + STAGES * TILE;
  static constexpr int BYTES = 1024 + BARS + 8 * (1 + 4 * STAGES);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
                     float scale) {
  using L = Smem<D, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t q_full = base + L::BARS;
  const uint32_t full_k = q_full + 8;              // + 8 * stage
  const uint32_t empty_k = full_k + 8 * STAGES;
  const uint32_t full_v = empty_k + 8 * STAGES;
  const uint32_t empty_v = full_v + 8 * STAGES;

  // the heaviest causal tiles (last queries) start first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int m0 = m_block * BLOCK_M;
  const int n_end = causal ? min(Sk, m0 + BLOCK_M) : Sk;
  const int n_tiles = (n_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, L::Q);
      tma_load_tile<D, BLOCK_M>(sQ, &tm_q, q_full, h, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t parity = ((it / STAGES) - 1) & 1;
        if (it >= STAGES) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, L::TILE);
        tma_load_tile<D, BN>(base + L::K + s * L::TILE, &tm_k, full_k + 8 * s, kvh, it * BN, b);
        if (it >= STAGES) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, L::TILE);
        tma_load_tile<D, BN>(base + L::V + s * L::TILE, &tm_v, full_v + 8 * s, kvh, it * BN, b);
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
  const int wg_m0 = m0 + wg * 64;             // this warpgroup's first row
  const int row_lo = wg_m0 + warp * 16 + g;   // and this thread's rows: row_lo, row_lo + 8
  // causal: the warpgroup computes only the tiles that reach its rows
  const int n_act = causal ? (min(Sk, wg_m0 + 64) + BN - 1) / BN : n_tiles;
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float row_m[2] = {NEG_INF, NEG_INF};  // running max of the scaled scores (log2 domain)
  float row_l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float corr[2] = {0.f, 0.f};
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];

  // Iteration it issues S_it = Q K_it^T and O += P_{it-1} V_{it-1}, then
  // runs tile it's softmax while the P V product is in flight. The two
  // warpgroups take turns to issue (named barriers BAR_TURN + wg), so one
  // warpgroup's softmax overlaps the other's products; both take
  // n_tiles + 1 turns. Every wgmma is issued from straight-line code (a
  // wgmma under a branch makes ptxas serialize them all).
  auto turn_begin = [&]() { bar_sync(BAR_TURN + wg, CONSUMERS); };
  auto turn_end = [&](bool last) {
    if (wg == 0 || !last) bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
  };
  auto issue_s = [&](int it) {
    const uint32_t sK = base + L::K + (it % STAGES) * L::TILE;
    mbar_wait(full_k + 8 * (it % STAGES), (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wgmma_ss<BN, 0>(sc, desc_k<BLOCK_M>(sQ, wg * 64, kk), desc_k<BN>(sK, 0, kk), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int it) {
    const uint32_t sV = base + L::V + (it % STAGES) * L::TILE;
    mbar_wait(full_v + 8 * (it % STAGES), (it / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) wgmma_rs<D, 1>(acc, pa[c], desc_mn<BN>(sV, 16 * c), 1);
    wgmma_commit();
  };
  // mask, the new running max, P = exp2(S * scale * log2(e) - max), and P
  // in fp32 left in sc
  auto softmax = [&](int it) {
    fence_regs(sc);
    mbar_arrive(empty_k + 8 * (it % STAGES));
    const int n0 = it * BN;
    const bool masked = n0 + BN > Sk || (causal && n0 + BN - 1 > wg_m0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (masked) {
          const int col = n0 + 8 * j + 2 * t + (e & 1);
          if (col >= Sk || (causal && col > row_lo + 8 * r)) sc[4 * j + e] = NEG_INF;
        }
        mx[r] = fmaxf(mx[r], sc[4 * j + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is in every row's first tile, so from then on the max is a
      // real score and masked entries give exp2(-1e30 * c - max) = 0
      const float m_new = fmaxf(row_m[r], mx[r] * scale_log2);
      corr[r] = ex2(row_m[r] - m_new);
      row_m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[4 * j + e], scale_log2, -row_m[e >> 1]));
        sc[4 * j + e] = p;
        rs[e >> 1] += p;
      }
    }
    row_l[0] = row_l[0] * corr[0] + rs[0];
    row_l[1] = row_l[1] * corr[1] + rs[1];
  };
  auto pv_done = [&](int it) {
    fence_regs(acc);
    mbar_arrive(empty_v + 8 * (it % STAGES));
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) acc_to_a(pa[c], sc, c);
  };

  mbar_wait(q_full, 0);
  if (wg == 1) bar_arrive(BAR_TURN + 0, CONSUMERS);
  turn_begin();
  issue_s(0);
  turn_end(false);
  wgmma_wait<0>();
  softmax(0);
  pack_p();
  for (int it = 1; it < n_act; ++it) {
    turn_begin();
    issue_s(it);
    issue_pv(it - 1);
    turn_end(false);
    wgmma_wait<1>();
    softmax(it);
    wgmma_wait<0>();
    pv_done(it - 1);
    pack_p();
  }
  turn_begin();
  issue_pv(n_act - 1);
  turn_end(n_act == n_tiles);
  wgmma_wait<0>();
  pv_done(n_act - 1);
  // causal tiles past this warpgroup's rows: release them, take the turns
  for (int it = n_act; it < n_tiles; ++it) {
    mbar_wait(full_k + 8 * (it % STAGES), (it / STAGES) & 1);
    mbar_arrive(empty_k + 8 * (it % STAGES));
    mbar_wait(full_v + 8 * (it % STAGES), (it / STAGES) & 1);
    mbar_arrive(empty_v + 8 * (it % STAGES));
    turn_begin();
    turn_end(it + 1 == n_tiles);
  }

  // epilogue: normalise, store O and the natural-log LSE
  const long q_stride = (long)H * D;
  bf16* ob = o + (long)b * Sq * q_stride + (long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_lo + 8 * r;
    if (row >= Sq) continue;
    const float inv_l = 1.f / l;
    bf16* orow = ob + (long)row * q_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * inv_l, acc[4 * j + 2 * r + 1] * inv_l);
    }
    if (t == 0) lse[((long)b * H + h) * Sq + row] = (row_m[r] + log2f(l)) * LN2;
  }
}

template <int D, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
                   int Sk, int H, int KV, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_bshd(&tm_q, q, B, Sq, H, D, BLOCK_M);
  if (err == cudaSuccess) err = encode_bshd(&tm_k, k, B, Sk, KV, D, BN);
  if (err == cudaSuccess) err = encode_bshd(&tm_v, v, B, Sk, KV, D, BN);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<D, BN>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H, B);
  flash_fwd_kernel<D, BN><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, KV, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Sk, int H, int KV, int D,
                                   int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, s);
    case 128:
      return (int)launch<128, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, s);
    case 256:
      return (int)launch<256, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
