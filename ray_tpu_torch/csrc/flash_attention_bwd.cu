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
// above the H100's ~295 operations per byte, so it is bound by the tensor
// cores. The design keeps P, dP and dS out of device memory: each lives in
// mma.sync accumulators, and is repacked in registers as the bf16 A operand
// of the next product, as the forward does with P.
//
// Translation: the TPU kernel carries its dK/dV and dQ sums across
// sequential grid steps in scratch memory. CTAs on Hopper run in parallel
// and carry nothing, so each sum is a loop inside one CTA, and the two sums
// are two kernels, as on the TPU:
//   1. delta: D[b, h, i] = sum_d dO * O in fp32, one warp per row;
//   2. dK/dV: one CTA per (64-key tile, kv head, batch) loops over the
//      query heads of its grouped-query group and over the query tiles that
//      can see its keys (causal: the diagonal tile and below), holding the
//      tile's dK and dV in registers; the group's sum needs no atomics;
//   3. dQ: one CTA per (64-query tile, head, batch) loops over the key
//      tiles up to the diagonal, holding dQ in registers.
// No atomics anywhere: the gradients are the same bits from run to run.
//
// Layout: BSHD. q/o/dO/dQ (B, Sq, H, D), k/v/dK/dV (B, Sk, KV, D), all
// contiguous; lse and delta (B, H, Sq) fp32, lse in natural log as the
// forward writes it. Causal masking is top-left aligned (query i sees keys
// 0..i). Ragged tails: out-of-range rows load as zeros, their P is set to
// exactly 0, and no row past Sq or Sk is written.
//
// Head_dim 256 (GPT-J): a warp's fp32 dK and dV for 16 keys x 256 columns
// would take 256 registers a thread. The dK/dV kernel therefore runs 8
// warps there, two per 16-key row group, each holding half of the columns
// (both recompute the group's S^T and dP^T), and takes 32-query tiles; the
// dQ kernel takes 32-key tiles. `nvcc -Xptxas -v` for sm_90a (CUDA 12.8),
// registers per thread with no spills: dK/dV 168 / 252 / 232 and dQ 126 /
// 164 / 240 at head_dim 64 / 128 / 256, delta 26. Dynamic shared memory per
// CTA: dK/dV 37.4 / 70.1 / 101.6 KB, dQ 36.9 / 69.6 / 101.4 KB; the limit
// is set per launch. Shared rows are padded by 8 elements against bank
// conflicts.
//
// Simple and right first: no cp.async/TMA overlap, no wgmma, scalar
// fragment loads for the transposed operands. Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_N_KV = 64;  // keys per dK/dV CTA: 4 row groups of 16
constexpr int BLOCK_M_Q = 64;   // queries per dQ CTA: 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

// c += a (16x16, row-major) * b (16x8, column-major), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows [row0, row0 + 16) x columns [kk, kk + 16) of a padded
// row-major shared tile.
template <int STRIDE>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int row0, int kk, int g,
                                       int t) {
  const bf16* p = s + (row0 + g) * STRIDE + kk + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * STRIDE);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * STRIDE + 8);
}

// B fragment with B[k][n] = T[n0 + n][kk + k]: the tile's rows are B's
// columns (contiguous pairs).
template <int STRIDE>
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const bf16* s, int n0, int kk, int g,
                                            int t) {
  const bf16* p = s + (n0 + g) * STRIDE + kk + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = T[k0 + k][n0 + n]: the tile's rows are B's rows
// (pairs from two rows).
template <int STRIDE>
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const bf16* s, int k0, int n0, int g,
                                            int t) {
  const bf16* p = s + (k0 + 2 * t) * STRIDE + n0 + g;
  b[0] = pack_bf16(p[0], p[STRIDE]);
  b[1] = pack_bf16(p[8 * STRIDE], p[9 * STRIDE]);
}

// Rows [row0, row0 + ROWS) of one head of a (S, heads, D) tensor into a
// padded shared tile; rows at or past n_rows are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, int row0, int n_rows,
                                          long row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int STRIDE = D + 8;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(g + (long)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(smem + r * STRIDE + col) = val;
  }
}

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

// dK, dV of one 64-key tile of one kv head. Warp w owns key rows
// 16 * (w % 4) .. +16 and accumulator columns (w / 4) * D / DS .. + D / DS.
template <int D, int BM, int DS>
__global__ void __launch_bounds__(128 * DS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                         int KV, int causal, float scale) {
  constexpr int BN = BLOCK_N_KV;
  constexpr int STRIDE = D + 8;
  constexpr int DW = D / DS;  // accumulator columns per warp
  constexpr int MT = BM / 8;  // 8-query column tiles of S^T
  constexpr int DT = DW / 8;  // 8-wide column tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * STRIDE;
  bf16* sQ = sV + BN * STRIDE;
  bf16* sdO = sQ + BM * STRIDE;
  float* sL = reinterpret_cast<float*>(sdO + BM * STRIDE);  // lse * log2(e)
  float* sD = sL + BM;                                      // delta

  const int n0 = blockIdx.x * BN;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int wrow = (warp % 4) * 16;
  const int dcol = (warp / 4) * DW;
  const float scale_log2 = scale * LOG2E;

  load_tile<D, BN>(sK, kb, n0, Sk, kv_stride);
  load_tile<D, BN>(sV, vb, n0, Sk, kv_stride);

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  const int m_first = causal ? n0 / BM : 0;  // first query tile that sees key n0
  const int m_blocks = (Sq + BM - 1) / BM;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const bf16* qb = q + (long)b * Sq * q_stride + (long)h * D;
    const bf16* dob = dout + (long)b * Sq * q_stride + (long)h * D;
    const float* lseb = lse + ((long)b * H + h) * Sq;
    const float* deltab = delta + ((long)b * H + h) * Sq;
    for (int mb = m_first; mb < m_blocks; ++mb) {
      const int m0 = mb * BM;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D, BM>(sQ, qb, m0, Sq, q_stride);
      load_tile<D, BM>(sdO, dob, m0, Sq, q_stride);
      for (int i = threadIdx.x; i < BM; i += blockDim.x) {
        const bool in = m0 + i < Sq;
        sL[i] = in ? lseb[m0 + i] * LOG2E : 0.f;
        sD[i] = in ? deltab[m0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BM queries
      float s[MT][4], dp[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        load_a<STRIDE>(ak, sK, wrow, kk, g, t);
        load_a<STRIDE>(av, sV, wrow, kk, g, t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t bq[2], bo[2];
          load_b_rows<STRIDE>(bq, sQ, mt * 8, kk, g, t);
          mma_bf16(s[mt], ak, bq);
          load_b_rows<STRIDE>(bo, sdO, mt * 8, kk, g, t);
          mma_bf16(dp[mt], av, bo);
        }
      }

      // P^T = exp(S^T * scale - lse), exactly 0 where masked; dS^T in dp
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = n0 + wrow + g + 8 * (j >> 1);
          const int qi = mt * 8 + 2 * t + (j & 1);
          const int row = m0 + qi;
          float p = exp2f(s[mt][j] * scale_log2 - sL[qi]);
          if (row >= Sq || key >= Sk || (causal && key > row)) p = 0.f;
          s[mt][j] = p;
          dp[mt][j] = p * (dp[mt][j] - sD[qi]);
        }
      }

      // dV += P^T dO and dK += dS^T Q over this warp's columns: the
      // accumulators of two 8-query tiles are the A operand of one
      // 16-query step
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc) {
        uint32_t ap[4], ads[4];
        ap[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
        ap[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
        ap[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        ap[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        ads[0] = pack_f32(dp[2 * kc][0], dp[2 * kc][1]);
        ads[1] = pack_f32(dp[2 * kc][2], dp[2 * kc][3]);
        ads[2] = pack_f32(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
        ads[3] = pack_f32(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t bb[2];
          load_b_cols<STRIDE>(bb, sdO, kc * 16, dcol + dt * 8, g, t);
          mma_bf16(dv_acc[dt], ap, bb);
          load_b_cols<STRIDE>(bb, sQ, kc * 16, dcol + dt * 8, g, t);
          mma_bf16(dk_acc[dt], ads, bb);
        }
      }
    }
  }

  // epilogue: rows past Sk are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + wrow + g + 8 * r;
    if (key >= Sk) continue;
    const long off = ((long)b * Sk + key) * kv_stride + (long)kvh * D + dcol;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// dQ of one 64-query tile of one head; each of the 4 warps owns 16 rows.
template <int D, int BN>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
                        float scale) {
  constexpr int BM = BLOCK_M_Q;
  constexpr int STRIDE = D + 8;
  constexpr int NT = BN / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;   // 8-wide column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BM * STRIDE;
  bf16* sK = sdO + BM * STRIDE;
  bf16* sV = sK + BN * STRIDE;

  // the heaviest causal tiles (last queries) start first
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const bf16* dob = dout + (long)b * Sq * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;
  const float scale_log2 = scale * LOG2E;

  load_tile<D, BM>(sQ, qb, m0, Sq, q_stride);
  load_tile<D, BM>(sdO, dob, m0, Sq, q_stride);
  // lse (log2 domain) and delta of rows g and g + 8 of this warp
  float row_l[2], row_d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wrow + g + 8 * r;
    const long idx = ((long)b * H + h) * Sq + row;
    row_l[r] = row < Sq ? lse[idx] * LOG2E : 0.f;
    row_d[r] = row < Sq ? delta[idx] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int n_end = causal ? min(Sk, m0 + BM) : Sk;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BN>(sK, kb, n0, Sk, kv_stride);
    load_tile<D, BN>(sV, vb, n0, Sk, kv_stride);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ao[4];
      load_a<STRIDE>(aq, sQ, wrow, kk, g, t);
      load_a<STRIDE>(ao, sdO, wrow, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bk[2], bv[2];
        load_b_rows<STRIDE>(bk, sK, nt * 8, kk, g, t);
        mma_bf16(s[nt], aq, bk);
        load_b_rows<STRIDE>(bv, sV, nt * 8, kk, g, t);
        mma_bf16(dp[nt], ao, bv);
      }
    }

    // dS = P * (dP - delta), P exactly 0 where masked; kept in s
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int row = m0 + wrow + g + 8 * r;
        const int col = n0 + nt * 8 + 2 * t + (j & 1);
        float p = exp2f(s[nt][j] * scale_log2 - row_l[r]);
        if (row >= Sq || col >= Sk || (causal && col > row)) p = 0.f;
        s[nt][j] = p * (dp[nt][j] - row_d[r]);
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bk[2];
        load_b_cols<STRIDE>(bk, sK, kc * 16, dt * 8, g, t);
        mma_bf16(acc[dt], a, bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wrow + g + 8 * r;
    if (row >= Sq) continue;
    bf16* qrow = dq + ((long)b * Sq + row) * q_stride + (long)h * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(qrow + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

// BM: queries per step of the dK/dV kernel; DS: warps per 16-key row group
// there; BN: keys per step of the dQ kernel.
template <int D, int BM, int DS, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int causal, float scale, cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const long rows = (long)B * Sq * H;
  constexpr int DELTA_WARPS = 8;
  bwd_delta_kernel<<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS), DELTA_WARPS * 32, 0,
                     stream>>>(static_cast<const bf16*>(o), do_, delta_, Sq, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_kv =
      (2 * BLOCK_N_KV + 2 * BM) * (D + 8) * (int)sizeof(bf16) + 2 * BM * (int)sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, BM, DS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((Sk + BLOCK_N_KV - 1) / BLOCK_N_KV, KV, B);
  flash_bwd_dkv_kernel<D, BM, DS><<<grid_kv, 128 * DS, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H,
      KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = (2 * BLOCK_M_Q + 2 * BN) * (D + 8) * (int)sizeof(bf16);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Sq + BLOCK_M_Q - 1) / BLOCK_M_Q, H, B);
  flash_bwd_dq_kernel<D, BN><<<grid_q, 128, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dq), Sq, Sk, H, KV, causal, scale);
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
      return (int)launch<64, 64, 1, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, H,
                                        KV, causal, scale, s);
    case 128:
      return (int)launch<128, 64, 1, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, H,
                                         KV, causal, scale, s);
    case 256:
      return (int)launch<256, 32, 2, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq, Sk, H,
                                         KV, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
