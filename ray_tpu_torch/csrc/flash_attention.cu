// Flash-attention forward for Hopper (sm_90a), bf16 in and out, fp32
// accumulation and fp32 softmax statistics.
//
// Replaces: the Pallas TPU kernel that ray_tpu/ops/attention.py `_flash`
// calls, jax.experimental.pallas.ops.tpu.flash_attention.flash_attention
// (its forward pallas_call). Same function: exact softmax(Q K^T / sqrt(d)
// [+ causal mask]) V, computed as an online softmax over K/V tiles, plus
// the log-sum-exp of the scaled scores per query row.
//
// What bounds it on this card: at prefill lengths (S >= 512) attention does
// about S/2 (causal) multiply-adds per byte of Q/K/V it must read, far
// above the H100's ~295 operations per byte, so it is bound by the tensor
// cores, not by memory. The design therefore keeps the S x S scores out of
// device memory entirely (online softmax in registers) and feeds the
// tensor cores with mma.sync m16n8k16 bf16 products from shared memory.
// The TPU kernel's sequential grid, which carries the running max and sum
// from one grid step to the next, becomes a loop over K/V tiles inside one
// CTA: CTAs run in parallel on the 132 SMs and carry nothing between them.
//
// Layout: BSHD. q/o (B, Sq, H, D), k/v (B, Sk, KV, D), all contiguous;
// lse (B, H, Sq) fp32. Grouped-query attention reads kv head h / (H / KV)
// directly, with no repeated copy. Causal masking is top-left aligned
// (query i sees keys 0..i). Ragged sequence tails are masked in the kernel:
// out-of-range rows load as zeros and out-of-range keys score -1e30.
//
// Design (simple and right first; wgmma/TMA and cp.async pipelining are
// later work): one CTA of 4 warps per (64-query tile, head, batch). The Q
// tile stays in shared memory; 64-key K and V tiles are streamed through
// shared memory. Each warp owns 16 query rows: S = Q K^T with mma.sync,
// the running max/sum per row in registers, P cast to bf16 and fed straight
// from the S accumulators as the A operand of O += P V. Shared-memory rows
// are padded by 8 elements so that the fragment loads hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per CTA: 4 warps x 16
constexpr int BLOCK_N = 64;  // keys per inner step
constexpr int NUM_WARPS = 4;
constexpr int THREADS = NUM_WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// Rows [row0, row0 + ROWS) of one head of a (S, heads, D) tensor into a
// padded shared tile; rows at or past n_rows are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, int row0, int n_rows,
                                          long row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int STRIDE = D + 8;
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(g + (long)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(smem + r * STRIDE + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int H, int KV, int causal, float scale) {
  constexpr int STRIDE = D + 8;
  constexpr int NT = BLOCK_N / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;        // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BLOCK_M * STRIDE;
  bf16* sV = sK + BLOCK_N * STRIDE;

  // the heaviest causal tiles (last queries) start first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int m0 = m_block * BLOCK_M;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;
  bf16* ob = o + (long)b * Sq * q_stride + (long)h * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int wrow = warp * 16;

  load_tile<D, BLOCK_M>(sQ, qb, m0, Sq, q_stride);

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // running max (log2 domain) and sum for rows g and g + 8 of this warp
  float row_m[2] = {NEG_INF, NEG_INF};
  float row_l[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;
  const int n_end = causal ? min(Sk, m0 + BLOCK_M) : Sk;

  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BLOCK_N>(sK, kb, n0, Sk, kv_stride);
    load_tile<D, BLOCK_N>(sV, vb, n0, Sk, kv_stride);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      const bf16* qa = sQ + (wrow + g) * STRIDE + kk + 2 * t;
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * STRIDE);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * STRIDE + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bk[2];
        const bf16* kp = sK + (nt * 8 + g) * STRIDE + kk + 2 * t;
        bk[0] = *reinterpret_cast<const uint32_t*>(kp);
        bk[1] = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_bf16(s[nt], a, bk);
      }
    }

    // scale, mask, and the new running max
    float mx[2] = {row_m[0], row_m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int col = n0 + nt * 8 + 2 * t + (j & 1);
        const int row = m0 + wrow + g + 8 * r;
        float x = s[nt][j] * scale_log2;
        if (col >= Sk || (causal && col > row)) x = NEG_INF;
        s[nt][j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is visible to every row, so after the first tile mx is a real
      // score and masked entries below give exp2(-1e30 - mx) = 0
      corr[r] = exp2f(row_m[r] - mx[r]);
      row_m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[nt][j] - row_m[j >> 1]);
        s[nt][j] = p;
        rs[j >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      row_l[r] = row_l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: the S accumulators of two 8-key tiles are the A operand of
    // one 16-key step
#pragma unroll
    for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* vp = sV + (kc * 16 + 2 * t) * STRIDE + dt * 8 + g;
        uint32_t bv[2];
        bv[0] = pack_bf16(vp[0], vp[STRIDE]);
        bv[1] = pack_bf16(vp[8 * STRIDE], vp[9 * STRIDE]);
        mma_bf16(acc[dt], a, bv);
      }
    }
  }

  // epilogue: normalise, store O and the natural-log LSE
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wrow + g + 8 * r;
    if (row >= Sq) continue;
    const float inv_l = 1.f / row_l[r];
    bf16* orow = ob + (long)row * q_stride;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r] * inv_l, acc[dt][2 * r + 1] * inv_l);
    }
    if (t == 0) {
      lse[((long)b * H + h) * Sq + row] = (row_m[r] + log2f(row_l[r])) * LN2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
                   int Sk, int H, int KV, int causal, float scale, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, KV, causal, scale);
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
      return (int)launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, s);
    case 256:
      return (int)launch<256>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
