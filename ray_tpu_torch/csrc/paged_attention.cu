// Paged-attention decode for Hopper (sm_90a): one query row per sequence
// and query head against that sequence's KV cache, read in place through
// its block table. bf16 in and out; scores, softmax and accumulation fp32.
//
// Replaces: no Pallas kernel. The reference runs this step in XLA:
// ray_tpu/models/generation.py `_forward_paged` builds `gather_idx`, gathers
// every sequence's whole block table into a dense (B, MB * block_size) copy
// on every layer of every step, and runs `_paged_attention`, a masked
// softmax over it. This kernel reads only rows 0..positions[b] of each
// sequence, where they lie in the pool, and makes no copy.
//
// What bounds it: bytes. A query row does 2 multiply-adds per K/V element
// it reads (about 1 operation per byte, times the GQA group), far below
// the H100's ~295 operations per byte, so the least time is the K and V
// rows over 3.35 TB/s. DRAM answers in ~0.7 us, so by Little's law the card
// needs ~2 MB in flight, ~16 KB per SM, to stream at that rate.
//
// Design.
// - Work: one CTA of 4 warps per (group of GB query heads of one KV head,
//   sequence, partition of PARTITION = 256 context tokens). GB is the
//   largest of 8, 4, 2, 1 that divides H / KV: the CTA reads each K and V
//   row once for all GB heads (all of a GQA group of up to 8 heads; a
//   larger group is split over H / KV / GB CTAs). Partitions past the
//   context exit before any load.
// - Partition size: fixed, so that a sequence's arithmetic never depends
//   on its batch neighbours (batch invariance, bitwise). 256 gives every
//   sequence of a decode batch several CTAs per head: 1,600 CTAs of real
//   work at B=8, 32 heads and 11,461 context tokens, 704 at the serving
//   engine's decode step (4,606 tokens), 5-12 per SM, so the grid fills
//   132 SMs with slack for ragged contexts. Smaller partitions would add
//   per-CTA start-up and merge work for parallelism the card does not need.
// - Copies: thread (r, c), r = tid / (D / 8), c = tid % (D / 8), owns the
//   16-byte chunk c of rows r, r + R, ..., R = 128 / (D / 8), of every
//   tile of T = 4R tokens (64 / 32 / 16 tokens at D = 64 / 128 / 256: 8 KB
//   of K or of V). It copies its chunks with cp.async into a 4-stage
//   shared-memory ring and counts its arrival on its warp's mbarrier for
//   the stage (cp.async.mbarrier.arrive), so a warp waits only for its own
//   copies. A thread reads back only what it copied, so refilling a stage
//   needs no barrier. The partition's block-table entries, then its slot
//   numbers, go to shared memory once, before the ring starts. The ring
//   streams the K tiles and then the V tiles; up to 4 x 8 KB = 32 KB are in
//   flight per CTA. A CTA takes 35-44 KB of shared memory and 64-146
//   registers a thread, so 3-6 CTAs fit an SM (6 at GB = 1): up to 96-192
//   KB in flight per SM, well above the ~16 KB that Little's law asks. A
//   deeper ring would only fit fewer CTAs on an SM, and the CTAs beside it
//   are what hide a CTA's start and end, when it streams nothing.
// - Scores: each thread dots its 16-byte chunk of 4 rows with the GB query
//   heads (q in registers, pre-scaled by scale * log2 e), 4 * GB partial
//   sums; one reduce-scatter over the D / 8 lanes of the row (a transposed
//   butterfly: each step halves the values a lane keeps, 5 shuffles for 4
//   rows at D = 128 and GB = 1 where a plain butterfly takes 16) leaves
//   each score on one lane, which writes it to a score buffer in shared
//   memory (PARTITION x GB floats).
// - Softmax: two passes over that buffer, not over device memory: the
//   partition's max per head, then the exponentials and their sum. V then
//   streams through the ring once; each thread accumulates its 8 output
//   dimensions of the GB heads in registers, and the R row groups are
//   summed through shared memory in a fixed order.
// - Merge: a sequence whose context fits one partition writes its
//   normalised output directly. Otherwise each CTA writes its unnormalised
//   output and its (max, sum) to scratch, and the CTA that increments the
//   (sequence, head group)'s counter last merges all partitions in
//   partition order. The merge's arithmetic is the same whichever CTA runs
//   it, so the result does not depend on which CTA finishes first.
//
// Layout: q/out (B, H, D); k/v pool slice of one layer (n_slots, KV, D),
// n_slots = num_blocks * block_size; block_tables (B, max_blocks) int32;
// positions (B,) int32. Grouped-query attention reads kv head h / (H / KV).
// Block indices are clamped into the pool and the context into the table,
// as the reference clamps its gathers. Any block_size is taken.

#include "hopper.cuh"

namespace {

using hopper::bf16;

constexpr int PARTITION = 256;  // tokens per CTA; PARTITION in the wrapper
constexpr int THREADS = 128;
constexpr int NUM_WARPS = THREADS / 32;
constexpr int J = 4;        // rows of a tile per thread
constexpr int STAGES = 4;   // ring depth, in tiles of K or of V
constexpr int MIN_CTAS = 3;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory of one CTA, in bytes from its start.
template <int GB>
struct Smem {
  static constexpr int RING = 0;  // uint4 [STAGES][J][THREADS]; after the loop float [R][GB][D]
  static constexpr int SCORES = STAGES * J * THREADS * 16;   // float [PARTITION][GB]
  static constexpr int SLOTS = SCORES + PARTITION * GB * 4;  // int [PARTITION]
  static constexpr int TABLE = SLOTS + PARTITION * 4;        // int [PARTITION + 1]
  static constexpr int RED = TABLE + (PARTITION + 4) * 4;    // float [2][NUM_WARPS][GB]
  static constexpr int STATS = RED + 2 * NUM_WARPS * GB * 4; // float max[GB], sum[GB]
  static constexpr int FLAG = STATS + 2 * GB * 4;            // int
  static constexpr int BARS = (FLAG + 4 + 7) / 8 * 8;        // mbarrier [STAGES][NUM_WARPS]
  static constexpr int BYTES = BARS + STAGES * NUM_WARPS * 8;
};

__device__ __forceinline__ int context_len(const int* positions, int b, int max_ctx) {
  return min(max(positions[b] + 1, 1), max_ctx);
}

// 8 bf16 (element 0 in the low half of .x) to fp32.
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Reduce-scatter of N values over an aligned group of lanes: MASK runs from
// half the group's width down to 1. While a lane holds more than one value,
// a step keeps half of them (the upper half where the lane's MASK bit is
// set) and adds the partner's copy of that half; then plain butterfly steps
// follow. The lane ends with max(N / width, 1) sums, of indices
// [idx, idx + that).
template <int CUR, int MASK, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane, int& idx) {
  if constexpr (MASK >= 1) {
    if constexpr (CUR > 1) {
      constexpr int HALF = CUR / 2;
      const bool upper = (lane & MASK) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = upper ? v[i] : v[i + HALF];
        const float keep = upper ? v[i + HALF] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
      }
      idx += upper ? HALF : 0;
      reduce_scatter<HALF, MASK / 2>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], MASK);
      reduce_scatter<1, MASK / 2>(v, lane, idx);
    }
  }
}

template <bool IS_MAX>
__device__ __forceinline__ float warp_reduce(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = IS_MAX ? fmaxf(x, y) : x + y;
  }
  return x;
}

template <int D, int GB>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                        const bf16* __restrict__ vpool, const int* __restrict__ block_tables,
                        const int* __restrict__ positions, bf16* __restrict__ out,
                        float* __restrict__ part_o, float* __restrict__ part_ml,
                        int* __restrict__ counters, int H, int KV, int max_blocks,
                        int block_size, int num_blocks, int n_splits, float scale_log2) {
  constexpr int C = D / 8;          // lanes per row, 16 bytes each
  constexpr int R = THREADS / C;    // rows per tile step
  constexpr int T = R * J;          // tokens per tile
  constexpr int N = J * GB;         // partial scores per thread per tile
  static_assert(PARTITION % T == 0, "a partition is whole tiles");
  static_assert(R * GB * D * 4 <= STAGES * J * THREADS * 16, "output sums fit the ring");
  using S = Smem<GB>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem + S::RING);
  float* scores = reinterpret_cast<float*>(smem + S::SCORES);
  int* slots = reinterpret_cast<int*>(smem + S::SLOTS);
  int* table = reinterpret_cast<int*>(smem + S::TABLE);
  float* red = reinterpret_cast<float*>(smem + S::RED);
  float* stats = reinterpret_cast<float*>(smem + S::STATS);
  int* last = reinterpret_cast<int*>(smem + S::FLAG);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BARS);

  const int group = H / KV;
  const int n_groups = group / GB;  // CTAs per kv head
  const int kvh = blockIdx.x / n_groups;
  const int h0 = kvh * group + (blockIdx.x % n_groups) * GB;
  const int b = blockIdx.y, split = blockIdx.z;
  const int ctx = context_len(positions, b, max_blocks * block_size);
  const int start = split * PARTITION;
  if (start >= ctx) return;  // the merge reads only the partitions below ctx
  const int len = min(PARTITION, ctx - start);
  const int n_parts = (ctx + PARTITION - 1) / PARTITION;
  const int n_tiles = (len + T - 1) / T;
  const int n_loads = 2 * n_tiles;  // the K tiles, then the V tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = tid / C, c = tid % C;

  if (tid == 0) {
    for (int i = 0; i < STAGES * NUM_WARPS; ++i) {
      hopper::mbar_init(hopper::smem_u32(&bars[i]), 32);
    }
    hopper::fence_barrier_init();
  }
  // the partition's block-table entries, then its slots, once
  const int* bt = block_tables + (long)b * max_blocks;
  const int blk0 = start / block_size;
  const int n_blk = (start + len - 1) / block_size - blk0 + 1;
  for (int i = tid; i < n_blk; i += THREADS) table[i] = min(max(bt[blk0 + i], 0), num_blocks - 1);
  __syncthreads();
  for (int i = tid; i < len; i += THREADS) {
    const int t = start + i;
    slots[i] = table[t / block_size - blk0] * block_size + t % block_size;
  }
  __syncthreads();

  const long row_stride = (long)KV * D;
  const bf16* kbase = kpool + (long)kvh * D + c * 8;
  const bf16* vbase = vpool + (long)kvh * D + c * 8;
  const uint32_t ring_u32 = hopper::smem_u32(ring);
  const uint32_t bar_u32 = hopper::smem_u32(bars) + warp * 8;
  // load li (K tile li, or V tile li - n_tiles) into stage li % STAGES:
  // this thread's chunk of rows r + j R, j < J; rows past the context are
  // not copied, and not read
  auto issue = [&](int li) {
    const int stage = li % STAGES;
    const bool is_v = li >= n_tiles;
    const int row0 = (is_v ? li - n_tiles : li) * T + r;
    const bf16* base = is_v ? vbase : kbase;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int tl = row0 + j * R;
      if (tl < len) {
        hopper::cp_async_16(ring_u32 + ((stage * J + j) * THREADS + tid) * 16,
                            base + (long)slots[tl] * row_stride);
      }
    }
    hopper::cp_async_mbar_arrive(bar_u32 + stage * NUM_WARPS * 8);
  };
  for (int li = 0; li < min(STAGES, n_loads); ++li) issue(li);

  float qf[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + ((long)b * H + h0 + g) * D + c * 8);
    unpack8(raw, qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] *= scale_log2;
  }

  // scores (log2 units) into the score buffer
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % STAGES;
    hopper::mbar_wait(bar_u32 + stage * NUM_WARPS * 8, (tile / STAGES) & 1);
    float part[N];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float kf[8];
      unpack8(ring[(stage * J + j) * THREADS + tid], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qf[g][e], kf[e], s);
        part[j * GB + g] = s;
      }
    }
    if (tile + STAGES < n_loads) issue(tile + STAGES);
    int idx = 0;
    reduce_scatter<N, C / 2>(part, lane, idx);
    constexpr int HELD = N >= C ? N / C : 1;
    bool writer = true;
    if constexpr (N < C) writer = (lane & (C / N - 1)) == 0;
    if (writer) {
#pragma unroll
      for (int k = 0; k < HELD; ++k) {
        const int n = idx + k;
        const int tl = tile * T + (n / GB) * R + r;
        if (tl < len) scores[tl * GB + n % GB] = part[k];
      }
    }
  }
  __syncthreads();

  // softmax over the partition, per head: max, then exponentials and sum
  float m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) m[g] = NEG_INF, l[g] = 0.f;
  for (int i = tid; i < len; i += THREADS) {
#pragma unroll
    for (int g = 0; g < GB; ++g) m[g] = fmaxf(m[g], scores[i * GB + g]);
  }
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = warp_reduce<true>(m[g]);
    if (lane == 0) red[warp * GB + g] = m[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = red[g];
#pragma unroll
    for (int w = 1; w < NUM_WARPS; ++w) m[g] = fmaxf(m[g], red[w * GB + g]);
  }
  for (int i = tid; i < len; i += THREADS) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float p = exp2f(scores[i * GB + g] - m[g]);
      scores[i * GB + g] = p;
      l[g] += p;
    }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    l[g] = warp_reduce<false>(l[g]);
    if (lane == 0) red[(NUM_WARPS + warp) * GB + g] = l[g];
  }
  __syncthreads();  // publishes the probabilities and the warps' sums
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float sum = red[NUM_WARPS * GB + g];
#pragma unroll
      for (int w = 1; w < NUM_WARPS; ++w) sum += red[(NUM_WARPS + w) * GB + g];
      stats[g] = m[g];
      stats[GB + g] = sum;
    }
  }

  // P V: this thread's 8 dimensions of the GB heads, over its rows
  float acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int li = n_tiles + tile, stage = li % STAGES;
    hopper::mbar_wait(bar_u32 + stage * NUM_WARPS * 8, (li / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int tl = tile * T + j * R + r;
      if (tl < len) {
        float vf[8];
        unpack8(ring[(stage * J + j) * THREADS + tid], vf);
        float p[GB];
        if constexpr (GB % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GB; g += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(&scores[tl * GB + g]);
            p[g] = p4.x, p[g + 1] = p4.y, p[g + 2] = p4.z, p[g + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GB; ++g) p[g] = scores[tl * GB + g];
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
      }
    }
    if (li + STAGES < n_loads) issue(li + STAGES);
  }
  __syncthreads();  // every copy has landed and been read: the ring is free

  // sum the R row groups in a fixed order
  float* sums = reinterpret_cast<float*>(smem + S::RING);  // [R][GB][D]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float4* dst = reinterpret_cast<float4*>(&sums[(r * GB + g) * D + c * 8]);
    dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
  }
  __syncthreads();
  const bool direct = n_parts == 1;
#pragma unroll
  for (int e = tid; e < GB * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float o = 0.f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) o += sums[(rr * GB + g) * D + d];
    const long row = (long)b * H + h0 + g;
    if (direct) {
      out[row * D + d] = __float2bfloat16(o / stats[GB + g]);
    } else {
      part_o[(row * n_splits + split) * D + d] = o;
    }
  }
  if (direct) return;
  if (tid < GB) {
    float* ml = part_ml + (((long)b * H + h0 + tid) * n_splits + split) * 2;
    ml[0] = stats[tid];
    ml[1] = stats[GB + tid];
  }

  // the last CTA of this (sequence, head group) merges its partitions
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *last = atomicAdd(&counters[(long)b * gridDim.x + blockIdx.x], 1) == n_parts - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
#pragma unroll
  for (int e = tid; e < GB * D; e += THREADS) {
    const int g = e / D, d = e % D;
    const long row = (long)b * H + h0 + g;
    const float* ml = part_ml + row * n_splits * 2;
    const float* po = part_o + row * n_splits * D + d;
    float mx = NEG_INF;
    for (int s = 0; s < n_parts; ++s) mx = fmaxf(mx, __ldcg(&ml[2 * s]));
    float sum = 0.f, o = 0.f;
    for (int s = 0; s < n_parts; ++s) {
      const float w = exp2f(__ldcg(&ml[2 * s]) - mx);
      sum = fmaf(__ldcg(&ml[2 * s + 1]), w, sum);
      o = fmaf(__ldcg(&po[(long)s * D]), w, o);
    }
    out[row * D + d] = __float2bfloat16(o / sum);
  }
}

template <int D, int GB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt, const void* pos,
                   void* out, void* po, void* pml, void* counters, int B, int H, int KV,
                   int max_blocks, int block_size, int num_blocks, int n_splits, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Smem<GB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, GB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV * (H / KV / GB), B, n_splits);
  paged_decode_kernel<D, GB><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(pos), static_cast<bf16*>(out),
      static_cast<float*>(po), static_cast<float*>(pml), static_cast<int*>(counters), H, KV,
      max_blocks, block_size, num_blocks, n_splits, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* bt,
                     const void* pos, void* out, void* po, void* pml, void* counters, int B,
                     int H, int KV, int max_blocks, int block_size, int num_blocks,
                     int n_splits, float scale, cudaStream_t stream) {
  const int group = H / KV;
  if (group % 8 == 0) {
    return launch<D, 8>(q, k, v, bt, pos, out, po, pml, counters, B, H, KV, max_blocks,
                        block_size, num_blocks, n_splits, scale, stream);
  }
  if (group % 4 == 0) {
    return launch<D, 4>(q, k, v, bt, pos, out, po, pml, counters, B, H, KV, max_blocks,
                        block_size, num_blocks, n_splits, scale, stream);
  }
  if (group % 2 == 0) {
    return launch<D, 2>(q, k, v, bt, pos, out, po, pml, counters, B, H, KV, max_blocks,
                        block_size, num_blocks, n_splits, scale, stream);
  }
  return launch<D, 1>(q, k, v, bt, pos, out, po, pml, counters, B, H, KV, max_blocks,
                      block_size, num_blocks, n_splits, scale, stream);
}

}  // namespace

// counters: (B, H) int32, zero at launch (the kernel counts in the first
// KV * (H / KV / GB) of each row); part_o (B, H, n_splits, D) and part_ml
// (B, H, n_splits, 2) fp32 scratch.
extern "C" int paged_attention_decode(const void* q, const void* k, const void* v,
                                      const void* block_tables, const void* positions,
                                      void* out, void* part_o, void* part_ml, void* counters,
                                      int B, int H, int KV, int D, int max_blocks,
                                      int block_size, int num_blocks, int n_splits,
                                      float scale, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 || max_blocks <= 0 || block_size <= 0 ||
      num_blocks <= 0 || n_splits != (max_blocks * block_size + PARTITION - 1) / PARTITION ||
      n_splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_d<64>(q, k, v, block_tables, positions, out, part_o, part_ml, counters,
                               B, H, KV, max_blocks, block_size, num_blocks, n_splits, scale, s);
    case 128:
      return (int)launch_d<128>(q, k, v, block_tables, positions, out, part_o, part_ml, counters,
                                B, H, KV, max_blocks, block_size, num_blocks, n_splits, scale, s);
    case 256:
      return (int)launch_d<256>(q, k, v, block_tables, positions, out, part_o, part_ml, counters,
                                B, H, KV, max_blocks, block_size, num_blocks, n_splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
