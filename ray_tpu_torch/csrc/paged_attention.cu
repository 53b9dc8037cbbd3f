// Paged-attention decode for Hopper (sm_90a): one query row per sequence
// against that sequence's KV cache, read in place through its block table.
// bf16 in and out, fp32 scores, softmax and accumulation.
//
// Replaces: no Pallas kernel. The reference runs this step in XLA:
// ray_tpu/models/generation.py `_forward_paged` builds `gather_idx`, gathers
// every sequence's whole block table into a dense (B, MB * block_size) copy
// on every layer of every step, and runs `_paged_attention`, a masked
// softmax over it. This kernel reads only rows 0..positions[b] of each
// sequence, where they lie in the pool, and makes no copy.
//
// What bounds it on this card: one query row does 2 multiply-adds per K/V
// element it reads (about 1 operation per byte), far below the H100's ~295
// operations per byte, so it is bound by memory bandwidth. The design
// therefore reads each needed K and V row once, with neighbouring threads
// on neighbouring addresses, and keeps scores and probabilities in shared
// memory.
//
// Design (simple and right first): a split over the context. Pass 1 runs
// one CTA of 4 warps per (head, sequence, 512-token partition): each warp
// takes one token at a time and its 32 lanes split the head dimension for
// the q.k dot product; the CTA then forms the partition's max, its
// exponentials and their sum, and accumulates P V with each thread owning
// two output dimensions. It writes the partition's unnormalised output and
// its (max, sum). Pass 2 merges the partitions of each (head, sequence) by
// their maxima. The partition size is fixed, so a sequence's arithmetic
// never depends on which sequences share its batch.
//
// Layout: q/out (B, H, D); k/v pool slice of one layer (n_slots, KV, D),
// n_slots = num_blocks * block_size; block_tables (B, max_blocks) int32;
// positions (B,) int32. Grouped-query attention reads kv head h / (H / KV).
// Block indices are clamped into the pool and the context into the table,
// as the reference clamps its gathers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PARTITION = 512;  // tokens per pass-1 CTA; PARTITION in the wrapper
constexpr int NUM_WARPS = 4;
constexpr int THREADS = NUM_WARPS * 32;
constexpr float NEG_INF = -1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int context_len(const int* positions, int b, int max_ctx) {
  return min(max(positions[b] + 1, 1), max_ctx);
}

__device__ __forceinline__ long slot_of(const int* bt, int tok, int block_size, int num_blocks) {
  const int blk = min(max(bt[tok / block_size], 0), num_blocks - 1);
  return (long)blk * block_size + tok % block_size;
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NUM_WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red may be reused
  return r;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    paged_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                         const bf16* __restrict__ vpool, const int* __restrict__ block_tables,
                         const int* __restrict__ positions, float* __restrict__ part_o,
                         float* __restrict__ part_ml, int H, int KV, int max_blocks,
                         int block_size, int num_blocks, int n_splits, float scale) {
  constexpr int ROW_THREADS = D / 2;            // threads per V row, 2 dims each
  constexpr int ROWS = THREADS / ROW_THREADS;   // V rows in flight
  __shared__ float sq[D];
  __shared__ float sp[PARTITION];
  __shared__ float red[NUM_WARPS];
  __shared__ float so[THREADS * 2];

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int kvh = h / (H / KV);
  const int ctx = context_len(positions, b, max_blocks * block_size);
  const int start = split * PARTITION;
  if (start >= ctx) return;  // pass 2 reads only the partitions below ctx
  const int end = min(start + PARTITION, ctx);
  const int* bt = block_tables + (long)b * max_blocks;
  const long slot_stride = (long)KV * D;
  const bf16* kbase = kpool + (long)kvh * D;
  const bf16* vbase = vpool + (long)kvh * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const bf16* qb = q + ((long)b * H + h) * D;
  for (int i = tid; i < D; i += THREADS) sq[i] = __bfloat162float(qb[i]);
  __syncthreads();

  // scores: one token per warp at a time, lanes split the head dimension
  float local_max = NEG_INF;
  for (int tok = start + warp; tok < end; tok += NUM_WARPS) {
    const bf16* kp = kbase + slot_of(bt, tok, block_size, num_blocks) * slot_stride;
    float dot = 0.f;
#pragma unroll
    for (int d = lane * 2; d < D; d += 64) {
      const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kp + d));
      dot += sq[d] * kf.x + sq[d + 1] * kf.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float sc = dot * scale;
    if (lane == 0) sp[tok - start] = sc;
    local_max = fmaxf(local_max, sc);
  }
  const float m = block_reduce(local_max, red, true);  // its barrier publishes sp

  float local_sum = 0.f;
  for (int i = tid; i < end - start; i += THREADS) {
    const float p = __expf(sp[i] - m);
    sp[i] = p;
    local_sum += p;
  }
  const float l = block_reduce(local_sum, red, false);

  // P V: ROWS tokens in flight, each thread owns dims d and d + 1
  const int r = tid / ROW_THREADS;
  const int d = (tid % ROW_THREADS) * 2;
  float o0 = 0.f, o1 = 0.f;
  for (int tok = start + r; tok < end; tok += ROWS) {
    const bf16* vp = vbase + slot_of(bt, tok, block_size, num_blocks) * slot_stride;
    const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + d));
    const float p = sp[tok - start];
    o0 += p * vf.x;
    o1 += p * vf.y;
  }
  so[2 * tid] = o0;
  so[2 * tid + 1] = o1;
  __syncthreads();
  if (r == 0) {
#pragma unroll
    for (int rr = 1; rr < ROWS; ++rr) {
      o0 += so[2 * (rr * ROW_THREADS + tid)];
      o1 += so[2 * (rr * ROW_THREADS + tid) + 1];
    }
    float* po = part_o + (((long)b * H + h) * n_splits + split) * D;
    po[d] = o0;
    po[d + 1] = o1;
  }
  if (tid == 0) {
    float* pml = part_ml + (((long)b * H + h) * n_splits + split) * 2;
    pml[0] = m;
    pml[1] = l;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    paged_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                         const int* __restrict__ positions, bf16* __restrict__ out, int H,
                         int max_ctx, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ctx = context_len(positions, b, max_ctx);
  const int n = (ctx + PARTITION - 1) / PARTITION;
  const float* pml = part_ml + ((long)b * H + h) * n_splits * 2;
  const float* po = part_o + ((long)b * H + h) * n_splits * D;
  float mx = NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, pml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < n; ++s) l += pml[2 * s + 1] * __expf(pml[2 * s] - mx);
  const float inv_l = 1.f / l;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < n; ++s) acc += po[(long)s * D + d] * __expf(pml[2 * s] - mx);
    out[((long)b * H + h) * D + d] = __float2bfloat16(acc * inv_l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt, const void* pos,
                   void* out, void* po, void* pml, int B, int H, int KV, int max_blocks,
                   int block_size, int num_blocks, int n_splits, float scale,
                   cudaStream_t stream) {
  paged_partial_kernel<D><<<dim3(H, B, n_splits), THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(pos), static_cast<float*>(po),
      static_cast<float*>(pml), H, KV, max_blocks, block_size, num_blocks, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<D><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const float*>(po), static_cast<const float*>(pml),
      static_cast<const int*>(pos), static_cast<bf16*>(out), H, max_blocks * block_size,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_decode(const void* q, const void* k, const void* v,
                                      const void* block_tables, const void* positions,
                                      void* out, void* part_o, void* part_ml, int B, int H,
                                      int KV, int D, int max_blocks, int block_size,
                                      int num_blocks, int n_splits, float scale, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 || max_blocks <= 0 || block_size <= 0 ||
      num_blocks <= 0 || n_splits != (max_blocks * block_size + PARTITION - 1) / PARTITION ||
      n_splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, block_tables, positions, out, part_o, part_ml, B, H, KV,
                             max_blocks, block_size, num_blocks, n_splits, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, block_tables, positions, out, part_o, part_ml, B, H, KV,
                              max_blocks, block_size, num_blocks, n_splits, scale, s);
    case 256:
      return (int)launch<256>(q, k, v, block_tables, positions, out, part_o, part_ml, B, H, KV,
                              max_blocks, block_size, num_blocks, n_splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
