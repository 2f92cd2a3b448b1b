// Shared device code of every normal-equation reduction (gram.cu and the
// fused odometry steps of odometry_steps.cu): a grid-wide sum of T per-thread
// float accumulators in ONE launch, with a fixed order of additions.
//
//   1. block: warp shuffles, then one shared-memory pass over the warps, give
//      one partial per block, written to `partials[block][T]`;
//   2. grid: every block fences its partials and draws a ticket from an
//      INTEGER counter; the block that draws the last ticket adds the
//      partials of all blocks in block order (ef_sum_partials).  `atomicInc`
//      wraps the counter back to 0 on that last ticket, so the next launch
//      finds it reset.
//
// The only atomic is on the integer ticket: which block finishes last varies,
// what it adds and in which order does not, so results repeat bit for bit.
// `partials` ([gridDim.x, T] floats) and `ticket` (one zeroed unsigned) belong
// to one launcher and one stream: two launches that share them must not
// overlap.  Blocks are 1-D with EF_RED_THREADS threads, and T <= EF_RED_THREADS.

#pragma once

#include <cuda_runtime.h>

#define EF_RED_THREADS 256

// Adds the triangle of the outer product r r^T (row-major upper triangle,
// (i,j) with i <= j) into acc[K(K+1)/2].
template <int K>
__device__ __forceinline__ void ef_accumulate_triangle(
    const float (&r)[K], float (&acc)[K * (K + 1) / 2]) {
  int t = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = i; j < K; ++j) {
      acc[t] = fmaf(r[i], r[j], acc[t]);
      ++t;
    }
  }
}

// Index of (i,j) in the row-major upper triangle of a KxK matrix.
__device__ __forceinline__ int ef_triangle_index(int i, int j, int K) {
  const int a = i < j ? i : j, b = i < j ? j : i;
  return a * K - a * (a - 1) / 2 + (b - a);
}

// Steps 1 and 2 above.  Returns true, for every thread of the block alike, in
// the one block that drew the last ticket; by then all partials are visible.
template <int T>
__device__ __forceinline__ bool ef_reduce_to_last_block(
    const float (&acc)[T], float* __restrict__ partials, unsigned int* ticket) {
  __shared__ float smem[EF_RED_THREADS / 32][T];
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) smem[warp][t] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += EF_RED_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < EF_RED_THREADS / 32; ++w) s += smem[w][t];
    partials[(long long)blockIdx.x * T + t] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  return is_last;
}

// Last block only: the grid-wide sums, entry t = the partials of blocks 0, 1,
// 2, ... added in that order, left in shared memory (`sums[T]`, valid for the
// whole block on return).  Adding straight from device memory would cost one
// L2 round trip per handful of blocks, so the whole block first copies the
// partials into shared memory, as many blocks at a time as EF_RED_STAGE floats
// hold (coalesced, every load independent, past L1, which other blocks'
// writes do not reach); thread t then adds its entries from there.
#define EF_RED_STAGE 8192

template <int T>
__device__ __forceinline__ const float* ef_sum_partials(const float* partials) {
  __shared__ float stage[EF_RED_STAGE];
  __shared__ float sums[T];
  constexpr int CHUNK = EF_RED_STAGE / T;  // blocks per staging round
  const int n_blocks = (int)gridDim.x;
  float s = 0.0f;
  for (int first = 0; first < n_blocks; first += CHUNK) {
    const int n = min(CHUNK, n_blocks - first);
    for (int e = threadIdx.x; e < n * T; e += EF_RED_THREADS)
      stage[e] = __ldcg(partials + (long long)first * T + e);
    __syncthreads();
    if (threadIdx.x < T)
      for (int b = 0; b < n; ++b) s += stage[b * T + threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x < T) sums[threadIdx.x] = s;
  __syncthreads();
  return sums;
}
