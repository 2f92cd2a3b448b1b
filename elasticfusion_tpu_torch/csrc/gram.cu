// K1: Gram accumulation rows[K,N] -> rows * rows^T [K,K], the reduction stage
// of a normal-equation step whose rows are in device memory (the SO(3)
// pre-alignment; the ICP / RGB steps build their rows inside
// odometry_steps.cu and never store them).
//
// Replaces the Pallas kernel `_gram_kernel` / `gram_outer_pallas`
// (elasticfusion_tpu/ops/gram_pallas.py), which carries one [K,K] sum across
// a sequential grid.  Blocks run in parallel here; the sum is finished in the
// same launch by the block that ends last (gram_reduce.cuh): every block
// strides over its columns with the K(K+1)/2 upper-triangle sums in
// registers, and the last block adds the per-block partials in block order
// and mirrors the triangle.  No float atomics: the order of every addition is
// fixed by (N, grid), so the result is bit-identical from run to run.
//
// Bound: bytes.  K*N floats are read once (8.6 MB at K=7, N=307200) against
// 2*K*K*N flops far below the f32 rate.  Loads are coalesced along N and
// 16 bytes wide where the row pointer and N allow (VEC); a kernel this short
// is mostly one launch's latency, which is why it is one launch.

#include "gram_reduce.cuh"

template <int K, bool VEC>
__global__ void __launch_bounds__(EF_RED_THREADS)
gram_kernel(const float* __restrict__ rows, long long N,
            float* __restrict__ partials, unsigned int* ticket,
            float* __restrict__ out) {
  constexpr int T = K * (K + 1) / 2;
  float acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.0f;

  const long long stride = (long long)gridDim.x * EF_RED_THREADS;
  const long long first = (long long)blockIdx.x * EF_RED_THREADS + threadIdx.x;
  if (VEC) {
    // four neighbouring columns per load; N % 4 == 0 and rows is 16-byte
    // aligned, so every row starts aligned too
    const long long N4 = N >> 2;
    for (long long c4 = first; c4 < N4; c4 += stride) {
      float4 q[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        q[k] = reinterpret_cast<const float4*>(rows + (long long)k * N)[c4];
      float r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = q[k].x;
      ef_accumulate_triangle<K>(r, acc);
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = q[k].y;
      ef_accumulate_triangle<K>(r, acc);
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = q[k].z;
      ef_accumulate_triangle<K>(r, acc);
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = q[k].w;
      ef_accumulate_triangle<K>(r, acc);
    }
  } else {
    for (long long col = first; col < N; col += stride) {
      float r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = rows[(long long)k * N + col];
      ef_accumulate_triangle<K>(r, acc);
    }
  }

  if (!ef_reduce_to_last_block<T>(acc, partials, ticket)) return;
  const float* sums = ef_sum_partials<T>(partials);
  // one thread per output element (i,j): mirrors the triangle
  for (int idx = threadIdx.x; idx < K * K; idx += EF_RED_THREADS)
    out[idx] = sums[ef_triangle_index(idx / K, idx % K, K)];
}

#define EF_GRAM_CASE(KK)                                                      \
  case KK:                                                                    \
    if (vec)                                                                  \
      gram_kernel<KK, true><<<n_blocks, EF_RED_THREADS, 0, s>>>(              \
          rows, N, partials, ticket, out);                                    \
    else                                                                      \
      gram_kernel<KK, false><<<n_blocks, EF_RED_THREADS, 0, s>>>(             \
          rows, N, partials, ticket, out);                                    \
    break;

// rows [K,N] contiguous f32; out [K,K]; scratch of this launcher: partials
// [n_blocks, K(K+1)/2] floats and one zeroed unsigned ticket.
extern "C" int ef_gram_outer(const float* rows, int K, long long N,
                             float* partials, unsigned int* ticket,
                             int n_blocks, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (N % 4 == 0) && (((unsigned long long)rows & 15ull) == 0);
  switch (K) {
    EF_GRAM_CASE(1) EF_GRAM_CASE(2) EF_GRAM_CASE(3) EF_GRAM_CASE(4)
    EF_GRAM_CASE(5) EF_GRAM_CASE(6) EF_GRAM_CASE(7) EF_GRAM_CASE(8)
    EF_GRAM_CASE(9) EF_GRAM_CASE(10) EF_GRAM_CASE(11) EF_GRAM_CASE(12)
    EF_GRAM_CASE(13) EF_GRAM_CASE(14) EF_GRAM_CASE(15) EF_GRAM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
