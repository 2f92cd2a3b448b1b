// K1: Gram accumulation rows[K,N] -> rows * rows^T [K,K], the reduction stage
// of every ICP / RGB / SO(3) normal-equation step.
//
// Replaces the Pallas kernel `_gram_kernel` / `gram_outer_pallas`
// (elasticfusion_tpu/ops/gram_pallas.py), which carries one [K,K] sum across
// a sequential grid.  Blocks run in parallel here, so the sum has two stages:
//   1. every block strides over its columns; each thread keeps the K(K+1)/2
//      upper-triangle partial sums in registers, a warp shuffle and one
//      shared-memory pass reduce them to one partial per block;
//   2. a single small block adds the per-block partials in block order and
//      mirrors the triangle.
// No float atomics: the order of every addition is fixed by (N, grid), so the
// result is bit-identical from run to run.
//
// Bound: bytes.  K*N floats are read once (8.6 MB at K=7, N=307200) against
// 2*K*K*N flops far below the f32 rate; loads are coalesced along N.

#include <cuda_runtime.h>

#define EF_GRAM_THREADS 256

template <int K>
__global__ void gram_partial_kernel(const float* __restrict__ rows,
                                    long long N,
                                    float* __restrict__ partials) {
  constexpr int T = K * (K + 1) / 2;
  float acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       col < N; col += stride) {
    float r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = rows[(long long)k * N + col];
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

  __shared__ float smem[EF_GRAM_THREADS / 32][T];
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
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < EF_GRAM_THREADS / 32; ++w) s += smem[w][t];
    partials[(long long)blockIdx.x * T + t] = s;
  }
}

// One thread per output element (i,j): sums its triangle entry over the
// blocks in order.
__global__ void gram_final_kernel(const float* __restrict__ partials,
                                  int n_blocks, int K,
                                  float* __restrict__ out) {
  const int idx = threadIdx.x;
  if (idx >= K * K) return;
  const int i = idx / K, j = idx % K;
  const int a = i < j ? i : j, b = i < j ? j : i;
  const int t = a * K - a * (a - 1) / 2 + (b - a);
  const int T = K * (K + 1) / 2;
  float s = 0.0f;
  for (int blk = 0; blk < n_blocks; ++blk) s += partials[blk * T + t];
  out[idx] = s;
}

#define EF_GRAM_CASE(KK)                                                     \
  case KK:                                                                   \
    gram_partial_kernel<KK><<<n_blocks, EF_GRAM_THREADS, 0, s>>>(rows, N,    \
                                                                 partials);  \
    break;

// rows [K,N] contiguous f32; partials scratch [n_blocks, K(K+1)/2]; out [K,K].
extern "C" int ef_gram_outer(const float* rows, int K, long long N,
                             float* partials, int n_blocks, float* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    EF_GRAM_CASE(1) EF_GRAM_CASE(2) EF_GRAM_CASE(3) EF_GRAM_CASE(4)
    EF_GRAM_CASE(5) EF_GRAM_CASE(6) EF_GRAM_CASE(7) EF_GRAM_CASE(8)
    EF_GRAM_CASE(9) EF_GRAM_CASE(10) EF_GRAM_CASE(11) EF_GRAM_CASE(12)
    EF_GRAM_CASE(13) EF_GRAM_CASE(14) EF_GRAM_CASE(15) EF_GRAM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_final_kernel<<<1, 256, 0, s>>>(partials, n_blocks, K, out);
  return (int)cudaGetLastError();
}
