// The bilateral filter on raw depth (depth_bilateral.frag): a (2r+1)^2 window,
// each tap weighted by exp(-(space term + colour term)), the weighted mean
// rounded to whole millimetres and gated to 0 outside [300 mm, maxD].
//
// Replaces no Pallas kernel: the reference's filter is plain JAX
// (elasticfusion_tpu/ops/preprocess.py `bilateral_filter`), which XLA fuses
// into one loop.  On a card the plain PyTorch version's unrolled stencil is
// 2,041 full-resolution elementwise launches a call at radius 6; this is one.
//
// Bound: operations.  At 640x480 and radius 6 a frame has 52M taps, each an
// `expf` and about ten float operations, against 2.5 MB of bytes.  So the
// design spends nothing but arithmetic per tap: one block per 32x8 image
// tile stages the tile and its r-pixel halo once in shared memory (dynamic,
// sized by the radius: 44x20 floats at r = 6), one thread per output pixel
// walks its window from there, and the space term of each squared distance
// dy^2 + dx^2 is computed once a block into a small table.  Taps outside the
// image are skipped: the plain version adds them times a 0 mask, and x + 0
// == x for the finite sums here.
//
// Bit-identical to the plain PyTorch version on a card: the taps run
// dy-outer / dx-inner, every expression keeps the plain version's operation
// order, the space term is the float32 rounding of the double product (as
// PyTorch rounds a Python scalar), `expf` is the precise one, and the build
// has -fmad=false so that no multiply-add is contracted.

#include <cuda_runtime.h>

#define EF_TW 32
#define EF_TH 8

__global__ void __launch_bounds__(EF_TW * EF_TH)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int H, int W, int r, double space_k, float color_k, float max_mm) {
  extern __shared__ float smem[];
  const int SW = EF_TW + 2 * r, SH = EF_TH + 2 * r;
  float* tile = smem;                  // [SH][SW], zero outside the image
  float* space = smem + SW * SH;       // [2 r^2 + 1], by dy^2 + dx^2
  const int tid = threadIdx.y * EF_TW + threadIdx.x;
  const int gx0 = blockIdx.x * EF_TW - r, gy0 = blockIdx.y * EF_TH - r;

  for (int i = tid; i < SW * SH; i += EF_TW * EF_TH) {
    const int sy = i / SW, sx = i - sy * SW;
    const int gy = gy0 + sy, gx = gx0 + sx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? depth[(long long)gy * W + gx] : 0.0f;
  }
  for (int i = tid; i <= 2 * r * r; i += EF_TW * EF_TH)
    space[i] = (float)((double)i * space_k);
  __syncthreads();

  const int x = blockIdx.x * EF_TW + threadIdx.x;
  const int y = blockIdx.y * EF_TH + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* centre = tile + (threadIdx.y + r) * SW + threadIdx.x + r;
  const float c = *centre;
  // the taps inside the image
  const int dy0 = max(-r, -y), dy1 = min(r, H - 1 - y);
  const int dx0 = max(-r, -x), dx1 = min(r, W - 1 - x);
  float num = 0.0f, den = 0.0f;
  for (int dy = dy0; dy <= dy1; ++dy) {
    const float* row = centre + dy * SW;
    for (int dx = dx0; dx <= dx1; ++dx) {
      const float nb = row[dx];
      const float color2 = (c - nb) * (c - nb);
      const float w = expf(-(space[dy * dy + dx * dx] + color2 * color_k));
      num = num + nb * w;
      den = den + w;
    }
  }
  const float v = rintf(num / fmaxf(den, 1e-12f));
  out[(long long)y * W + x] = (c > max_mm || c < 300.0f) ? 0.0f : v;
}

// depth [H,W] f32 contiguous -> out [H,W] f32; 0 or a cudaError_t.
extern "C" int ef_bilateral(const float* depth, float* out, int H, int W, int radius,
                            double space_k, float color_k, float max_mm, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)(EF_TW + 2 * radius) * (EF_TH + 2 * radius)
                                       + 2 * radius * radius + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 block(EF_TW, EF_TH);
  dim3 grid((W + EF_TW - 1) / EF_TW, (H + EF_TH - 1) / EF_TH);
  bilateral_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      depth, out, H, W, radius, space_k, color_k, max_mm);
  return (int)cudaGetLastError();
}
