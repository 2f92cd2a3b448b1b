// The image-pyramid stencils of tracking (ops/pyramid.py): three 5x5
// half-resolution pyrDowns and the 3x3 Scharr-like derivatives.
//   pyr_down_depth_kernel      pyrDownGaussKernel (cudafuncs.cu:77-121): taps
//                              within 3 sigma of the centre, weights
//                              {1,4,6,4,1}/16 a dimension, the weighted mean
//   pyr_down_gauss_kernel      pyrDownKernelGaussF (cudafuncs.cu:393-411):
//                              {1,4,6,4,1}^2 over the taps > 0 (0 = invalid)
//   pyr_down_intensity_kernel  pyrDownKernelIntensityGauss (cudafuncs.cu:
//                              516-540): {1,4,6,4,1}^2 over the image's taps
//   derivatives_kernel         applyKernel + gsobel (cudafuncs.cu:613-667):
//                              both gradients, truncated
//
// Replaces no Pallas kernel: the reference's stencils are plain JAX
// (elasticfusion_tpu/ops/preprocess.py), which XLA fuses into one loop each.
// On a card the plain PyTorch versions' unrolled stencils dispatch, a call,
// 286 (depth), 137 (gauss), 133 (intensity) and 55 (derivatives)
// elementwise launches at any size; each of these is one.
//
// Bound: bytes, and at these sizes really the launch.  A pyrDown reads its
// image once and writes a quarter of it: 640x480 -> 320x240 is 1.54 MB, 0.46
// us at 3.35 TB/s, against 25 taps of about six float operations per output
// pixel (11.5M, 0.17 us at 67 TFLOP/s).  The derivatives read the image and
// write two: 3.69 MB at 640x480, 1.1 us.  So the design moves each byte once
// and spends nothing else: one block per 32x8 tile of OUTPUT pixels stages
// the tile's input footprint (for a pyrDown 67x19 floats: the even pixels
// 2y, 2x of the tile and a 2-pixel halo; for the derivatives 34x10) in
// shared memory with coalesced loads, zero outside the image, and one thread
// per output pixel reads its taps from there.  A pyrDown computes only the
// full-resolution pixels (2y, 2x) that the plain version keeps of its
// full-resolution result (`_subsample2`, over the even-cropped image): a
// quarter of its work.  Any H and W: the taps of an odd last row or column
// are read as the plain version's are.
//
// Bit-identical to the plain PyTorch versions on a card: the taps run in the
// plain versions' order (dy outer, dx inner; the derivatives in their tap
// list's order), every expression keeps their products and association
// ((nb * w); (tap * m) * w; (wx * nb) * m with m = 1), the weights and the
// 3-sigma threshold are the float32 roundings of the plain versions' Python
// scalars (as PyTorch rounds a scalar), the division is IEEE, and the build
// has -fmad=false so that no multiply-add is contracted.  Taps outside the
// image are skipped: the plain version adds them as an exact 0 to a sum that
// starts at +0 and so is never -0.

#include <cuda_runtime.h>

#define EF_TW 32
#define EF_TH 8
#define EF_NT (EF_TW * EF_TH)
// a pyrDown tile's input footprint: 2 * 32 - 1 columns and 2 * 8 - 1 rows of
// full-resolution pixels under its outputs, and a 2-pixel halo
#define EF_DW (2 * EF_TW + 3)
#define EF_DH (2 * EF_TH + 3)

// {1,4,6,4,1} and {1,4,6,4,1}/16, by |offset| + 2
__constant__ float kGauss5[5] = {1.0f, 4.0f, 6.0f, 4.0f, 1.0f};
__constant__ float kDepthW[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};

// tile[sy * SW + sx] = img[gy0 + sy, gx0 + sx], 0 outside the image
template <int SW, int SH>
__device__ __forceinline__ void stage(const float* __restrict__ img, float* tile,
                                      int H, int W, int gy0, int gx0) {
  const int tid = threadIdx.y * EF_TW + threadIdx.x;
  for (int i = tid; i < SW * SH; i += EF_NT) {
    const int sy = i / SW, sx = i - sy * SW;
    const int gy = gy0 + sy, gx = gx0 + sx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? img[(long long)gy * W + gx] : 0.0f;
  }
}

// The three pyrDowns share their staging and their walk over the taps
// inside the image; KIND picks the arithmetic of a tap and of the result.
enum { kDepth = 0, kGauss = 1, kIntensity = 2 };

template <int KIND>
__device__ __forceinline__ void pyr_down(const float* __restrict__ img,
                                         float* __restrict__ out, int H, int W,
                                         float thr) {
  __shared__ float tile[EF_DH * EF_DW];
  const int oy0 = blockIdx.y * EF_TH, ox0 = blockIdx.x * EF_TW;
  stage<EF_DW, EF_DH>(img, tile, H, W, 2 * oy0 - 2, 2 * ox0 - 2);
  __syncthreads();

  const int Ho = H / 2, Wo = W / 2;
  const int x = ox0 + threadIdx.x, y = oy0 + threadIdx.y;
  if (x >= Wo || y >= Ho) return;
  const int cy = 2 * y, cx = 2 * x;    // the full-resolution centre
  const float* centre = tile + (2 * threadIdx.y + 2) * EF_DW + 2 * threadIdx.x + 2;
  const float c = *centre;
  const int dy0 = max(-2, -cy), dy1 = min(2, H - 1 - cy);
  const int dx0 = max(-2, -cx), dx1 = min(2, W - 1 - cx);
  float num = 0.0f, den = 0.0f;
  for (int dy = dy0; dy <= dy1; ++dy) {
    const float* row = centre + dy * EF_DW;
    for (int dx = dx0; dx <= dx1; ++dx) {
      const float nb = row[dx];
      if (KIND == kDepth) {
        const float w = kDepthW[dy + 2] * kDepthW[dx + 2];
        if (fabsf(nb - c) < thr) {
          num = num + nb * w;
          den = den + w;
        }
      } else if (KIND == kGauss) {
        const float w = kGauss5[dy + 2] * kGauss5[dx + 2];
        const float m = nb > 0.0f ? 1.0f : 0.0f;
        num = num + (nb * m) * w;
        den = den + m * w;
      } else {
        const float w = kGauss5[dy + 2] * kGauss5[dx + 2];
        num = num + nb * w;
        den = den + w;
      }
    }
  }
  float v;
  if (KIND == kIntensity) {
    v = num / fmaxf(den, 1e-12f);
  } else {
    v = den > 0.0f ? num / fmaxf(den, 1e-12f) : 0.0f;
  }
  out[(long long)y * Wo + x] = v;
}

__global__ void __launch_bounds__(EF_NT)
pyr_down_depth_kernel(const float* __restrict__ img, float* __restrict__ out,
                      int H, int W, float thr) {
  pyr_down<kDepth>(img, out, H, W, thr);
}

__global__ void __launch_bounds__(EF_NT)
pyr_down_gauss_kernel(const float* __restrict__ img, float* __restrict__ out,
                      int H, int W) {
  pyr_down<kGauss>(img, out, H, W, 0.0f);
}

__global__ void __launch_bounds__(EF_NT)
pyr_down_intensity_kernel(const float* __restrict__ img, float* __restrict__ out,
                          int H, int W) {
  pyr_down<kIntensity>(img, out, H, W, 0.0f);
}

__global__ void __launch_bounds__(EF_NT)
derivatives_kernel(const float* __restrict__ img, float* __restrict__ dx_out,
                   float* __restrict__ dy_out, int H, int W, float a, float b) {
  __shared__ float tile[(EF_TH + 2) * (EF_TW + 2)];
  const int y0 = blockIdx.y * EF_TH, x0 = blockIdx.x * EF_TW;
  stage<EF_TW + 2, EF_TH + 2>(img, tile, H, W, y0 - 1, x0 - 1);
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  // the plain version's tap list: (dy, dx) and the weights of dx and dy
  const int tdy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int tdx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  const float wx[8] = {-a, 0.0f, a, -b, b, -a, 0.0f, a};
  const float wy[8] = {-a, -b, -a, 0.0f, 0.0f, a, b, a};
  const float* centre = tile + (threadIdx.y + 1) * (EF_TW + 2) + threadIdx.x + 1;
  float gx = 0.0f, gy = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int yy = y + tdy[t], xx = x + tdx[t];
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const float nb = centre[tdy[t] * (EF_TW + 2) + tdx[t]];
    gx = gx + wx[t] * nb;
    gy = gy + wy[t] * nb;
  }
  dx_out[(long long)y * W + x] = truncf(gx);
  dy_out[(long long)y * W + x] = truncf(gy);
}

// The launchers: img [H,W] f32 contiguous -> out f32 contiguous ([H/2,W/2]
// for a pyrDown, two [H,W] for the derivatives), on `stream`; 0 or a
// cudaError_t.  An empty output launches nothing.

static dim3 grid_of(int w, int h) {
  return dim3((w + EF_TW - 1) / EF_TW, (h + EF_TH - 1) / EF_TH);
}

extern "C" int ef_pyr_down_depth(const float* img, float* out, int H, int W, float thr,
                                 void* stream) {
  if (H / 2 == 0 || W / 2 == 0) return 0;
  pyr_down_depth_kernel<<<grid_of(W / 2, H / 2), dim3(EF_TW, EF_TH), 0,
                          (cudaStream_t)stream>>>(img, out, H, W, thr);
  return (int)cudaGetLastError();
}

extern "C" int ef_pyr_down_gauss(const float* img, float* out, int H, int W,
                                 void* stream) {
  if (H / 2 == 0 || W / 2 == 0) return 0;
  pyr_down_gauss_kernel<<<grid_of(W / 2, H / 2), dim3(EF_TW, EF_TH), 0,
                          (cudaStream_t)stream>>>(img, out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int ef_pyr_down_intensity(const float* img, float* out, int H, int W,
                                     void* stream) {
  if (H / 2 == 0 || W / 2 == 0) return 0;
  pyr_down_intensity_kernel<<<grid_of(W / 2, H / 2), dim3(EF_TW, EF_TH), 0,
                              (cudaStream_t)stream>>>(img, out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int ef_derivatives(const float* img, float* dx, float* dy, int H, int W,
                              float a, float b, void* stream) {
  if (H == 0 || W == 0) return 0;
  derivatives_kernel<<<grid_of(W, H), dim3(EF_TW, EF_TH), 0, (cudaStream_t)stream>>>(
      img, dx, dy, H, W, a, b);
  return (int)cudaGetLastError();
}
