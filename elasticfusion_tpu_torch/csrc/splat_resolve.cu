// K2: splat resolve, the two-pass 5x5 ray/disk stencil that turns the point
// raster's winner channels into the predicted colour / vertex / normal maps.
//
// Replaces the Pallas kernel `_resolve_kernel` / `splat_resolve`
// (elasticfusion_tpu/ops/splat_pallas.py).  One block per 32x16 image tile:
// the tile plus its 2-pixel halo of all 13 channels is staged once in shared
// memory, zero-filled outside the image (zero clears the `valid` plane, so
// out-of-image neighbours never hit); both passes then run from shared
// memory, one thread per output pixel, and the 13 outputs are written
// coalesced along x.
//
// Pass 1 finds the nearest ray/disk hit `zmin`; pass 2 blends every hit
// within 0.01 m of it, weighted by confidence times radial falloff, and takes
// the init time of the heaviest hit (strict `>`, scan dy-outer / dx-inner).
// Input channels: p(3) n(3) rad conf col(3) init_t valid.
// Output channels: col(3) vertex(3) conf normal(3) rad time depth.
//
// Bound: bytes (13 channels read, 13 written; ~0.4 kflop per pixel).  Built
// with -fmad=false: the hit tests are float comparisons, and without FMA
// contraction each operation rounds exactly as in the plain PyTorch version.

#include <cuda_runtime.h>

#define EF_TW 32
#define EF_TH 16
#define EF_R 2
#define EF_SW (EF_TW + 2 * EF_R)
#define EF_SH (EF_TH + 2 * EF_R)
#define EF_NC 13

struct Cand {
  float zc, d2, rad;
  bool hit;
};

__device__ __forceinline__ Cand candidate(
    const float (*slab)[EF_SH][EF_SW], int sy, int sx, float lx, float ly) {
  const float px = slab[0][sy][sx], py = slab[1][sy][sx], pz = slab[2][sy][sx];
  const float nx = slab[3][sy][sx], ny = slab[4][sy][sx], nz = slab[5][sy][sx];
  Cand c;
  c.rad = slab[6][sy][sx];
  const bool ok = slab[12][sy][sx] > 0.0f;
  // ray/disk intersection (combo_splat.frag:37-50)
  const float ln = lx * nx + ly * ny + nz;
  const float pn = px * nx + py * ny + pz * nz;
  const bool ln_ok = fabsf(ln) > 1e-12f;
  c.zc = pn / (ln_ok ? ln : 1.0f);
  const float ex = c.zc * lx - px, ey = c.zc * ly - py, ez = c.zc - pz;
  c.d2 = ex * ex + ey * ey + ez * ez;
  c.hit = ok && ln_ok && (c.zc > 0.0f) && (c.d2 <= c.rad * c.rad);
  return c;
}

__global__ void __launch_bounds__(EF_TW * EF_TH)
splat_resolve_kernel(const float* __restrict__ chan, float* __restrict__ out,
                     int H, int W, float fx, float fy, float cx, float cy) {
  __shared__ float slab[EF_NC][EF_SH][EF_SW];
  const int x0 = blockIdx.x * EF_TW, y0 = blockIdx.y * EF_TH;
  const int tid = threadIdx.y * EF_TW + threadIdx.x;
  const long long HW = (long long)H * W;

  for (int e = tid; e < EF_NC * EF_SH * EF_SW; e += EF_TW * EF_TH) {
    const int c = e / (EF_SH * EF_SW);
    const int rem = e - c * (EF_SH * EF_SW);
    const int sy = rem / EF_SW, sx = rem - sy * EF_SW;
    const int gy = y0 - EF_R + sy, gx = x0 - EF_R + sx;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = chan[c * HW + (long long)gy * W + gx];
    slab[c][sy][sx] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float lx = ((float)x - cx) / fx;
  const float ly = ((float)y - cy) / fy;

  // pass 1: front depth
  float zmin = 3.4e38f;
  for (int dy = 0; dy < 2 * EF_R + 1; ++dy) {
    for (int dx = 0; dx < 2 * EF_R + 1; ++dx) {
      const Cand c = candidate(slab, threadIdx.y + dy, threadIdx.x + dx, lx, ly);
      if (c.hit && c.zc < zmin) zmin = c.zc;
    }
  }

  // pass 2: blend every hit within BLEND_EPS of the front surface
  const float front_z = zmin + 0.01f;
  float wsum = 0.0f, wbest = 0.0f, it_best = 0.0f;
  float a_z = 0.0f, a_conf = 0.0f, a_nx = 0.0f, a_ny = 0.0f, a_nz = 0.0f;
  float a_rad = 0.0f, a_r = 0.0f, a_g = 0.0f, a_b = 0.0f;
  for (int dy = 0; dy < 2 * EF_R + 1; ++dy) {
    for (int dx = 0; dx < 2 * EF_R + 1; ++dx) {
      const int sy = threadIdx.y + dy, sx = threadIdx.x + dx;
      const Cand c = candidate(slab, sy, sx, lx, ly);
      const float conf = slab[7][sy][sx];
      const bool front = c.hit && (c.zc <= front_z);
      const float gauss = 1.0f - c.d2 / fmaxf(c.rad * c.rad, 1e-12f);
      const float w =
          front ? fmaxf(conf, 1e-3f) * fmaxf(gauss, 0.05f) : 0.0f;
      wsum = wsum + w;
      a_z = a_z + w * c.zc;
      a_conf = a_conf + w * conf;
      a_nx = a_nx + w * slab[3][sy][sx];
      a_ny = a_ny + w * slab[4][sy][sx];
      a_nz = a_nz + w * slab[5][sy][sx];
      a_rad = a_rad + w * c.rad;
      a_r = a_r + w * slab[8][sy][sx];
      a_g = a_g + w * slab[9][sy][sx];
      a_b = a_b + w * slab[10][sy][sx];
      if (w > wbest) {  // discrete attribute from the dominant splat
        it_best = slab[11][sy][sx];
        wbest = w;
      }
    }
  }

  const bool found = wsum > 0.0f;
  const float inv_w = found ? 1.0f / fmaxf(wsum, 1e-12f) : 0.0f;
  const float zed = a_z * inv_w;
  const float nx = a_nx * inv_w, ny = a_ny * inv_w, nz = a_nz * inv_w;
  const float nlen = sqrtf(nx * nx + ny * ny + nz * nz);
  const float nscale =
      (found && nlen > 1e-12f) ? 1.0f / fmaxf(nlen, 1e-12f) : 0.0f;

  float* o = out + (long long)y * W + x;
  o[0 * HW] = a_r * inv_w;
  o[1 * HW] = a_g * inv_w;
  o[2 * HW] = a_b * inv_w;
  o[3 * HW] = zed * lx;
  o[4 * HW] = zed * ly;
  o[5 * HW] = zed;
  o[6 * HW] = a_conf * inv_w;
  o[7 * HW] = nx * nscale;
  o[8 * HW] = ny * nscale;
  o[9 * HW] = nz * nscale;
  o[10 * HW] = a_rad * inv_w;
  o[11 * HW] = it_best;
  o[12 * HW] = zed;
}

// chan [13,H,W] contiguous f32 -> out [13,H,W].
extern "C" int ef_splat_resolve(const float* chan, float* out, int H, int W,
                                float fx, float fy, float cx, float cy,
                                void* stream) {
  dim3 block(EF_TW, EF_TH);
  dim3 grid((W + EF_TW - 1) / EF_TW, (H + EF_TH - 1) / EF_TH);
  splat_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      chan, out, H, W, fx, fy, cx, cy);
  return (int)cudaGetLastError();
}
