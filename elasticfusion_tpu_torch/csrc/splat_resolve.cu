// K2: splat resolve, the two-pass 5x5 ray/disk stencil that turns the point
// raster's winner channels into the predicted colour / vertex / normal maps.
//
// Replaces the Pallas kernel `_resolve_kernel` / `splat_resolve`
// (elasticfusion_tpu/ops/splat_pallas.py).  One block per 32x8 image tile:
// the tile plus its 2-pixel halo is staged once in shared memory, zero-filled
// outside the image; both passes then run from there, one thread per output
// pixel, and the 13 outputs are written coalesced along x.
//
// Pass 1 finds the nearest ray/disk hit `zmin`; pass 2 blends every hit
// within 0.01 m of it, weighted by confidence times radial falloff, and takes
// the init time of the heaviest hit (strict `>`, scan dy-outer / dx-inner).
// Input channels: p(3) n(3) rad conf col(3) init_t valid.
// Output channels: col(3) vertex(3) conf normal(3) rad time depth.
//
// Bound: nominally bytes (13 channels read, 13 written), but what the kernel
// spends is instruction throughput: 25 candidates per pixel, each with an IEEE
// division.  So every candidate's division happens ONCE: pass 1 keeps its
// depth and a 25-bit hit mask in registers, and pass 2 visits only the hits (a
// non-hit would add w = 0, which changes no sum).  80 registers, three blocks
// of 256 threads per SM.
// What depends on the source pixel alone, p.n and rad^2, is computed once
// while staging instead of 25 times per neighbour, with `valid` folded into
// rad^2 (-1 for an invalid source, so `d2 <= rad^2` fails).
//
// Built with -fmad=false: the hit tests are float comparisons, and without
// FMA contraction each operation rounds exactly as in the plain PyTorch
// version, whose operation order every expression here keeps.

#include <cuda_runtime.h>

#define EF_TW 32
#define EF_TH 8
#define EF_R 2
#define EF_D (2 * EF_R + 1)
#define EF_SW (EF_TW + 2 * EF_R)
#define EF_SH (EF_TH + 2 * EF_R)

// staged planes
enum {
  S_PX, S_PY, S_PZ, S_NX, S_NY, S_NZ, S_PN, S_R2, S_RAD, S_CONF,
  S_CR, S_CG, S_CB, S_IT, S_COUNT
};

__global__ void __launch_bounds__(EF_TW * EF_TH, 3)
splat_resolve_kernel(const float* __restrict__ chan, float* __restrict__ out,
                     int H, int W, float fx, float fy, float cx, float cy) {
  __shared__ float slab[S_COUNT][EF_SH][EF_SW];
  const int x0 = blockIdx.x * EF_TW, y0 = blockIdx.y * EF_TH;
  const long long HW = (long long)H * W;

  for (int sy = threadIdx.y; sy < EF_SH; sy += EF_TH) {
    for (int sx = threadIdx.x; sx < EF_SW; sx += EF_TW) {
      const int gy = y0 - EF_R + sy, gx = x0 - EF_R + sx;
      float c[13];
#pragma unroll
      for (int k = 0; k < 13; ++k) c[k] = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float* src = chan + (long long)gy * W + gx;
#pragma unroll
        for (int k = 0; k < 13; ++k) c[k] = src[k * HW];
      }
      slab[S_PX][sy][sx] = c[0];
      slab[S_PY][sy][sx] = c[1];
      slab[S_PZ][sy][sx] = c[2];
      slab[S_NX][sy][sx] = c[3];
      slab[S_NY][sy][sx] = c[4];
      slab[S_NZ][sy][sx] = c[5];
      slab[S_PN][sy][sx] = c[0] * c[3] + c[1] * c[4] + c[2] * c[5];
      slab[S_R2][sy][sx] = c[12] > 0.0f ? c[6] * c[6] : -1.0f;
      slab[S_RAD][sy][sx] = c[6];
      slab[S_CONF][sy][sx] = c[7];
      slab[S_CR][sy][sx] = c[8];
      slab[S_CG][sy][sx] = c[9];
      slab[S_CB][sy][sx] = c[10];
      slab[S_IT][sy][sx] = c[11];
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float lx = ((float)x - cx) / fx;
  const float ly = ((float)y - cy) / fy;

  // pass 1: every candidate once; front depth
  float zc[EF_D * EF_D];
  unsigned int hits = 0u;
  float zmin = 3.4e38f;
#pragma unroll
  for (int dy = 0; dy < EF_D; ++dy) {
#pragma unroll
    for (int dx = 0; dx < EF_D; ++dx) {
      const int k = dy * EF_D + dx;
      const int sy = threadIdx.y + dy, sx = threadIdx.x + dx;
      const float r2 = slab[S_R2][sy][sx];
      zc[k] = 0.0f;
      if (r2 >= 0.0f) {
        // ray/disk intersection (combo_splat.frag:37-50)
        const float px = slab[S_PX][sy][sx], py = slab[S_PY][sy][sx];
        const float pz = slab[S_PZ][sy][sx];
        const float ln = lx * slab[S_NX][sy][sx] + ly * slab[S_NY][sy][sx] +
                         slab[S_NZ][sy][sx];
        const bool ln_ok = fabsf(ln) > 1e-12f;
        const float z = slab[S_PN][sy][sx] / (ln_ok ? ln : 1.0f);
        const float ex = z * lx - px, ey = z * ly - py, ez = z - pz;
        const float d = ex * ex + ey * ey + ez * ez;
        if (ln_ok && z > 0.0f && d <= r2) {
          zc[k] = z;
          hits |= 1u << k;
          if (z < zmin) zmin = z;
        }
      }
    }
  }

  // pass 2: blend every hit within BLEND_EPS of the front surface
  const float front_z = zmin + 0.01f;
  float wsum = 0.0f, wbest = 0.0f, it_best = 0.0f;
  float a_z = 0.0f, a_conf = 0.0f, a_nx = 0.0f, a_ny = 0.0f, a_nz = 0.0f;
  float a_rad = 0.0f, a_r = 0.0f, a_g = 0.0f, a_b = 0.0f;
#pragma unroll
  for (int dy = 0; dy < EF_D; ++dy) {
#pragma unroll
    for (int dx = 0; dx < EF_D; ++dx) {
      const int k = dy * EF_D + dx;
      if (!(hits & (1u << k)) || !(zc[k] <= front_z)) continue;
      const int sy = threadIdx.y + dy, sx = threadIdx.x + dx;
      const float conf = slab[S_CONF][sy][sx];
      // the squared miss distance again (three products, no division):
      // keeping 25 of them beside the depths costs more registers than it saves
      const float ex = zc[k] * lx - slab[S_PX][sy][sx];
      const float ey = zc[k] * ly - slab[S_PY][sy][sx];
      const float ez = zc[k] - slab[S_PZ][sy][sx];
      const float d2 = ex * ex + ey * ey + ez * ez;
      const float gauss = 1.0f - d2 / fmaxf(slab[S_R2][sy][sx], 1e-12f);
      const float w = fmaxf(conf, 1e-3f) * fmaxf(gauss, 0.05f);
      wsum = wsum + w;
      a_z = a_z + w * zc[k];
      a_conf = a_conf + w * conf;
      a_nx = a_nx + w * slab[S_NX][sy][sx];
      a_ny = a_ny + w * slab[S_NY][sy][sx];
      a_nz = a_nz + w * slab[S_NZ][sy][sx];
      a_rad = a_rad + w * slab[S_RAD][sy][sx];
      a_r = a_r + w * slab[S_CR][sy][sx];
      a_g = a_g + w * slab[S_CG][sy][sx];
      a_b = a_b + w * slab[S_CB][sy][sx];
      if (w > wbest) {  // discrete attribute from the dominant splat
        it_best = slab[S_IT][sy][sx];
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
