// K3: fuse window, the 3x3 association search of the data pass plus the
// accumulation of the 12 contribution images at the winning pixel.
//
// Replaces the Pallas kernel `_window_kernel` / `fuse_window`
// (elasticfusion_tpu/ops/fuse_pallas.py).  One block per 32x16 image tile:
//   step 0  the 8 candidate channels (index+1, vert, normal, radius) of the
//           tile plus a 2-pixel halo go to shared memory, zero outside the
//           image (index+1 == 0 reads as "empty");
//   step 1  for every pixel q of the tile plus a 1-pixel ring, search q's 3x3
//           window (offsets 0..8, dy outer / dx inner, strict `<` so the first
//           candidate wins ties) and compute q's 12 contribution values;
//           best_off and the contributions stay in shared memory, the four
//           association outputs of tile pixels go straight to global memory;
//   step 3  every output pixel w gathers, in offset order, the contributions
//           of the <= 9 neighbours q whose best_off points at w.
// The gather form (not atomicAdd from q) fixes the order of every sum.  The
// ten measurement channels are read exactly once per ring pixel, so they are
// not staged.  Surfel ids travel as exact floats (capacity < 2^24).
//
// Input channels [18,H,W]: index+1, pred vert(3), pred normal(3), pred radius,
//   raw depth z, measurement normal(3), measuring, conf_new, rad_new, rgb(3).
// Output channels [16,H,W]: best_id, best_off, best_rad, matched, then
//   a, a_full, a_full*v_g(3), a_full*rgb(3), a_full*n_g(3), a_full*rad_new.
//
// Bound: bytes (18 channels read, 16 written).  Built with -fmad=false so the
// gate comparisons round exactly as in the plain PyTorch version.

#include <cuda_runtime.h>

#define EF_TW 32
#define EF_TH 16
#define EF_EW (EF_TW + 2)   // tile + 1-ring
#define EF_EH (EF_TH + 2)
#define EF_SW (EF_TW + 4)   // tile + 2-halo of candidates
#define EF_SH (EF_TH + 4)
#define EF_NCAND 8
#define EF_NEXT 13          // best_off + 12 contributions
#define EF_COS_HALF 0.87758256189f  // cos(0.5 rad), data.vert:148

#define EF_SMEM_FLOATS \
  (EF_NCAND * EF_SH * EF_SW + EF_NEXT * EF_EH * EF_EW)

__global__ void __launch_bounds__(EF_TW * EF_TH)
fuse_window_kernel(const float* __restrict__ chan,
                   const float* __restrict__ par, float* __restrict__ out,
                   int H, int W, float fx, float fy, float cx, float cy,
                   float cap) {
  extern __shared__ float smem[];
  float* cand = smem;                                  // [8][SH][SW]
  float* extp = smem + EF_NCAND * EF_SH * EF_SW;       // [13][EH][EW]
#define CAND(c, y, x) cand[((c) * EF_SH + (y)) * EF_SW + (x)]
#define EXT(c, y, x) extp[((c) * EF_EH + (y)) * EF_EW + (x)]

  const int x0 = blockIdx.x * EF_TW, y0 = blockIdx.y * EF_TH;
  const int tid = threadIdx.y * EF_TW + threadIdx.x;
  const long long HW = (long long)H * W;

  // step 0: candidate channels, tile + 2-halo
  for (int e = tid; e < EF_NCAND * EF_SH * EF_SW; e += EF_TW * EF_TH) {
    const int c = e / (EF_SH * EF_SW);
    const int rem = e - c * (EF_SH * EF_SW);
    const int sy = rem / EF_SW, sx = rem - sy * EF_SW;
    const int gy = y0 - 2 + sy, gx = x0 - 2 + sx;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = chan[c * HW + (long long)gy * W + gx];
    cand[e] = v;
  }
  __syncthreads();

  const float r0 = par[0], r1 = par[1], r2 = par[2];
  const float r3 = par[3], r4 = par[4], r5 = par[5];
  const float r6 = par[6], r7 = par[7], r8 = par[8];
  const float t0 = par[9], t1 = par[10], t2 = par[11];

  // step 1: window search + contributions on tile + 1-ring
  for (int e = tid; e < EF_EH * EF_EW; e += EF_TW * EF_TH) {
    const int ey = e / EF_EW, ex = e - ey * EF_EW;
    const int gy = y0 - 1 + ey, gx = x0 - 1 + ex;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      // outside the image nothing measures: no contribution
      EXT(0, ey, ex) = -1.0f;
#pragma unroll
      for (int k = 1; k < EF_NEXT; ++k) EXT(k, ey, ex) = 0.0f;
      continue;
    }
    const float* px = chan + (long long)gy * W + gx;
    const float z = px[8 * HW];
    const float nlx = px[9 * HW], nly = px[10 * HW], nlz = px[11 * HW];
    const bool measuring = px[12 * HW] > 0.0f;
    const float conf = px[13 * HW];
    const float rad_new = px[14 * HW];

    const float xl = ((float)gx - cx) / fx;
    const float yl = ((float)gy - cy) / fy;
    const float lam = sqrtf(xl * xl + yl * yl + 1.0f);
    const float nl_norm = sqrtf(nlx * nlx + nly * nly + nlz * nlz);

    float best_dist = 1000.0f, best_id = cap, best_rad = 0.0f;
    float best_off = -1.0f;
    int oi = 0;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx, ++oi) {
        const int sy = ey + dy, sx = ex + dx;   // (gy+dy-1, gx+dx-1) in cand
        const float cand1 = CAND(0, sy, sx);    // index + 1; 0 = empty / halo
        const float vcx = CAND(1, sy, sx), vcy = CAND(2, sy, sx);
        const float vcz = CAND(3, sy, sx);
        const float ncx = CAND(4, sy, sx), ncy = CAND(5, sy, sx);
        const float ncz = CAND(6, sy, sx);
        const bool has = cand1 > 0.0f;
        // depth along ray agreement (data.vert:142)
        const bool depth_ok = fabsf(vcz * lam - z * lam) < 0.05f;
        // perpendicular point-to-ray distance (data.vert:144)
        const float c0 = yl * vcz - vcy;
        const float c1 = vcx - xl * vcz;
        const float c2 = xl * vcy - yl * vcx;
        const float dist = sqrtf(c0 * c0 + c1 * c1 + c2 * c2) / lam;
        // normal compatibility unless grazing (data.vert:148)
        const float nn = ncx * nlx + ncy * nly + ncz * nlz;
        const float denom = fmaxf(
            sqrtf(ncx * ncx + ncy * ncy + ncz * ncz) * nl_norm, 1e-12f);
        const bool norm_ok = (fabsf(ncz) < 0.75f) || (nn / denom > EF_COS_HALF);
        if (has && depth_ok && norm_ok && (dist < best_dist)) {
          best_dist = dist;
          best_id = cand1 - 1.0f;
          best_rad = CAND(7, sy, sx);
          best_off = (float)oi;
        }
      }
    }
    const bool matched = measuring && (best_id < cap);

    const float vlx = xl * z, vly = yl * z;
    const float vgx = r0 * vlx + r1 * vly + r2 * z + t0;
    const float vgy = r3 * vlx + r4 * vly + r5 * z + t1;
    const float vgz = r6 * vlx + r7 * vly + r8 * z + t2;
    const float ngx = r0 * nlx + r1 * nly + r2 * nlz;
    const float ngy = r3 * nlx + r4 * nly + r5 * nlz;
    const float ngz = r6 * nlx + r7 * nly + r8 * nlz;

    const float a = matched ? conf : 0.0f;
    const bool full_m = matched && (rad_new < 1.5f * best_rad);
    const float af = full_m ? a : 0.0f;

    EXT(0, ey, ex) = best_off;
    EXT(1, ey, ex) = a;
    EXT(2, ey, ex) = af;
    EXT(3, ey, ex) = af * vgx;
    EXT(4, ey, ex) = af * vgy;
    EXT(5, ey, ex) = af * vgz;
    EXT(6, ey, ex) = af * px[15 * HW];
    EXT(7, ey, ex) = af * px[16 * HW];
    EXT(8, ey, ex) = af * px[17 * HW];
    EXT(9, ey, ex) = af * ngx;
    EXT(10, ey, ex) = af * ngy;
    EXT(11, ey, ex) = af * ngz;
    EXT(12, ey, ex) = af * rad_new;

    if (ey >= 1 && ey <= EF_TH && ex >= 1 && ex <= EF_TW) {
      float* o = out + (long long)gy * W + gx;
      o[0 * HW] = best_id;
      o[1 * HW] = best_off;
      o[2 * HW] = best_rad;
      o[3 * HW] = matched ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // step 3: gather the contributions whose winning offset points here
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  float acc[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) acc[k] = 0.0f;
  int oi = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx, ++oi) {
      const int qy = 1 + (int)threadIdx.y - dy, qx = 1 + (int)threadIdx.x - dx;
      if (EXT(0, qy, qx) == (float)oi) {
#pragma unroll
        for (int k = 0; k < 12; ++k) acc[k] = acc[k] + EXT(1 + k, qy, qx);
      }
    }
  }
  float* o = out + (long long)y * W + x;
#pragma unroll
  for (int k = 0; k < 12; ++k) o[(4 + k) * HW] = acc[k];
#undef CAND
#undef EXT
}

// chan [18,H,W], par [12] = R row-major | t (device), out [16,H,W]; all f32.
extern "C" int ef_fuse_window(const float* chan, const float* par, float* out,
                              int H, int W, float fx, float fy, float cx,
                              float cy, float cap, void* stream) {
  const int smem_bytes = EF_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fuse_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 block(EF_TW, EF_TH);
  dim3 grid((W + EF_TW - 1) / EF_TW, (H + EF_TH - 1) / EF_TH);
  fuse_window_kernel<<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
      chan, par, out, H, W, fx, fy, cx, cy, cap);
  return (int)cudaGetLastError();
}
