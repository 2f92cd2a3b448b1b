// The Gauss-Newton steps of frame-to-model tracking, each as ONE launch that
// builds a pixel's normal-equation row [J | r] in registers and reduces
// rows * rows^T over the image in the same kernel:
//   ef_icp_step      point-to-plane projective ICP   (ops/odometry.py icp_step),
//                    on a float32 model table or on the u16 fixed-point one
//   ef_rgb_residual  photometric correspondence      (compute_rgb_residual)
//   ef_rgb_step      photometric Jacobian rows       (rgb_step)
//   ef_so3_step      rotation-only Lucas-Kanade      (so3_step)
//
// On the tracker's path they replace the Pallas kernel `gram_outer_pallas`
// (elasticfusion_tpu/ops/gram_pallas.py) together with the chain of
// elementwise operations that wrote its [7,N] input: the rows never reach
// device memory.  This is the design of the original system's
// Core/Cuda/reduce.cu (icpStep / computeRgbResidual / rgbStep); the
// arithmetic follows the plain PyTorch versions operation for operation.
//
// One thread per pixel, grid-stride; the 28 upper-triangle sums of the 7x7
// Gram matrix (plus the inlier count, kept as a float: an exact integer below
// 2^24) live in registers; the grid-wide sum is finished in the same launch
// by the block that ends last (gram_reduce.cuh), in a fixed order and with no
// float atomics, so results repeat bit for bit.  Results go straight into the
// caller's slice of the iteration's pack buffer, which the Gauss-Newton update
// of tracker_update.cu reads on the card.
//
// Bound: bytes (ICP reads 6 floats per pixel and gathers 6; the RGB pair
// reads a gate byte per pixel and 5-7 floats per pixel that passes it) against
// ~150 flops per pixel.  The SO(3) step runs at 160x120 on two 76.8 KB
// images: its bound is ~0.05 us, and it sits on one launch's latency by design.  Built with -fmad=false so that the gates (distance,
// angle, depth difference) see products and sums rounded one by one as in the
// plain versions; the 3-term dot products that the plain versions leave to a
// matrix product, and the Gram sums, are written as explicit fmaf chains.
//
// Small matrices (poses, K R K^-1, K t) are read from device memory, where
// the previous launch of tracker_update.cu wrote them.
//
// Every step is predicated on a device flag `active` (the tracker's
// `lax.while_loop` condition of the reference, elasticfusion_tpu/tracking.py):
// when *active == 0 every block returns before it writes anything.  No block
// then draws a reduction ticket, so the counter of gram_reduce.cuh stays at
// the 0 that its last-block `atomicInc` wrapped it back to.  A level's
// iterations are thus a fixed sequence of launches, and an iteration after
// the loop's exit changes nothing.

#include "gram_reduce.cuh"

#define EF_STEP_BOUNDS __launch_bounds__(EF_RED_THREADS, 2)

struct Vec3 {
  float x, y, z;
};

// (M v)_i = sum_k M[i][k] v_k as the fmaf chain of a matrix product; M is a
// row-major 3x3 block with row stride `ld`.
__device__ __forceinline__ Vec3 mat_vec(const float* M, int ld, Vec3 v) {
  Vec3 r;
  r.x = fmaf(M[2], v.z, fmaf(M[1], v.y, M[0] * v.x));
  r.y = fmaf(M[ld + 2], v.z, fmaf(M[ld + 1], v.y, M[ld] * v.x));
  r.z = fmaf(M[2 * ld + 2], v.z, fmaf(M[2 * ld + 1], v.y, M[2 * ld] * v.x));
  return r;
}

// The same with the transpose of M (the inverse of a rotation).
__device__ __forceinline__ Vec3 mat_t_vec(const float* M, int ld, Vec3 v) {
  Vec3 r;
  r.x = fmaf(M[2 * ld], v.z, fmaf(M[ld], v.y, M[0] * v.x));
  r.y = fmaf(M[2 * ld + 1], v.z, fmaf(M[ld + 1], v.y, M[1] * v.x));
  r.z = fmaf(M[2 * ld + 2], v.z, fmaf(M[ld + 2], v.y, M[2] * v.x));
  return r;
}

__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) {
  return Vec3{a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return Vec3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Round half to even and test the image bounds while still a float: a
// projection through a tiny z can exceed every integer type, and NaN fails
// every comparison, so both are rejected as the plain version rejects them.
__device__ __forceinline__ bool project_in_image(float uf, float vf, int W,
                                                 int H, int* flat) {
  const float ur = rintf(uf), vr = rintf(vf);
  if (!(ur >= 0.0f && vr >= 0.0f && ur < (float)W && vr < (float)H))
    return false;
  *flat = (int)vr * W + (int)ur;
  return true;
}

// Last block only: the 7x7 triangle sums as A (6x6, mirrored) and b (6) into
// out_Ab[0..42), the sum of squared residuals (entry (6,6)) into *sum_sq.
__device__ __forceinline__ void write_normal_equations(
    const float* sums, float* __restrict__ out_Ab, float* __restrict__ sum_sq) {
  const int idx = threadIdx.x;
  if (idx < 36)
    out_Ab[idx] = sums[ef_triangle_index(idx / 6, idx % 6, 7)];
  else if (idx < 42)
    out_Ab[idx] = sums[ef_triangle_index(idx - 36, 6, 7)];
  else if (idx == 42)
    *sum_sq = sums[ef_triangle_index(6, 6, 7)];
}

// ---------------------------------------------------------------------------
// ICP step.  out[44] = A(36) b(6) sum_sq count.
//
// The model table comes in the two forms of ops/odometry.py icp_prev_table:
//   FX16 = false: [6,N] float32 planes, vertex | normal;
//   FX16 = true:  [3,N] 32-bit words of two u16 codes each (channel 2k in the
//                 low half of word k, 2k+1 in the high half), decoded
//                 code * scale[c] + lo[c] with ONE rounding, as the reference's
//                 compiler fuses it (this file is built with -fmad=false, so
//                 only the explicit intrinsic gives one rounding).  A decoded
//                 zero is +-scale/2 of noise: the model pixel is valid by its
//                 normal alone, |n|^2 > 1e-2, as in the reference.
// The 12 range floats are read once per block into shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fx16_decode(unsigned int code, float scale,
                                             float lo) {
  return __fmaf_rn((float)code, scale, lo);
}

template <bool FX16>
__device__ __forceinline__ bool fetch_model(const void* __restrict__ table,
                                            const float* range, int N,
                                            int flat, Vec3* vprev,
                                            Vec3* nprev) {
  if constexpr (FX16) {
    const unsigned int* w = static_cast<const unsigned int*>(table);
    const unsigned int w0 = w[flat], w1 = w[N + flat], w2 = w[2 * N + flat];
    // range = los[0..6) | scales[0..6)
    *vprev = Vec3{fx16_decode(w0 & 0xFFFFu, range[6], range[0]),
                  fx16_decode(w0 >> 16, range[7], range[1]),
                  fx16_decode(w1 & 0xFFFFu, range[8], range[2])};
    *nprev = Vec3{fx16_decode(w1 >> 16, range[9], range[3]),
                  fx16_decode(w2 & 0xFFFFu, range[10], range[4]),
                  fx16_decode(w2 >> 16, range[11], range[5])};
    return dot(*nprev, *nprev) > 1e-2f;
  } else {
    const float* t = static_cast<const float*>(table);
    *vprev = Vec3{t[flat], t[N + flat], t[2 * N + flat]};
    *nprev = Vec3{t[3 * N + flat], t[4 * N + flat], t[5 * N + flat]};
    return dot(*vprev, *vprev) > 0.0f && dot(*nprev, *nprev) > 1e-12f;
  }
}

template <bool FX16>
__global__ void EF_STEP_BOUNDS icp_step_kernel(
    const int* __restrict__ active,        // 0: return before any write
    const float* __restrict__ T_curr,      // [4,4] world <- current camera
    const float* __restrict__ T_prev,      // [4,4] world <- previous camera
    const float* __restrict__ vmap_curr,   // [3,N] camera frame
    const float* __restrict__ nmap_curr,   // [3,N]
    const void* __restrict__ prev_table,   // model vertex | normal, world
    const float* __restrict__ los,         // [6] (FX16 only)
    const float* __restrict__ scales,      // [6] (FX16 only)
    int H, int W, float fx, float fy, float cx, float cy, float dist_thresh,
    float angle_thresh_sin, float* __restrict__ partials, unsigned int* ticket,
    float* __restrict__ out) {
  if (*active == 0) return;
  constexpr int T = 29;
  __shared__ float Tc[12], Tp[12];
  __shared__ float range[FX16 ? 12 : 1];
  if (threadIdx.x < 12) Tc[threadIdx.x] = T_curr[threadIdx.x];
  else if (threadIdx.x < 24) Tp[threadIdx.x - 12] = T_prev[threadIdx.x - 12];
  if constexpr (FX16) {
    if (threadIdx.x >= 32 && threadIdx.x < 38) range[threadIdx.x - 32] = los[threadIdx.x - 32];
    else if (threadIdx.x >= 38 && threadIdx.x < 44) range[threadIdx.x - 32] = scales[threadIdx.x - 38];
  }
  __syncthreads();
  const Vec3 tc{Tc[3], Tc[7], Tc[11]}, tp{Tp[3], Tp[7], Tp[11]};

  float tri[28];
#pragma unroll
  for (int t = 0; t < 28; ++t) tri[t] = 0.0f;
  float count = 0.0f;

  const int N = H * W;
  for (int i = blockIdx.x * EF_RED_THREADS + threadIdx.x; i < N;
       i += gridDim.x * EF_RED_THREADS) {
    const Vec3 v{vmap_curr[i], vmap_curr[N + i], vmap_curr[2 * N + i]};
    const Vec3 n{nmap_curr[i], nmap_curr[N + i], nmap_curr[2 * N + i]};
    if (!(v.z > 0.0f && dot(n, n) > 1e-12f)) continue;

    Vec3 v_g = mat_vec(Tc, 4, v);                        // world
    v_g = Vec3{v_g.x + tc.x, v_g.y + tc.y, v_g.z + tc.z};
    const Vec3 s_cp = mat_t_vec(Tp, 4, sub(v_g, tp));    // previous camera
    const float z = s_cp.z;
    const float safe_z = fabsf(z) > 1e-12f ? z : 1.0f;
    int flat;
    if (!project_in_image(s_cp.x * fx / safe_z + cx, s_cp.y * fy / safe_z + cy,
                          W, H, &flat) || !(z >= 0.0f))
      continue;

    Vec3 vprev, nprev;
    if (!fetch_model<FX16>(prev_table, range, N, flat, &vprev, &nprev))
      continue;

    const Vec3 n_g = mat_vec(Tc, 4, n);
    const Vec3 dv = sub(vprev, v_g);
    const float dist = sqrtf(dot(dv, dv));
    const Vec3 cr = cross(n_g, nprev);
    const float sine = sqrtf(dot(cr, cr));
    if (!(sine < angle_thresh_sin && dist <= dist_thresh)) continue;

    // row [n | s x n | n.(s - d)] in the previous camera's frame
    const Vec3 d_cp = mat_t_vec(Tp, 4, sub(vprev, tp));
    const Vec3 n_cp = mat_t_vec(Tp, 4, nprev);
    const Vec3 sxn = cross(s_cp, n_cp);
    const float row[7] = {n_cp.x, n_cp.y, n_cp.z, sxn.x,
                          sxn.y,  sxn.z,  dot(n_cp, sub(s_cp, d_cp))};
    ef_accumulate_triangle<7>(row, tri);
    count += 1.0f;
  }

  float acc[T];
#pragma unroll
  for (int t = 0; t < 28; ++t) acc[t] = tri[t];
  acc[28] = count;
  if (!ef_reduce_to_last_block<T>(acc, partials, ticket)) return;
  const float* sums = ef_sum_partials<T>(partials);
  write_normal_equations(sums, out, out + 42);
  if (threadIdx.x == 43) out[43] = sums[28];
}

// The fixed-point table decoded whole, [3,N] words -> [6,N] floats, with the
// decode of icp_step_kernel<true>: lets a check hold the kernel's decoded
// values against the plain version's.  Not on any path of the engine.
__global__ void fx16_decode_kernel(const unsigned int* __restrict__ words,
                                   const float* __restrict__ los,
                                   const float* __restrict__ scales, int N,
                                   float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const unsigned int w = words[(c >> 1) * N + i];
      out[c * N + i] =
          fx16_decode((c & 1) ? (w >> 16) : (w & 0xFFFFu), scales[c], los[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// RGB residual.  stats[2] = sum of diff^2, count.  Per pixel it leaves the
// correspondence for ef_rgb_step: flat index of the matched pixel of the last
// image (-1: no match) and the intensity difference next - last.
// ---------------------------------------------------------------------------

__global__ void EF_STEP_BOUNDS rgb_residual_kernel(
    const int* __restrict__ active,
    const unsigned char* __restrict__ gates,  // [N] pose-independent gates
    const float* __restrict__ next_depth,     // [N]
    const float* __restrict__ next_image,     // [N]
    const float* __restrict__ last_table,     // [>=2, N] last depth | intensity
    const float* __restrict__ krkinv,         // [3,3] K R K^-1
    const float* __restrict__ kt,             // [3]   K t
    int H, int W, float max_depth_delta, int* __restrict__ flat0_out,
    float* __restrict__ diff_out, float* __restrict__ partials,
    unsigned int* ticket, float* __restrict__ stats) {
  if (*active == 0) return;
  constexpr int T = 2;
  __shared__ float M[12];
  if (threadIdx.x < 9) M[threadIdx.x] = krkinv[threadIdx.x];
  else if (threadIdx.x < 12) M[threadIdx.x] = kt[threadIdx.x - 9];
  __syncthreads();

  float acc[T] = {0.0f, 0.0f};
  const int N = H * W;
  for (int i = blockIdx.x * EF_RED_THREADS + threadIdx.x; i < N;
       i += gridDim.x * EF_RED_THREADS) {
    int flat0 = -1;
    float diff = 0.0f;
    if (gates[i]) {
      const int yi = i / W;
      const float x = (float)(i - yi * W), y = (float)yi;
      const float d1 = next_depth[i];
      const float td1 = d1 * (M[6] * x + M[7] * y + M[8]) + M[11];
      const float safe = fabsf(td1) > 1e-12f ? td1 : 1.0f;
      const float uf = (d1 * (M[0] * x + M[1] * y + M[2]) + M[9]) / safe;
      const float vf = (d1 * (M[3] * x + M[4] * y + M[5]) + M[10]) / safe;
      int f;
      if (project_in_image(uf, vf, W, H, &f)) {
        const float d0 = last_table[f], last_i = last_table[N + f];
        if (d0 > 0.0f && fabsf(td1 - d0) <= max_depth_delta && last_i != 0.0f) {
          flat0 = f;
          diff = next_image[i] - last_i;
          acc[0] += diff * diff;
          acc[1] += 1.0f;
        }
      }
    }
    flat0_out[i] = flat0;
    diff_out[i] = diff;
  }

  if (!ef_reduce_to_last_block<T>(acc, partials, ticket)) return;
  const float* sums = ef_sum_partials<T>(partials);
  if (threadIdx.x < 2) stats[threadIdx.x] = sums[threadIdx.x];
}

// ---------------------------------------------------------------------------
// RGB step.  out_Ab[42] = A(36) b(6); *sum_sq = sum of (w diff)^2.  The
// weight's sigma is *sigma when that pointer is given; otherwise it is derived
// here from stats (sum of diff^2, count) as the original does
// (RGBDOdometry.cpp:441, whose operator precedence makes it sqrt(count)
// unless the sum or the count is 0), so no host read sits between the two
// RGB kernels.
// ---------------------------------------------------------------------------

__global__ void EF_STEP_BOUNDS rgb_step_kernel(
    const int* __restrict__ active, const int* __restrict__ flat0_in,
    const float* __restrict__ diff_in,
    const float* __restrict__ stats, const float* __restrict__ sigma_ptr,
    const float* __restrict__ cloud,  // [3,N] back-projected last depth
    const float* __restrict__ dIdx, const float* __restrict__ dIdy, int N,
    float fx, float fy, float sobel_scale, float* __restrict__ partials,
    unsigned int* ticket, float* __restrict__ out_Ab,
    float* __restrict__ sum_sq) {
  if (*active == 0) return;
  constexpr int T = 28;
  float sigma;
  if (sigma_ptr != nullptr) {
    sigma = *sigma_ptr;
  } else {
    const float sum = stats[0], cnt = stats[1];
    sigma = sqrtf(cnt == 0.0f ? 0.0f : (sum == 0.0f ? 1.0f : cnt));
  }
  const bool even = sigma == -1.0f;

  float acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.0f;

  for (int i = blockIdx.x * EF_RED_THREADS + threadIdx.x; i < N;
       i += gridDim.x * EF_RED_THREADS) {
    const int f = flat0_in[i];
    if (f < 0) continue;
    const float diff = diff_in[i];
    float w = sigma + fabsf(diff);
    w = w > 1.19209290e-07f ? 1.0f / w : 1.0f;
    if (even) w = 1.0f;

    const Vec3 p{cloud[f], cloud[N + f], cloud[2 * N + f]};
    const float safe_z = fabsf(p.z) > 1e-12f ? p.z : 1.0f;
    const float invz = 1.0f / safe_z;
    const float ws = w * sobel_scale;
    const float gx = dIdx[i] * ws, gy = dIdy[i] * ws;
    const float v0 = gx * fx * invz;
    const float v1 = gy * fy * invz;
    const float v2 = -(v0 * p.x + v1 * p.y) * invz;
    const float row[7] = {v0,
                          v1,
                          v2,
                          -p.z * v1 + p.y * v2,
                          p.z * v0 - p.x * v2,
                          -p.y * v0 + p.x * v1,
                          -w * diff};
    ef_accumulate_triangle<7>(row, acc);
  }

  if (!ef_reduce_to_last_block<T>(acc, partials, ticket)) return;
  write_normal_equations(ef_sum_partials<T>(partials), out_Ab, sum_sq);
}

// ---------------------------------------------------------------------------
// SO(3) step.  out[14] = A(9, 3x3 row-major) b(3) sum_sq count.  Per pixel:
// warp the pixel by K R K^-1, round half to even, gate on both pixels lying
// in the interior, read the four neighbours straight from the two images (the
// gates keep every read inside), and build the row [J | r] of
// SO3Reduction::getProducts (reduce.cu:820-896) with the plain version's
// arithmetic: gradients in the reference's (back - fore)/2 form.
// ---------------------------------------------------------------------------

__global__ void EF_STEP_BOUNDS so3_step_kernel(
    const int* __restrict__ active,
    const float* __restrict__ last_image,  // [H,W] intensity
    const float* __restrict__ next_image,  // [H,W]
    const float* __restrict__ basis,       // [3,3] K R K^-1
    const float* __restrict__ kinv,        // [3,3]
    const float* __restrict__ krlr,        // [3,3] K R
    int H, int W, float* __restrict__ partials, unsigned int* ticket,
    float* __restrict__ out) {
  if (*active == 0) return;
  constexpr int T = 11;
  __shared__ float M[27];
  if (threadIdx.x < 9) M[threadIdx.x] = basis[threadIdx.x];
  else if (threadIdx.x < 18) M[threadIdx.x] = kinv[threadIdx.x - 9];
  else if (threadIdx.x < 27) M[threadIdx.x] = krlr[threadIdx.x - 18];
  __syncthreads();
  const float* KRL = M + 18;

  float tri[10];
#pragma unroll
  for (int t = 0; t < 10; ++t) tri[t] = 0.0f;
  float count = 0.0f;

  const int N = H * W;
  for (int i = blockIdx.x * EF_RED_THREADS + threadIdx.x; i < N;
       i += gridDim.x * EF_RED_THREADS) {
    const int yi = i / W, xi = i - yi * W;
    if (!(xi >= 1 && xi < W - 1 && yi >= 1 && yi < H - 1)) continue;
    const float x = (float)xi, y = (float)yi;
    const Vec3 ref{x, y, 1.0f};
    const Vec3 w = mat_vec(M, 3, ref);
    const float safe_wz = fabsf(w.z) > 1e-12f ? w.z : 1.0f;
    const float ur = rintf(w.x / safe_wz), vr = rintf(w.y / safe_wz);
    if (!(ur >= 1.0f && ur < (float)(W - 1) && vr >= 1.0f && vr < (float)(H - 1)))
      continue;
    const int f = (int)vr * W + (int)ur;

    const float n_at = next_image[f];
    const float gnx = (next_image[f - 1] - next_image[f + 1]) * 0.5f;
    const float gny = (next_image[f - W] - next_image[f + W]) * 0.5f;
    const float l_at = last_image[i];
    const float glx = (last_image[i - 1] - last_image[i + 1]) * 0.5f;
    const float gly = (last_image[i - W] - last_image[i + W]) * 0.5f;
    const float gx = (gnx + glx) * 0.5f;
    const float gy = (gny + gly) * 0.5f;

    const Vec3 p = mat_vec(M + 9, 3, ref);
    const float z2 = p.z * p.z;
    const Vec3 lp{
        (p.z * (KRL[3] * gy + KRL[0] * gx) - gy * KRL[6] * y - gx * KRL[6] * x) / z2,
        (p.z * (KRL[4] * gy + KRL[1] * gx) - gy * KRL[7] * y - gx * KRL[7] * x) / z2,
        (p.z * (KRL[5] * gy + KRL[2] * gx) - gy * KRL[8] * y - gx * KRL[8] * x) / z2};
    const Vec3 jac = cross(lp, p);
    const float row[4] = {jac.x, jac.y, jac.z, -(n_at - l_at)};
    ef_accumulate_triangle<4>(row, tri);
    count += 1.0f;
  }

  float acc[T];
#pragma unroll
  for (int t = 0; t < 10; ++t) acc[t] = tri[t];
  acc[10] = count;
  if (!ef_reduce_to_last_block<T>(acc, partials, ticket)) return;
  const float* sums = ef_sum_partials<T>(partials);
  const int idx = threadIdx.x;
  if (idx < 9)
    out[idx] = sums[ef_triangle_index(idx / 3, idx % 3, 4)];
  else if (idx < 12)
    out[idx] = sums[ef_triangle_index(idx - 9, 3, 4)];
  else if (idx < 14)
    out[idx] = sums[idx - 3];  // sum_sq = entry (3,3), then the count
}

// ---------------------------------------------------------------------------
// Launchers.  Every pointer is device memory; `partials` ([n_blocks, T]
// floats) and `ticket` (one zeroed unsigned) are scratch of ONE launcher.
// Each returns cudaGetLastError().
// ---------------------------------------------------------------------------

// los == scales == nullptr: prev_table is the [6,N] float32 table; both
// given: it is the [3,N] fixed-point words with their [6] ranges.
extern "C" int ef_icp_step(const int* active, const float* T_curr,
                           const float* T_prev,
                           const float* vmap_curr, const float* nmap_curr,
                           const void* prev_table, const float* los,
                           const float* scales, int H, int W, float fx,
                           float fy, float cx, float cy, float dist_thresh,
                           float angle_thresh_sin, float* partials,
                           unsigned int* ticket, int n_blocks, float* out,
                           void* stream) {
  if (los != nullptr)
    icp_step_kernel<true><<<n_blocks, EF_RED_THREADS, 0, (cudaStream_t)stream>>>(
        active, T_curr, T_prev, vmap_curr, nmap_curr, prev_table, los, scales, H, W,
        fx, fy, cx, cy, dist_thresh, angle_thresh_sin, partials, ticket, out);
  else
    icp_step_kernel<false><<<n_blocks, EF_RED_THREADS, 0, (cudaStream_t)stream>>>(
        active, T_curr, T_prev, vmap_curr, nmap_curr, prev_table, los, scales, H, W,
        fx, fy, cx, cy, dist_thresh, angle_thresh_sin, partials, ticket, out);
  return (int)cudaGetLastError();
}

extern "C" int ef_fx16_decode(const unsigned int* words, const float* los,
                              const float* scales, int N, float* out,
                              void* stream) {
  fx16_decode_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      words, los, scales, N, out);
  return (int)cudaGetLastError();
}

extern "C" int ef_rgb_residual(const int* active, const unsigned char* gates,
                               const float* next_depth, const float* next_image,
                               const float* last_table, const float* krkinv,
                               const float* kt, int H, int W,
                               float max_depth_delta, int* flat0_out,
                               float* diff_out, float* partials,
                               unsigned int* ticket, int n_blocks, float* stats,
                               void* stream) {
  rgb_residual_kernel<<<n_blocks, EF_RED_THREADS, 0, (cudaStream_t)stream>>>(
      active, gates, next_depth, next_image, last_table, krkinv, kt, H, W,
      max_depth_delta, flat0_out, diff_out, partials, ticket, stats);
  return (int)cudaGetLastError();
}

extern "C" int ef_rgb_step(const int* active, const int* flat0, const float* diff,
                           const float* stats, const float* sigma,
                           const float* cloud, const float* dIdx,
                           const float* dIdy, int N, float fx, float fy,
                           float sobel_scale, float* partials,
                           unsigned int* ticket, int n_blocks, float* out_Ab,
                           float* sum_sq, void* stream) {
  rgb_step_kernel<<<n_blocks, EF_RED_THREADS, 0, (cudaStream_t)stream>>>(
      active, flat0, diff, stats, sigma, cloud, dIdx, dIdy, N, fx, fy, sobel_scale,
      partials, ticket, out_Ab, sum_sq);
  return (int)cudaGetLastError();
}

extern "C" int ef_so3_step(const int* active, const float* last_image,
                           const float* next_image,
                           const float* basis, const float* kinv,
                           const float* krlr, int H, int W, float* partials,
                           unsigned int* ticket, int n_blocks, float* out,
                           void* stream) {
  so3_step_kernel<<<n_blocks, EF_RED_THREADS, 0, (cudaStream_t)stream>>>(
      active, last_image, next_image, basis, kinv, krlr, H, W, partials, ticket, out);
  return (int)cudaGetLastError();
}
