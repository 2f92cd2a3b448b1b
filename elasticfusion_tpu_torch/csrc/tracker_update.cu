// The tracker's control flow on the card: what the host did between two
// Gauss-Newton (or SO(3)) iterations — read the step kernels' normal
// equations, solve them, update the pose, run the exit tests, and upload the
// next iteration's small matrices — as ONE launch of one small block, so that
// a whole pyramid of iterations is a fixed sequence of launches with no host
// read.  The counterpart of the reference's `lax.while_loop` bodies
// (elasticfusion_tpu/tracking.py: `_so3_prealign`'s body, `gn_iter`, and the
// sanity clamp after the last level) and of its on-device 6x6 / 3x3 solves
// (elasticfusion_tpu/ops/odometry.py `solve_6x6`, `solve_3x3`).  No Pallas
// kernel of the reference does this work: XLA compiled it from jnp code.
//
//   ef_so3_update  stage 0: the SO(3) carry's initial state; stage 1: one
//                  pre-alignment iteration's update (Cramer solve, so3_exp,
//                  converged / diverged guards).
//   ef_gn_update   stage 0: the Gauss-Newton carry from the SO(3) rotation
//                  and the previous pose; stage 1: one iteration's update
//                  (ICP / RGB blocks combined with icp_weight, damped unrolled
//                  Cholesky, so3_exp, left-multiplied pose update, the
//                  update-norm and plateau exits, the rgbOnly revert);
//                  stage 2: the translation sanity clamp, orthonormalisation
//                  and the tracking gate's covariance test.
//
// Every stage ends by writing the small matrices the next iteration's step
// kernels read (K R K^-1 and K R for so3_step; T_curr, K R K^-1 and K t for
// icp_step and rgb_residual), with the K of the level that iteration runs at.
// An update whose `active` flag is 0 changes nothing but those matrices and,
// on the last iteration of a level, the per-level reset: the carry after a
// `lax.while_loop` exits.
//
// Arithmetic: one thread does it all, in the order of the plain versions
// (ops/odometry.py `so3_update_plain`, `gn_update_plain`): built with
// -fmad=false, every product and sum is rounded on its own except in the
// matrix products, which are explicit chains of fused multiply-adds as XLA
// and BLAS compute them; divisions and square roots are IEEE round-to-nearest,
// so the plain version on the card gives the same bits.  Bound: launch latency; the
// work is ~2k dependent float operations on < 1 KB.

#include <cuda_runtime.h>

namespace {

// SO(3) carry, floats (ops/odometry.py SO3_CARRY)
constexpr int S3_R = 0, S3_LAST_R = 9, S3_LAST_ERR = 18, S3_LAST_CNT = 19,
              S3_ERR = 20, S3_CNT = 21, S3_BASIS = 22, S3_KRLR = 31,
              S3_KINV = 40;
// Gauss-Newton carry, floats (ops/odometry.py GN_CARRY)
constexpr int GN_RT = 0, GN_TCURR = 16, GN_KRKINV = 32, GN_KT = 41, GN_A = 44,
              GN_B = 80, GN_ICP_ERR = 86, GN_ICP_CNT = 87, GN_RGB_ERR = 88,
              GN_RGB_CNT = 89, GN_ERR_BREAK = 90, GN_PREV_ERR = 91,
              GN_TOUT = 92, GN_COV_OK = 108, GN_ENABLE = 109;
// the step kernels' pack (ops/odometry.py, tracking.py)
constexpr int P_ICP_A = 0, P_ICP_B = 36, P_ICP_SS = 42, P_ICP_CNT = 43,
              P_RGB_A = 44, P_RGB_B = 80, P_RGB_SIGMA = 86, P_RGB_CNT = 87;

constexpr float BIG_SO3 = 1.7e38f;   // 3.4e38 / 2
constexpr float BIG_GN = 3.4e38f;

struct Cam {
  float K[9], Kinv[9];
};

__host__ __device__ Cam make_cam(float fx, float fy, float cx, float cy, float ifx,
                        float ify, float ncx, float ncy) {
  return Cam{{fx, 0.0f, cx, 0.0f, fy, cy, 0.0f, 0.0f, 1.0f},
             {ifx, 0.0f, ncx, 0.0f, ify, ncy, 0.0f, 0.0f, 1.0f}};
}

// C[n,m] = A[n,k] B[k,m], row-major: each entry the chain of fused
// multiply-adds in index order that XLA and BLAS compile a small matrix
// product to (the reference's and the host's rounding)
__device__ void matmul(const float* A, const float* B, float* C, int n, int k,
                       int m) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) {
      float s = A[i * k] * B[j];
      for (int q = 1; q < k; ++q) s = __fmaf_rn(A[i * k + q], B[q * m + j], s);
      C[i * m + j] = s;
    }
}

__device__ void transpose3(const float* R, float* Rt) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = R[j * 3 + i];
}

// 4x4 <- [R t; 0 0 0 1]
__device__ void compose(const float* R, const float* t, float* T) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[i * 4 + 3] = t[i];
  }
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

__device__ void blocks(const float* T, float* R, float* t) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = T[i * 4 + j];
    t[i] = T[i * 4 + 3];
  }
}

// [R^T, -(R^T t)]
__device__ void invert(const float* T, float* Ti) {
  float R[9], t[3], Rt[9], u[3];
  blocks(T, R, t);
  transpose3(R, Rt);
  matmul(Rt, t, u, 3, 3, 1);
  for (int i = 0; i < 3; ++i) u[i] = -u[i];
  compose(Rt, u, Ti);
}

// Rodrigues with the Taylor branch below theta^2 = 1e-8 (se3.so3_exp)
__device__ void so3_exp(const float* w, float* E) {
  const float theta2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const float theta = __fsqrt_rn(theta2);
  const bool small = theta2 < 1e-8f;
  const float a = small ? 1.0f - __fdiv_rn(theta2, 6.0f)
                        : __fdiv_rn(sinf(theta), theta);
  const float b = small ? 0.5f - __fdiv_rn(theta2, 24.0f)
                        : __fdiv_rn(1.0f - cosf(theta), theta2);
  const float K[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  float K2[9];
  matmul(K, K, K2, 3, 3, 3);
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    E[i] = (eye + a * K[i]) + b * K2[i];
  }
}

// Damped 3x3 solve by Cramer's rule (ops/odometry.py solve_3x3)
__device__ void solve3(const float* A0, const float* b, float* x) {
  float A[9];
  for (int i = 0; i < 9; ++i) A[i] = A0[i] + ((i % 4 == 0) ? 1e-12f : 0.0f);
  const float c00 = A[4] * A[8] - A[5] * A[7];
  const float c01 = A[5] * A[6] - A[3] * A[8];
  const float c02 = A[3] * A[7] - A[4] * A[6];
  const float det = (A[0] * c00 + A[1] * c01) + A[2] * c02;
  const float inv_det = __fdiv_rn(1.0f, fabsf(det) > 1e-30f ? det : 1e-30f);
  const float c10 = A[2] * A[7] - A[1] * A[8];
  const float c11 = A[0] * A[8] - A[2] * A[6];
  const float c12 = A[1] * A[6] - A[0] * A[7];
  const float c20 = A[1] * A[5] - A[2] * A[4];
  const float c21 = A[2] * A[3] - A[0] * A[5];
  const float c22 = A[0] * A[4] - A[1] * A[3];
  x[0] = ((c00 * b[0] + c10 * b[1]) + c20 * b[2]) * inv_det;
  x[1] = ((c01 * b[0] + c11 * b[1]) + c21 * b[2]) * inv_det;
  x[2] = ((c02 * b[0] + c12 * b[1]) + c22 * b[2]) * inv_det;
}

// Unrolled Cholesky of (A + 1e-12 I), 6x6: L below the diagonal and the
// reciprocals of its diagonal (ops/odometry.py _chol_solve_unrolled)
__device__ void cholesky6(const float* A0, float (&L)[36], float (&inv_d)[6]) {
  float A[36];
  for (int i = 0; i < 36; ++i) A[i] = A0[i] + ((i % 7 == 0) ? 1e-12f : 0.0f);
  for (int j = 0; j < 6; ++j) {
    float s = A[j * 6 + j];
    for (int k = 0; k < j; ++k) s = s - L[j * 6 + k] * L[j * 6 + k];
    inv_d[j] = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(s, 1e-30f)));
    for (int i = j + 1; i < 6; ++i) {
      float s2 = A[i * 6 + j];
      for (int k = 0; k < j; ++k) s2 = s2 - L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = s2 * inv_d[j];
    }
  }
}

__device__ void solve6(const float* A, const float* b, float* x) {
  float L[36], inv_d[6], y[6];
  cholesky6(A, L, inv_d);
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i * 6 + k] * y[k];
    y[i] = s * inv_d[i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k * 6 + i] * x[k];
    x[i] = s * inv_d[i];
  }
}

// every diagonal entry of (A + 1e-12 I)^-1 below `thresh` (the tracking
// gate, ElasticFusion.cpp:326-344): column c of L^-1 by forward
// substitution, diag_c = sum over rows r >= c of (L^-1)[r][c]^2.  A NaN fails.
__device__ bool covariance_ok(const float* A, float thresh) {
  float L[36], inv_d[6];
  cholesky6(A, L, inv_d);
  bool ok = true;
  for (int c = 0; c < 6; ++c) {
    float X[6];
    X[c] = inv_d[c];
    float diag = X[c] * X[c];
    for (int r = c + 1; r < 6; ++r) {
      float s = L[r * 6 + c] * X[c];
      for (int k = c + 1; k < r; ++k) s = s + L[r * 6 + k] * X[k];
      X[r] = -s * inv_d[r];
      diag = diag + X[r] * X[r];
    }
    ok = ok && (diag < thresh);
  }
  return ok;
}

// SO(3): next iteration's K R K^-1 and K R
__device__ void so3_matrices(float* C, const Cam& cam) {
  float KR[9];
  matmul(cam.K, C + S3_R, KR, 3, 3, 3);
  matmul(KR, cam.Kinv, C + S3_BASIS, 3, 3, 3);
  for (int i = 0; i < 9; ++i) C[S3_KRLR + i] = KR[i];
}

// Gauss-Newton: next iteration's K R K^-1 and K t of the inverse of resultRt
__device__ void gn_matrices(float* C, const Cam& cam) {
  float Ti[16], R[9], t[3], KR[9];
  invert(C + GN_RT, Ti);
  blocks(Ti, R, t);
  matmul(cam.K, R, KR, 3, 3, 3);
  matmul(KR, cam.Kinv, C + GN_KRKINV, 3, 3, 3);
  matmul(cam.K, t, C + GN_KT, 3, 3, 1);
}

__global__ void __launch_bounds__(32) so3_update_kernel(
    int stage, const float* __restrict__ pack, float* __restrict__ C,
    int* __restrict__ active, Cam cam) {
  if (threadIdx.x != 0) return;
  if (stage == 0) {
    for (int i = 0; i < 9; ++i) {
      const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
      C[S3_R + i] = eye;
      C[S3_LAST_R + i] = eye;
      C[S3_KINV + i] = cam.Kinv[i];
    }
    C[S3_LAST_ERR] = BIG_SO3;
    C[S3_LAST_CNT] = BIG_SO3;
    C[S3_ERR] = 0.0f;
    C[S3_CNT] = 0.0f;
    *active = 1;
  } else if (*active != 0) {
    const float g_count = pack[13];
    const float count = fmaxf(g_count, 1.0f);
    const float err = __fdiv_rn(__fsqrt_rn(pack[12]), count);
    const float last_err = C[S3_LAST_ERR], last_cnt = C[S3_LAST_CNT];
    const bool converged = err < last_err && last_cnt == g_count;
    const bool diverged = err > last_err + 0.001f;
    float R[9], next_R[9];
    for (int i = 0; i < 9; ++i) R[i] = C[S3_R + i];
    if (diverged) {
      for (int i = 0; i < 9; ++i) next_R[i] = C[S3_LAST_R + i];
      C[S3_ERR] = last_err;
      C[S3_CNT] = last_cnt;
    } else {
      C[S3_ERR] = err;
      C[S3_CNT] = g_count;
      if (converged) {
        for (int i = 0; i < 9; ++i) next_R[i] = R[i];
      } else {
        float delta[3], E[9];
        solve3(pack, pack + 9, delta);
        so3_exp(delta, E);
        matmul(E, R, next_R, 3, 3, 3);
      }
    }
    for (int i = 0; i < 9; ++i) {
      C[S3_LAST_R + i] = R[i];
      C[S3_R + i] = next_R[i];
    }
    const bool done = converged || diverged;
    if (!done) {
      C[S3_LAST_ERR] = err;
      C[S3_LAST_CNT] = g_count;
    }
    *active = done ? 0 : 1;
  }
  so3_matrices(C, cam);
}

struct GNArgs {
  int icp_on, rgb_on, rgb_only, last_of_level;
  float icp_weight, early_exit, plateau_exit, translation_sanity, cov_threshold;
};

__device__ void gn_step(const float* __restrict__ P, float* __restrict__ C,
                        int* __restrict__ active, const float* __restrict__ T_prev,
                        const GNArgs& g) {
  const float rgb_error =
      g.rgb_on ? __fdiv_rn(__fsqrt_rn(P[P_RGB_SIGMA]),
                           P[P_RGB_CNT] != 0.0f ? P[P_RGB_CNT] : 1.0f)
               : 0.0f;
  const float icp_error =
      g.icp_on ? __fdiv_rn(__fsqrt_rn(P[P_ICP_SS]), fmaxf(P[P_ICP_CNT], 1.0f))
               : 0.0f;
  // rgbOnly divergence (cpp:448-451): keep the pre-update carry and stop
  if (g.rgb_only && rgb_error > C[GN_ERR_BREAK]) {
    *active = 0;
    return;
  }
  float A[36], b[6];
  if (g.icp_on && g.rgb_on) {
    const float w2 = g.icp_weight * g.icp_weight;
    for (int i = 0; i < 36; ++i) A[i] = P[P_RGB_A + i] + w2 * P[P_ICP_A + i];
    for (int i = 0; i < 6; ++i) b[i] = P[P_RGB_B + i] + g.icp_weight * P[P_ICP_B + i];
  } else {
    const int a0 = g.icp_on ? P_ICP_A : P_RGB_A, b0 = g.icp_on ? P_ICP_B : P_RGB_B;
    for (int i = 0; i < 36; ++i) A[i] = P[a0 + i];
    for (int i = 0; i < 6; ++i) b[i] = P[b0 + i];
  }
  float x[6];
  solve6(A, b, x);
  const float total_err = icp_error + rgb_error;
  float sq = x[0] * x[0];
  for (int i = 1; i < 6; ++i) sq = sq + x[i] * x[i];
  bool stop = __fsqrt_rn(sq) < g.early_exit;
  if (g.plateau_exit > 0.0f)
    stop = stop || fabsf(total_err - C[GN_PREV_ERR]) <
                       g.plateau_exit * fmaxf(total_err, 1e-12f);

  // computeUpdateSE3 (OdometryProvider.h:73-96): left-multiply, then
  // currentT = prevT * rgbOdom^-1 (cpp:553-560)
  float E[9], up[16], rt[16], inv[16];
  so3_exp(x + 3, E);
  compose(E, x, up);
  matmul(up, C + GN_RT, rt, 4, 4, 4);
  invert(rt, inv);
  matmul(T_prev, inv, C + GN_TCURR, 4, 4, 4);
  for (int i = 0; i < 16; ++i) C[GN_RT + i] = rt[i];
  C[GN_ICP_ERR] = icp_error;
  C[GN_ICP_CNT] = P[P_ICP_CNT];
  C[GN_RGB_ERR] = rgb_error;
  C[GN_RGB_CNT] = P[P_RGB_CNT];
  for (int i = 0; i < 36; ++i) C[GN_A + i] = A[i];
  for (int i = 0; i < 6; ++i) C[GN_B + i] = b[i];
  C[GN_ERR_BREAK] = rgb_error;
  C[GN_PREV_ERR] = total_err;
  if (stop) *active = 0;
}

__device__ void gn_finish(float* __restrict__ C, const float* __restrict__ T_prev,
                          const GNArgs& g) {
  float R[9], t[3], Rp[9], tp[3];
  blocks(C + GN_TCURR, R, t);
  blocks(T_prev, Rp, tp);
  // sanity clamp, unconditional in the original (cpp:553-558)
  const float d0 = t[0] - tp[0], d1 = t[1] - tp[1], d2 = t[2] - tp[2];
  if (__fsqrt_rn((d0 * d0 + d1 * d1) + d2 * d2) > g.translation_sanity) {
    for (int i = 0; i < 9; ++i) R[i] = Rp[i];
    for (int i = 0; i < 3; ++i) t[i] = tp[i];
  }
  // three Newton-Schulz steps R <- 1.5 R - 0.5 R (R^T R) (se3.orthonormalize)
  for (int it = 0; it < 3; ++it) {
    float Rt[9], RtR[9], P[9];
    transpose3(R, Rt);
    matmul(Rt, R, RtR, 3, 3, 3);
    matmul(R, RtR, P, 3, 3, 3);
    for (int i = 0; i < 9; ++i) R[i] = 1.5f * R[i] - 0.5f * P[i];
  }
  compose(R, t, C + GN_TOUT);
  C[GN_COV_OK] = covariance_ok(C + GN_A, g.cov_threshold) ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(32) gn_update_kernel(
    int stage, const float* __restrict__ pack, float* __restrict__ C,
    int* __restrict__ active, const float* __restrict__ T_prev,
    const float* __restrict__ so3_carry, const int* __restrict__ enable,
    Cam cam, GNArgs g) {
  if (threadIdx.x != 0) return;
  if (stage == 0) {
    float R[9], Rp[9], tp[3];
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 9; ++i)
      R[i] = so3_carry != nullptr ? so3_carry[S3_R + i] : ((i % 4 == 0) ? 1.0f : 0.0f);
    compose(R, zero3, C + GN_RT);
    blocks(T_prev, Rp, tp);
    compose(Rp, tp, C + GN_TCURR);
    for (int i = GN_A; i < GN_ERR_BREAK; ++i) C[i] = 0.0f;
    C[GN_ERR_BREAK] = BIG_GN;
    C[GN_PREV_ERR] = BIG_GN;
    C[GN_ENABLE] = (enable == nullptr || *enable != 0) ? 1.0f : 0.0f;
    *active = C[GN_ENABLE] != 0.0f ? 1 : 0;
  } else if (stage == 1) {
    if (*active != 0) gn_step(pack, C, active, T_prev, g);
    // the next level starts afresh (cpp:406): stop cleared, FLT_MAX references
    if (g.last_of_level) {
      *active = C[GN_ENABLE] != 0.0f ? 1 : 0;
      C[GN_ERR_BREAK] = BIG_GN;
      C[GN_PREV_ERR] = BIG_GN;
    }
  } else {
    gn_finish(C, T_prev, g);
    return;
  }
  gn_matrices(C, cam);
}

}  // namespace

// Launchers: one block of 32 threads.  Every pointer is device memory;
// `so3_carry` and `enable` may be null (identity rotation, always enabled).
// Each returns cudaGetLastError().
extern "C" int ef_so3_update(int stage, const float* pack, float* carry,
                             int* active, float fx, float fy, float cx,
                             float cy, float ifx, float ify, float ncx,
                             float ncy, void* stream) {
  so3_update_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      stage, pack, carry, active, make_cam(fx, fy, cx, cy, ifx, ify, ncx, ncy));
  return (int)cudaGetLastError();
}

extern "C" int ef_gn_update(int stage, const float* pack, float* carry,
                            int* active, const float* T_prev,
                            const float* so3_carry, const int* enable, float fx,
                            float fy, float cx, float cy, float ifx, float ify,
                            float ncx, float ncy, int icp_on, int rgb_on,
                            int rgb_only, int last_of_level, float icp_weight,
                            float early_exit, float plateau_exit,
                            float translation_sanity, float cov_threshold,
                            void* stream) {
  const GNArgs g{icp_on, rgb_on, rgb_only, last_of_level, icp_weight,
                 early_exit, plateau_exit, translation_sanity, cov_threshold};
  gn_update_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      stage, pack, carry, active, T_prev, so3_carry, enable,
      make_cam(fx, fy, cx, cy, ifx, ify, ncx, ncy), g);
  return (int)cudaGetLastError();
}
