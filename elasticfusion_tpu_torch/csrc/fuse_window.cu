// K3: fuse window, the 3x3 association search of the data pass plus the
// accumulation of the 12 contribution images at the winning pixel.
//
// Replaces the Pallas kernel `_window_kernel` / `fuse_window`
// (elasticfusion_tpu/ops/fuse_pallas.py).  Bound: bytes (18 channels read,
// 16 written: 41.8 MB at 640x480), with the arithmetic close behind (per ring
// pixel 9 candidates, each up to 2 IEEE divisions and 2 square roots).
//
// Design (Hopper): a persistent grid, as many blocks as fit on the card, each
// walking image tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...  A tile's
// inputs arrive in shared memory by TMA, two boxes of one 3-D tensor map each
// ([18,H,W] f32; row and plane pitch given, each a multiple of 16 bytes):
//   box A  the 8 candidate channels (index+1, vert, normal, radius) of the
//          tile plus a 2-pixel halo;
//   box B  the 10 measurement channels (z, normal, measuring, conf_new,
//          rad_new, rgb) of the tile plus a 1-pixel ring;
// A box's first column must lie on 16 bytes (a TMA load from any other
// column faults), so both start 4 columns left of the tile (tile widths are
// multiples of 4) and are TW+8 floats wide.  Elements outside the
// image (negative coordinates included) arrive as 0: "index+1 == 0 is empty".
// The loads of the tile STAGES ahead are issued (one thread, completion on an
// mbarrier) as soon as the current tile's boxes have been read, so they run
// while this tile is gathered and the next one searched.  Per tile:
//   step 1  for every pixel q of the tile plus a 1-pixel ring, search q's 3x3
//           window (offsets 0..8, dy outer / dx inner, strict `<` so the first
//           candidate wins ties) and compute q's 12 contribution values;
//           best_off and the contributions go to a 13-channel ring buffer in
//           shared memory, the four association outputs of tile pixels
//           straight to global memory.  A candidate whose index+1 is 0 is
//           skipped before any arithmetic, the normal test is made only for
//           a candidate that would win and only where it can fail
//           (|n'_z| >= 0.75), and both the distance and the normal test are
//           settled on squared sums where a margin far above rounding
//           decides them (`closer_than_best`, `normals_agree`): the plain
//           version's square roots and divisions run only near a tie.  None
//           of this changes a result;
//   step 3  every output pixel w gathers, in offset order, the contributions
//           of the <= 9 neighbours q whose best_off points at w.
// The gather form (not atomicAdd from q) fixes the order of every sum, every
// decision is the plain version's and every value it writes is computed by
// the same operations, so the output is bit-identical to `fuse_window_plain`.
// Surfel ids travel as exact floats (capacity < 2^24).
// The schedule is fixed: 36x11 tiles, 512 threads, 2 TMA stages, 2 blocks per
// SM (at 640x480, 792 tiles = exactly 3 per block of the 264 resident); it
// was the fastest of eleven measured on an H100 (PERF.md, K3 schedules).
//
// Input channels [18,H,W]: index+1, pred vert(3), pred normal(3), pred radius,
//   raw depth z, measurement normal(3), measuring, conf_new, rad_new, rgb(3).
// Output channels [16,H,W]: best_id, best_off, best_rad, matched, then
//   a, a_full, a_full*v_g(3), a_full*rgb(3), a_full*n_g(3), a_full*rad_new.
//
// Built with -fmad=false so the gate comparisons round exactly as in the
// plain PyTorch version.  Needs a 16-byte aligned `chan` whose row and plane
// pitches are multiples of 4 floats (the TMA base and strides); the wrapper
// pads any other layout into such a buffer, so any W runs.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EF_NCAND 8
#define EF_NMEAS 10
#define EF_NEXT 13                  // best_off + 12 contributions
#define EF_COS_HALF 0.87758256189f  // cos(0.5 rad), data.vert:148
#define EF_SQ_SHRINK 0.99999904632568359375f       // 1 - 2^-20
#define EF_COS2_HI (EF_COS_HALF * EF_COS_HALF * 1.0000152587890625f)  // (1 + 2^-16)
#define EF_COS2_LO (EF_COS_HALF * EF_COS_HALF * 0.9999847412109375f)  // (1 - 2^-16)

struct FuseTile {
  static constexpr int TW = 36, TH = 11;  // tile
  static constexpr int NT = 512;          // threads per block
  static constexpr int STAGES = 2;        // tiles whose loads are in flight
  static constexpr int MINB = 2;          // blocks per SM asked of ptxas
  static constexpr int EW = TW + 2, EH = TH + 2;  // tile + 1-ring
  static constexpr int SW = TW + 4, SH = TH + 4;  // tile + 2-halo
  // both boxes start at column x0 - 4; halo column 0 is box column CX / MX
  static constexpr int CW = TW + 8, CX = 2;       // box A: x0-4 .. x0+TW+3
  static constexpr int MW = TW + 8, MX = 3;       // box B: the same columns
  static constexpr int CAND = EF_NCAND * SH * CW;
  static constexpr int MEAS = EF_NMEAS * EH * MW;
  // every box starts on 128 bytes
  static constexpr int CAND_PAD = (CAND + 31) / 32 * 32;
  static constexpr int STAGE = CAND_PAD + (MEAS + 31) / 32 * 32;
  static constexpr int RING = EF_NEXT * EH * EW;
  static constexpr unsigned TX_BYTES = (CAND + MEAS) * 4u;
  // dynamic shared memory: the stages, the ring, 128 B to align the base
  static constexpr int SMEM_BYTES = (STAGES * STAGE + RING) * 4 + 128;
};

// A loop of `items` over `nt` threads whose last pass keeps >= nt/2 busy.
constexpr bool last_pass_half_busy(int items, int nt) {
  return items % nt == 0 || items % nt >= nt / 2;
}

static_assert(FuseTile::TW % 4 == 0, "TMA boxes start on 16 bytes: TW % 4 == 0");
static_assert(FuseTile::CW <= 256 && FuseTile::SH <= 256 && FuseTile::EH <= 256,
              "a TMA box dimension holds at most 256 elements");
static_assert(last_pass_half_busy(FuseTile::EH * FuseTile::EW, FuseTile::NT),
              "step 1's last pass must keep at least half the block busy");
static_assert(last_pass_half_busy(FuseTile::TW * FuseTile::TH, FuseTile::NT),
              "step 3's last pass must keep at least half the block busy");
static_assert(FuseTile::MINB * (FuseTile::SMEM_BYTES + 1024) <= 228 * 1024,
              "MINB blocks (each with 1 KB reserved) fit an SM's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of the 3-D map at (x, y, channel), completion counted on `bar`.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int c) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y),
      "r"(c)
      : "memory");
}

// The plain version's `dist < best_dist` for a candidate whose squared sum
// is below the best one's (sq < best_sq), dist = sqrt(sq) / lam rounded
// twice.  sqrt and the division by lam >= 1 round monotonically with relative
// error <= 2^-24 on normal results, so a squared sum 2^-20 below the best
// one's (or below far_sq ~ (1000 lam)^2 * 0.999 while there is no best, whose
// distance is 1000) gives a strictly smaller distance; nearer a tie, or for
// a best sum too small to be normal, both distances are computed as the plain
// version computes them.
__device__ __forceinline__ bool closer_than_best(float sq, float best_sq,
                                                 float far_sq, float lam) {
  if (best_sq == INFINITY) {
    if (sq < far_sq) return true;
    return sqrtf(sq) / lam < 1000.0f;
  }
  if (best_sq >= 1e-30f && sq < best_sq * EF_SQ_SHRINK) return true;
  return sqrtf(sq) / lam < sqrtf(best_sq) / lam;
}

// The plain version's normal test nn / max(sqrt(ncn) * sqrt(nl_sq), 1e-12)
// > cos(0.5) (nn = n'.n, ncn = |n'|^2, nl_sq = |n|^2, each rounded as there).
// A quotient of nn <= 0 (or NaN) fails; otherwise nn^2 against cos^2 * ncn *
// nl_sq with a margin of 2^-16, far above the few roundings on either side,
// decides it while every term is normal; nearer the threshold the quotient is
// computed as the plain version computes it.
__device__ __forceinline__ bool normals_agree(float nn, float ncn,
                                              float nl_sq) {
  if (!(nn > 0.0f)) return false;
  const float p = ncn * nl_sq, nn2 = nn * nn;
  if (p >= 1e-20f && p <= 1e30f && nn2 <= 1e30f) {
    if (nn2 > EF_COS2_HI * p) return true;
    if (nn2 < EF_COS2_LO * p) return false;
  }
  return nn / fmaxf(sqrtf(ncn) * sqrtf(nl_sq), 1e-12f) > EF_COS_HALF;
}

__device__ __forceinline__ void load_tile(float* stage, uint64_t* bar,
                                          const CUtensorMap* map_cand,
                                          const CUtensorMap* map_meas, int t,
                                          int tiles_x) {
  using G = FuseTile;
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  mbar_expect_tx(bar, G::TX_BYTES);
  tma_load_3d(stage, map_cand, bar, tx * G::TW - 4, ty * G::TH - 2, 0);
  tma_load_3d(stage + G::CAND_PAD, map_meas, bar, tx * G::TW - 4,
              ty * G::TH - 1, EF_NCAND);
}

__global__ void __launch_bounds__(FuseTile::NT, FuseTile::MINB)
fuse_window_kernel(const __grid_constant__ CUtensorMap map_cand,
                   const __grid_constant__ CUtensorMap map_meas,
                   const float* __restrict__ par, float* __restrict__ out,
                   int H, int W, int tiles_x, int n_tiles, float fx, float fy,
                   float cx, float cy, float cap) {
  using G = FuseTile;
  constexpr int TW = G::TW, TH = G::TH, NT = G::NT, STAGES = G::STAGES;
  extern __shared__ float smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  // stages [STAGES][box A | box B], then the ring buffer [13][EH][EW]
  float* const smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u) / 4;
  float* const ring = smem + STAGES * G::STAGE;
#define RING(c, e) ring[(c) * (G::EH * G::EW) + (e)]

  const int tid = threadIdx.x;
  const long long HW = (long long)H * W;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < n_tiles)
        load_tile(smem + s * G::STAGE, &full[s], &map_cand, &map_meas,
                          t, tiles_x);
    }
  }
  __syncthreads();

  const float r0 = par[0], r1 = par[1], r2 = par[2];
  const float r3 = par[3], r4 = par[4], r5 = par[5];
  const float r6 = par[6], r7 = par[7], r8 = par[8];
  const float t0 = par[9], t1 = par[10], t2 = par[11];

  int k = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
    const int s = k % STAGES;
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    const int x0 = tx * TW, y0 = ty * TH;
    const float* cand = smem + s * G::STAGE;
    const float* meas = cand + G::CAND_PAD;
#define CAND(c, y, x) cand[((c) * G::SH + (y)) * G::CW + G::CX + (x)]
#define MEAS(c, y, x) meas[((c) * G::EH + (y)) * G::MW + G::MX + (x)]
    mbar_wait(&full[s], (uint32_t)((k / STAGES) & 1));

    // step 1: window search + contributions on tile + 1-ring
    for (int e = tid; e < G::EH * G::EW; e += NT) {
      const int ey = e / G::EW, ex = e - ey * G::EW;
      const int gy = y0 - 1 + ey, gx = x0 - 1 + ex;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
        // outside the image nothing measures: no contribution
        RING(0, e) = -1.0f;
#pragma unroll
        for (int c = 1; c < EF_NEXT; ++c) RING(c, e) = 0.0f;
        continue;
      }
      const float z = MEAS(0, ey, ex);
      const float nlx = MEAS(1, ey, ex), nly = MEAS(2, ey, ex);
      const float nlz = MEAS(3, ey, ex);
      const bool measuring = MEAS(4, ey, ex) > 0.0f;
      const float conf = MEAS(5, ey, ex);
      const float rad_new = MEAS(6, ey, ex);

      const float xl = ((float)gx - cx) / fx;
      const float yl = ((float)gy - cy) / fy;
      const float lam = sqrtf(xl * xl + yl * yl + 1.0f);
      const float zl = z * lam;
      const float far_sq = lam * lam * 1e6f * 0.999f;
      const float nl_sq = nlx * nlx + nly * nly + nlz * nlz;

      // the best candidate's squared sum stands for its distance (INFINITY:
      // none yet, the plain version's bound of 1000)
      float best_sq = INFINITY, best_id = cap, best_rad = 0.0f;
      float best_off = -1.0f;
      int oi = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx, ++oi) {
          const int sy = ey + dy, sx = ex + dx;   // (gy+dy-1, gx+dx-1) in box A
          const float cand1 = CAND(0, sy, sx);    // index + 1; 0 = empty / outside
          if (!(cand1 > 0.0f)) continue;          // the `has` gate
          const float vcz = CAND(3, sy, sx);
          // depth along ray agreement (data.vert:142)
          if (!(fabsf(vcz * lam - zl) < 0.05f)) continue;
          const float vcx = CAND(1, sy, sx), vcy = CAND(2, sy, sx);
          // perpendicular point-to-ray distance (data.vert:144)
          const float c0 = yl * vcz - vcy;
          const float c1 = vcx - xl * vcz;
          const float c2 = xl * vcy - yl * vcx;
          const float sq = c0 * c0 + c1 * c1 + c2 * c2;
          // sqrt and the division by lam round monotonically: a sum no
          // smaller than the best candidate's cannot give a smaller distance
          if (!(sq < best_sq)) continue;
          if (!closer_than_best(sq, best_sq, far_sq, lam)) continue;
          // normal compatibility unless grazing (data.vert:148)
          const float ncz = CAND(6, sy, sx);
          if (!(fabsf(ncz) < 0.75f)) {
            const float ncx = CAND(4, sy, sx), ncy = CAND(5, sy, sx);
            if (!normals_agree(ncx * nlx + ncy * nly + ncz * nlz,
                               ncx * ncx + ncy * ncy + ncz * ncz, nl_sq))
              continue;
          }
          best_sq = sq;
          best_id = cand1 - 1.0f;
          best_rad = CAND(7, sy, sx);
          best_off = (float)oi;
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

      RING(0, e) = best_off;
      RING(1, e) = a;
      RING(2, e) = af;
      RING(3, e) = af * vgx;
      RING(4, e) = af * vgy;
      RING(5, e) = af * vgz;
      RING(6, e) = af * MEAS(7, ey, ex);
      RING(7, e) = af * MEAS(8, ey, ex);
      RING(8, e) = af * MEAS(9, ey, ex);
      RING(9, e) = af * ngx;
      RING(10, e) = af * ngy;
      RING(11, e) = af * ngz;
      RING(12, e) = af * rad_new;

      if (ey >= 1 && ey <= TH && ex >= 1 && ex <= TW) {
        float* o = out + (long long)gy * W + gx;
        o[0] = best_id;
        o[HW] = best_off;
        o[2 * HW] = best_rad;
        o[3 * HW] = matched ? 1.0f : 0.0f;
      }
    }
#undef CAND
#undef MEAS
    // every thread is done with this stage's boxes and the ring is complete
    __syncthreads();
    if (tid == 0) {
      const int tn = t + STAGES * gridDim.x;
      if (tn < n_tiles)
        load_tile(smem + s * G::STAGE, &full[s], &map_cand, &map_meas,
                          tn, tiles_x);
    }

    // step 3: gather the contributions whose winning offset points here
    for (int p = tid; p < TW * TH; p += NT) {
      const int py = p / TW, px = p - py * TW;
      const int y = y0 + py, x = x0 + px;
      if (x >= W || y >= H) continue;
      float acc[12];
#pragma unroll
      for (int c = 0; c < 12; ++c) acc[c] = 0.0f;
      int oi = 0;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx, ++oi) {
          const int q = (1 + py - dy) * G::EW + (1 + px - dx);
          if (RING(0, q) == (float)oi) {
#pragma unroll
            for (int c = 0; c < 12; ++c) acc[c] = acc[c] + RING(1 + c, q);
          }
        }
      }
      float* o = out + (long long)y * W + x;
#pragma unroll
      for (int c = 0; c < 12; ++c) o[(4 + c) * HW] = acc[c];
    }
    // the ring is read out before the next tile's step 1 rewrites it
    __syncthreads();
  }
#undef RING
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Launcher errors that are not a cudaError_t are returned negative.
#define EF_ERR_NO_ENCODER (-100000)
#define EF_ERR_OCCUPANCY (-100001)
#define EF_MAX_DEVICES 64

static EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled map over chan viewed as [18][H][W] f32 (row pitch `pitch`, plane
// pitch `plane`, in floats) with box {bw, bh, bc}; out-of-bounds elements
// read as zero.  Returns 0 or -CUresult.
static int encode_box(CUtensorMap* map, const float* chan, int H, int W,
                      long long pitch, long long plane, int bw, int bh, int bc) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return EF_ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)(EF_NCAND + EF_NMEAS)};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 4u, (cuuint64_t)plane * 4u};
  const cuuint32_t box[3] = {(cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bc};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(chan), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// The resident blocks of the persistent grid on `dev` (SMs x blocks per SM),
// found once per device; the shared-memory attribute is set on the way.
// Returns 0 or an error code.
static int resident_blocks(int dev, int* blocks) {
  static int cached[EF_MAX_DEVICES] = {0};
  if (dev >= 0 && dev < EF_MAX_DEVICES && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fuse_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FuseTile::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fuse_window_kernel, FuseTile::NT, FuseTile::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return EF_ERR_OCCUPANCY;
  *blocks = per_sm * sms;
  if (dev >= 0 && dev < EF_MAX_DEVICES) cached[dev] = *blocks;
  return 0;
}

// chan [18,H,W] with row pitch `pitch` and plane pitch `plane` (floats, each
// a multiple of 4; chan 16-byte aligned), par [12] = R row-major | t (device),
// out [16,H,W] contiguous; all f32.
extern "C" int ef_fuse_window(const float* chan, long long pitch,
                              long long plane, const float* par, float* out,
                              int H, int W, float fx, float fy, float cx,
                              float cy, float cap, void* stream) {
  using G = FuseTile;
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int code = resident_blocks(dev, &blocks);
  if (code != 0) return code;
  // the maps hold chan's address, so they are encoded for every call
  CUtensorMap map_cand, map_meas;
  code = encode_box(&map_cand, chan, H, W, pitch, plane, G::CW, G::SH, EF_NCAND);
  if (code != 0) return code;
  code = encode_box(&map_meas, chan, H, W, pitch, plane, G::MW, G::EH, EF_NMEAS);
  if (code != 0) return code;
  const int tiles_x = (W + G::TW - 1) / G::TW;
  const int n_tiles = tiles_x * ((H + G::TH - 1) / G::TH);
  const int grid = n_tiles < blocks ? n_tiles : blocks;
  fuse_window_kernel<<<grid, G::NT, G::SMEM_BYTES, (cudaStream_t)stream>>>(
      map_cand, map_meas, par, out, H, W, tiles_x, n_tiles, fx, fy, cx, cy, cap);
  return (int)cudaGetLastError();
}
