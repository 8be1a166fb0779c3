// H1a-H1c: the Gauss-Newton loop of the frame-to-model track
// (ops/icp.py track) as hand kernels, for Hopper (sm_90a).
//
// Replaces the XLA code of the reference's track loop
// (vulcan_tpu/ops/icp.py track, :993, its inner lax.fori_loop :1170), not a
// Pallas kernel:
//   H1a icp_associate  associate_depth (:349) and the flat color_assoc
//                      (:800), once an association round;
//   H1b icp_rows       _pp_normal_eqs (:703) and color_rows_fixed (:879)
//                      through _fused_normal_eqs (:753): the 29 stacked
//                      sums of each term, once a GN step and once a level
//                      with the live normals (the degeneracy detector);
//   H1c icp_solve      solve_gn (:983), the c >= 6 gate, SE3.exp(delta) @
//                      pose, and _min_eig_normalized (:931);
//   icp_rows_solve     H1b and H1c in one launch (gn_step_kernel): the
//                      cluster's rank 0 solves the sums it has just added.
//                      The track takes it where its reducer is local; the
//                      sharded track keeps H1b, its reducer, then H1c.
// ops/icp.py keeps the plain PyTorch versions (_associate_plain,
// _rows_plain, _solve_plain); the CPU takes them, the card these kernels.
//
// Arithmetic.  The plain versions write every per-pixel operation out
// element by element (no matmul), and these kernels repeat them in the
// same order with one rounding each (__fmul_rn, __fadd_rn, __fdiv_rn: no
// contraction into FMAs), so a pixel's transform, projection, nearest
// index, validity and decoded model sample are bit-equal to the plain
// version's, and a row's 29 products too.  Only the sums' order differs.
// The 6x6 algebra of H1c is ordinary float32 code (its inputs are sums).
//
// The pose: a (16,) float32 vector on the device, [R row-major (9), t (3),
// err, inliers, level score, geometric score].  H1a and H1b read it, H1c
// writes the next one; no value goes through the host.  The model side is
// a (15,) vector: the model camera's world-to-camera R (9) and t (3), then
// the origin of the packed vertices (3).
//
// What bounds them on the card.  At 480x640 (live 240x320 at the finest
// level's stride 2, and at the middle level) one H1b pass reads ~49 B a
// pixel of geometric inputs and ~29 B of photometric ones: 3.8-6.0 MB,
// 1.1-1.8 us at 3.35 TB/s, for ~150-300 f32 operations a pixel (~0.2-0.3
// us at 67 TFLOP/s).  H1a moves ~70 B a pixel (the gathers hit a model map
// of 1.2-2.0 MB).  Each is about one launch floor (1.74 us) of work: a
// frame's launches are bound by launch latency, which is why they replace
// ~9000 PyTorch operations a frame.  H1c is a chain of dependent 6x6
// algebra on 58 numbers: latency.
//
// H1a's shape.  Two pixels a thread, 256 threads a block, so the finest
// level's 76800 pixels make 150 blocks, more than the card's 132 SMs.  A
// thread issues both pixels' live loads, then both pixels' model gathers,
// before it decodes either, so two dependent chains are in flight a
// thread.  It is launched as a programmatic dependent launch: the live
// vertices and depth, which no kernel ahead of it in the track writes,
// are loaded before griddepcontrol.wait, and the pose (written by the
// solve just ahead of it) after; one warp stages the 27 pose and model
// floats in shared memory for the block.  So its launch and its first
// loads overlap the tail of the kernel that wrote the pose.
//
// H1b's shape.  One launch of one thread-block cluster of 16 CTAs of 512
// threads, one CTA an SM: each CTA sums its pixels and stores its sums into
// the cluster's rank 0 through distributed shared memory, which adds them
// after one barrier and writes the (2, 29) result.  No partial sums go
// through global memory, and no ticket or scratch buffer is shared between
// launches, so two streams (or a CUDA graph and an eager caller) can run it
// at once.  On the H100 its fixed part is ~4.1 us a launch (1.8-1.9 of it
// the launch floor) and the rest the ~180 instructions a pixel on 16 SMs
// (no FMA contraction); clusters of 8 over a whole wave, their partial
// sums added by the last cluster, were slower at the depth-mode levels
// (PERF.md).
//
// H1c's shape.  The algebra runs on a warp: lane i < 6 holds row i of the
// matrix, and the Cholesky factor is formed a column at a time, the pivot
// and L[j][k] going to the other lanes by shuffle.  Each lane sums its
// terms in the serial code's k order, so the factor is the serial code's
// where the compiler contracts the same products.  The triangular solves
// then run in every lane on the factor gathered from the rows: a step of
// a substitution is one multiply-add and one division, and a shuffle in
// that chain would lengthen it.  The division by the diagonal goes
// through its reciprocal, formed once a factor, and two exact-residual
// corrections that round as a division does (div_by): a level score's
// 8-step iteration is 108 of them in a row.  The pose update computes its 12 outputs
// on 12 lanes.  A level's two scores (the summed matrix and the
// geometric one) run on two warps at once.  gn_step_kernel runs this on
// its rank 0 after the cluster's sums, so a GN step is one launch and its
// sums never leave the SM; solve_kernel runs it alone (the sharded track,
// whose reducer adds the ranks' sums between the two).
//
// Determinism.  H1b sums a thread's pixels in order, a warp by a fixed
// butterfly, the warps of a CTA in order and the CTAs in rank order, with
// no float atomics: two runs on the same inputs agree bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"

#include <mutex>
#include <set>

namespace cg = cooperative_groups;

namespace {

constexpr int kAssocThreads = 256;  // H1a's block
constexpr int kAssocPixels = 2;     // H1a's pixels a thread
constexpr int kAssocBlockPixels = kAssocThreads * kAssocPixels;
constexpr int kSolveThreads = 64;   // H1c's warps: a level score each
constexpr int kRowsThreads = 512;   // H1b's CTA: one a streaming multiprocessor
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsCluster = 16;    // H1b's grid: one cluster of 16 CTAs
constexpr int kSums = 29;           // 21 of H, 6 of b, error, count
constexpr int kSlots = 2 * kSums;   // geometric, then photometric
constexpr float kVertexStep = 1.0f / 65536.0f;        // ops/icp.py _VERTEX_SCALE
constexpr float kNormalStep = (float)(1.0 / 511.5);   // _unpack_normals
constexpr float kPhotoStep = (float)(1.0 / 65535.0);  // _PHOTO_SCALE
constexpr float kCoordClamp = 1e7f;                   // ops/dense.py COORD_CLAMP
constexpr unsigned kFullWarp = 0xffffffffu;

// Programmatic dependent launch (sm_90).  A kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it in the stream has finished; wait_for_prior_grid()
// returns once that kernel has finished and its writes are visible (at
// once for a kernel launched without the attribute).  allow_dependents()
// lets such a dependent start launching now rather than at this grid's end.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Rows of the 3x4 transform at p (rotation row-major, then translation),
// each row's products summed left to right, as _affine.
__device__ __forceinline__ void affine(const float* p, float x, float y, float z,
                                       float& ox, float& oy, float& oz) {
  ox = add(add(add(mul(p[0], x), mul(p[1], y)), mul(p[2], z)), p[9]);
  oy = add(add(add(mul(p[3], x), mul(p[4], y)), mul(p[5], z)), p[10]);
  oz = add(add(add(mul(p[6], x), mul(p[7], y)), mul(p[8], z)), p[11]);
}

__device__ __forceinline__ void rotate(const float* p, float x, float y, float z,
                                       float& ox, float& oy, float& oz) {
  ox = add(add(mul(p[0], x), mul(p[1], y)), mul(p[2], z));
  oy = add(add(mul(p[3], x), mul(p[4], y)), mul(p[5], z));
  oz = add(add(mul(p[6], x), mul(p[7], y)), mul(p[8], z));
}

struct Camera {
  float fx, fy, cx, cy;
};

// PinholeCamera.project: z <= 1e-12 projects to -1e9.
__device__ __forceinline__ void project(const Camera& c, float x, float y, float z,
                                        float& u, float& v) {
  const bool bad = z <= 1e-12f;
  const float sz = bad ? 1.0f : z;
  u = bad ? -1e9f : add(dvd(mul(c.fx, x), sz), c.cx);
  v = bad ? -1e9f : add(dvd(mul(c.fy, y), sz), c.cy);
}

__device__ __forceinline__ float clamp_coord(float x) {
  return fminf(fmaxf(x, -kCoordClamp), kCoordClamp);
}

__device__ __forceinline__ float huber(float r, float delta) {
  const float a = fabsf(r);
  // delta / max(a, 1e-12) as PyTorch evaluates a scalar over a tensor:
  // the reciprocal, then the product.
  return a <= delta ? 1.0f : mul(__frcp_rn(fmaxf(a, 1e-12f)), delta);
}

__device__ __forceinline__ int sext21(int q) {
  return static_cast<int>(static_cast<unsigned>(q) << 11) >> 11;
}

__device__ __forceinline__ float decode16(int word, int shift, float lo) {
  return add(mul(static_cast<float>((word >> shift) & 0xFFFF), kPhotoStep), lo);
}

// The per-level scalars of the rows and association kernels.
struct Scalars {
  float depth_min, depth_max;
  float dist2;                // icp_dist_thresh ** 2
  float normal_thresh, huber_delta, rgb_huber_delta, rgb_weight;
};

struct AssocArgs {
  const float* depth;         // (n,) live
  const float* vertices;      // (n, 3) live camera-space
  const float* pose;          // (16,)
  const float* model;         // (15,)
  const int* vpack1;          // (hm, wm) model maps
  const int* vpack2;
  const int* npack;
  const int* wa;              // (hm, wm) photometric words
  const int* wb;
  int n, hm, wm;
  Camera cam;
  Scalars s;
  float* v_m;                 // (n, 3)
  float* n_m;                 // (n, 3)
  uint8_t* ok;                // (n,)
  float* samples;             // (5, n): i_m0, gu, gv, u0, v0
  uint8_t* ok_c;              // (n,)
  unsigned int* launches;     // the launch counter
};

// H1a.  Thread t of block b takes the pixels b * kAssocBlockPixels + t +
// p * kAssocThreads, p < kAssocPixels (each p a coalesced row of the block).
template <bool kGeo, bool kPhoto>
__global__ void __launch_bounds__(kAssocThreads) associate_kernel(AssocArgs a) {
  __shared__ float staged[27];   // the pose's R and t (12), the model side (15)
  const int base = blockIdx.x * kAssocBlockPixels + threadIdx.x;
  // The live maps, which the kernel ahead does not write: load them before
  // waiting for it (the last block's spare threads load a valid pixel and
  // store nothing).
  float x[kAssocPixels], y[kAssocPixels], z[kAssocPixels], dep[kAssocPixels];
#pragma unroll
  for (int p = 0; p < kAssocPixels; ++p) {
    const int i = min(base + p * kAssocThreads, a.n - 1);
    x[p] = __ldg(a.vertices + 3 * i);
    y[p] = __ldg(a.vertices + 3 * i + 1);
    z[p] = __ldg(a.vertices + 3 * i + 2);
    dep[p] = kGeo ? __ldg(a.depth + i) : 0.0f;
  }
  wait_for_prior_grid();
  count_launch(a.launches);   // after the wait: a reset of the counter may be just ahead
  // The pose (the kernel ahead's output) through L2, not the read-only path.
  if (threadIdx.x < 27)
    staged[threadIdx.x] = threadIdx.x < 12 ? __ldcg(a.pose + threadIdx.x)
                                           : __ldcg(a.model + threadIdx.x - 12);
  __syncthreads();
  float pose[12], model[15];
#pragma unroll
  for (int k = 0; k < 12; ++k) pose[k] = staged[k];
#pragma unroll
  for (int k = 0; k < 15; ++k) model[k] = staged[12 + k];

  float u[kAssocPixels], v[kAssocPixels], mz[kAssocPixels];
#pragma unroll
  for (int p = 0; p < kAssocPixels; ++p) {
    float wx, wy, wz, mx, my;
    affine(pose, x[p], y[p], z[p], wx, wy, wz);
    affine(model, wx, wy, wz, mx, my, mz[p]);
    project(a.cam, mx, my, mz[p], u[p], v[p]);
  }

  // Every pixel's gathers issued before any decode.
  int idx[kAssocPixels], p1[kAssocPixels], p2[kAssocPixels], np[kAssocPixels];
  bool inb_g[kAssocPixels];
  int i00[kAssocPixels];
  float fu[kAssocPixels], fv[kAssocPixels];
  bool inb_c[kAssocPixels];
  int wa[kAssocPixels][4], wb[kAssocPixels][4];
#pragma unroll
  for (int p = 0; p < kAssocPixels; ++p) {
    if (kGeo) {
      // associate_depth: the nearest model pixel, round half to even.
      const int ui = static_cast<int>(rintf(clamp_coord(u[p])));
      const int vi = static_cast<int>(rintf(clamp_coord(v[p])));
      inb_g[p] = ui >= 0 && ui < a.wm && vi >= 0 && vi < a.hm;
      idx[p] = min(max(vi, 0), a.hm - 1) * a.wm + min(max(ui, 0), a.wm - 1);
    }
    if (kPhoto) {
      // color_assoc: the 2x2 footprint of the two packed words.
      const float u0f = floorf(u[p]), v0f = floorf(v[p]);
      const int u0 = static_cast<int>(clamp_coord(u0f));
      const int v0 = static_cast<int>(clamp_coord(v0f));
      inb_c[p] = u0 >= 0 && u0 + 1 < a.wm && v0 >= 0 && v0 + 1 < a.hm;
      const int uc = min(max(u0, 0), a.wm - 2), vc = min(max(v0, 0), a.hm - 2);
      fu[p] = sub(u[p], u0f);
      fv[p] = sub(v[p], v0f);
      i00[p] = vc * a.wm + uc;
    }
  }
#pragma unroll
  for (int p = 0; p < kAssocPixels; ++p) {
    if (kGeo) {
      p1[p] = __ldg(a.vpack1 + idx[p]);
      p2[p] = __ldg(a.vpack2 + idx[p]);
      np[p] = __ldg(a.npack + idx[p]);
    }
    if (kPhoto) {
      const int i10 = i00[p] + a.wm;
      wa[p][0] = __ldg(a.wa + i00[p]);
      wa[p][1] = __ldg(a.wa + i00[p] + 1);
      wa[p][2] = __ldg(a.wa + i10);
      wa[p][3] = __ldg(a.wa + i10 + 1);
      wb[p][0] = __ldg(a.wb + i00[p]);
      wb[p][1] = __ldg(a.wb + i00[p] + 1);
      wb[p][2] = __ldg(a.wb + i10);
      wb[p][3] = __ldg(a.wb + i10 + 1);
    }
  }

#pragma unroll
  for (int p = 0; p < kAssocPixels; ++p) {
    const int i = base + p * kAssocThreads;
    if (i >= a.n) continue;
    const bool front = mz[p] > 0.0f;
    if (kGeo) {
      const int qx = p1[p] >> 11;
      const int qy = sext21(((p1[p] & 0x7FF) << 10) | ((p2[p] >> 22) & 0x3FF));
      const int qz = sext21((p2[p] >> 1) & 0x1FFFFF);
      a.v_m[3 * i] = add(mul(static_cast<float>(qx), kVertexStep), model[12]);
      a.v_m[3 * i + 1] = add(mul(static_cast<float>(qy), kVertexStep), model[13]);
      a.v_m[3 * i + 2] = add(mul(static_cast<float>(qz), kVertexStep), model[14]);
      const int n = np[p];
      a.n_m[3 * i] = sub(mul(static_cast<float>((n >> 20) & 0x3FF), kNormalStep), 1.0f);
      a.n_m[3 * i + 1] = sub(mul(static_cast<float>((n >> 10) & 0x3FF), kNormalStep), 1.0f);
      a.n_m[3 * i + 2] = sub(mul(static_cast<float>(n & 0x3FF), kNormalStep), 1.0f);
      a.ok[i] = dep[p] > a.s.depth_min && dep[p] < a.s.depth_max && inb_g[p] &&
                (n >> 30) > 0 && front;
    }
    if (kPhoto) {
      // Their 16-bit halves blended, validity from the tap nearest the
      // warp point.
      const float gu_ = sub(1.0f, fu[p]), gv_ = sub(1.0f, fv[p]);
      const float w00 = mul(gu_, gv_), w01 = mul(fu[p], gv_);
      const float w10 = mul(gu_, fv[p]), w11 = mul(fu[p], fv[p]);
      auto blend = [&](const int* t, int shift, float lo) {
        return add(add(add(mul(w00, decode16(t[0], shift, lo)),
                           mul(w01, decode16(t[1], shift, lo))),
                       mul(w10, decode16(t[2], shift, lo))),
                   mul(w11, decode16(t[3], shift, lo)));
      };
      a.samples[i] = blend(wa[p], 16, 0.0f);
      a.samples[a.n + i] = blend(wa[p], 0, -0.5f);
      a.samples[2 * a.n + i] = blend(wb[p], 16, -0.5f);
      a.samples[3 * a.n + i] = u[p];
      a.samples[4 * a.n + i] = v[p];
      const int vb = fv[p] >= 0.5f ? (fu[p] >= 0.5f ? wb[p][3] : wb[p][2])
                                   : (fu[p] >= 0.5f ? wb[p][1] : wb[p][0]);
      a.ok_c[i] = inb_c[p] && (vb & 1) > 0 && front;
    }
  }
}

struct RowsArgs {
  const float* depth;         // (n,) live
  const float* vertices;      // (n, 3)
  const float* normals;       // (n, 3)
  const float* intensity;     // (n,)
  const float* pose;          // (16,)
  const float* model;         // (15,)
  const float* v_m;           // (n, 3) correspondences (H1a)
  const float* n_m;
  const uint8_t* ok;
  const float* i_m0;          // (n,) photometric samples (H1a, or light-scaled)
  const float* gu;
  const float* gv;
  const float* u0;
  const float* v0;
  const uint8_t* ok_c;
  int n;
  Camera cam;
  Scalars s;
  float* out;                 // (2, kSums)
  unsigned int* launches;     // the launch counter
  // gn_step_kernel's solve: the damping, whether it is the level's scores,
  // and where the next (16,) pose vector goes.
  float damping;
  int detect;
  float* pose_out;
};

// The 29 stacked products of one row in _sum_positions' layout: row a's
// triangle w j_a j_c (c >= a), then w j_a r; then w r r and the count.
__device__ __forceinline__ void accumulate(float* acc, const float* j, float r, float w) {
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const float wj = mul(w, j[p]);
#pragma unroll
    for (int c = p; c < 6; ++c, ++k) acc[k] = add(acc[k], mul(wj, j[c]));
    acc[k] = add(acc[k], mul(wj, r));
    ++k;
  }
  acc[k] = add(acc[k], mul(mul(w, r), r));
  acc[k + 1] = add(acc[k + 1], w > 0.0f ? 1.0f : 0.0f);
}

// A warp's sums of kN values a lane (kN 32 or 64): a butterfly in which the
// two lanes of a pair keep opposite halves of their values and add the
// other's, halving what a lane carries at each of the 5 steps; lane l ends
// with the sums of values kN / 32 * l + [0, kN / 32).  kN - 2 (or 31)
// shuffles a lane where an xor tree a value takes 5 kN: the warps' shuffles
// share one unit an SM.  The order of the adds is fixed.
template <int kHalf, int kOff>
__device__ __forceinline__ void butterfly_step(float* v, int lane) {
  const bool up = (lane & kOff) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float give = up ? v[j] : v[j + kHalf];
    const float keep = up ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, give, kOff);
  }
}

template <int kN>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[kN], int lane) {
  butterfly_step<kN / 2, 16>(v, lane);
  butterfly_step<kN / 4, 8>(v, lane);
  butterfly_step<kN / 8, 4>(v, lane);
  butterfly_step<kN / 16, 2>(v, lane);
  butterfly_step<kN / 32, 1>(v, lane);
}

// One live pixel's rows, added to the thread's sums (acc: 29 geometric,
// then 29 photometric).
template <bool kGeo, bool kPhoto, bool kLiveNormals>
__device__ __forceinline__ void add_row(const RowsArgs& a, int i, const float* pose,
                                        const float* model, float* acc) {
  const float x = __ldg(a.vertices + 3 * i), y = __ldg(a.vertices + 3 * i + 1),
              z = __ldg(a.vertices + 3 * i + 2);
  float vx, vy, vz;
  affine(pose, x, y, z, vx, vy, vz);
  if (kGeo) {
    // _pp_normal_eqs.
    float nwx, nwy, nwz;
    rotate(pose, __ldg(a.normals + 3 * i), __ldg(a.normals + 3 * i + 1),
           __ldg(a.normals + 3 * i + 2), nwx, nwy, nwz);
    const float dx = sub(vx, __ldg(a.v_m + 3 * i));
    const float dy = sub(vy, __ldg(a.v_m + 3 * i + 1));
    const float dz = sub(vz, __ldg(a.v_m + 3 * i + 2));
    float nx = __ldg(a.n_m + 3 * i), ny = __ldg(a.n_m + 3 * i + 1),
          nz = __ldg(a.n_m + 3 * i + 2);
    const float dist2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
    const float n_dot = add(add(mul(nwx, nx), mul(nwy, ny)), mul(nwz, nz));
    const bool gate = __ldg(a.ok + i) && dist2 < a.s.dist2 && n_dot > a.s.normal_thresh;
    if (kLiveNormals) {
      nx = nwx;
      ny = nwy;
      nz = nwz;
    }
    const float r = add(add(mul(nx, dx), mul(ny, dy)), mul(nz, dz));
    const float w = gate ? huber(r, a.s.huber_delta) : 0.0f;
    const float j[6] = {sub(mul(vy, nz), mul(vz, ny)), sub(mul(vz, nx), mul(vx, nz)),
                        sub(mul(vx, ny), mul(vy, nx)), nx, ny, nz};
    accumulate(acc, j, r, w);
  }
  if (kPhoto) {
    // color_rows_fixed: the first-order image model around the sample.
    float px, py, pz, u, v;
    affine(model, vx, vy, vz, px, py, pz);
    project(a.cam, px, py, pz, u, v);
    const float du = sub(u, __ldg(a.u0 + i)), dv = sub(v, __ldg(a.v0 + i));
    const float gu = __ldg(a.gu + i), gv = __ldg(a.gv + i);
    const float r = sub(add(add(__ldg(a.i_m0 + i), mul(gu, du)), mul(gv, dv)),
                        __ldg(a.intensity + i));
    const float zc = fmaxf(pz, 1e-6f);
    const float gufx = mul(gu, a.cam.fx), gvfy = mul(gv, a.cam.fy);
    const float gpx = dvd(gufx, zc), gpy = dvd(gvfy, zc);
    const float gpz = dvd(-add(mul(gufx, px), mul(gvfy, py)), mul(zc, zc));
    // R_m^T of the model camera's world-to-camera rotation.
    const float gwx = add(add(mul(model[0], gpx), mul(model[3], gpy)), mul(model[6], gpz));
    const float gwy = add(add(mul(model[1], gpx), mul(model[4], gpy)), mul(model[7], gpz));
    const float gwz = add(add(mul(model[2], gpx), mul(model[5], gpy)), mul(model[8], gpz));
    const float drift2 = add(mul(du, du), mul(dv, dv));
    const float d = __ldg(a.depth + i);
    const bool gate = d > a.s.depth_min && d < a.s.depth_max && __ldg(a.ok_c + i) &&
                      pz > 0.0f && drift2 < 16.0f;
    const float w = gate ? huber(r, a.s.rgb_huber_delta) : 0.0f;
    const float s = a.s.rgb_weight;
    const float j[6] = {mul(s, sub(mul(vy, gwz), mul(vz, gwy))),
                        mul(s, sub(mul(vz, gwx), mul(vx, gwz))),
                        mul(s, sub(mul(vx, gwy), mul(vy, gwx))),
                        mul(s, gwx), mul(s, gwy), mul(s, gwz)};
    accumulate(acc + kSums, j, mul(s, r), w);
  }
}

__device__ void gn_solve(const float* sums, const float* pose, float damping, bool geometric,
                         bool photo, bool detect, float* out);

// H1b's pass over the pixels; with kSolve also H1c's on rank 0's sums.
template <bool kGeo, bool kPhoto, bool kLiveNormals, bool kSolve>
__device__ __forceinline__ void rows_pass(const RowsArgs& a) {
  __shared__ float warp_sums[kRowsWarps][kSlots];
  __shared__ float cluster_sums[kRowsCluster][kSlots];   // rank 0's: every CTA's sums
  float acc[kSlots];
  count_launch(a.launches);
  // A CTA stores into rank 0's shared memory only once every CTA of the
  // cluster runs: arrive now, wait after the pixels.
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
  float pose[12], model[15];
#pragma unroll
  for (int k = 0; k < 12; ++k) pose[k] = __ldg(a.pose + k);
#pragma unroll
  for (int k = 0; k < 15; ++k) model[k] = __ldg(a.model + k);

  // The thread's pixels in order, two an iteration so that their loads are
  // in flight together.
  const int step = gridDim.x * kRowsThreads;
  int i = blockIdx.x * kRowsThreads + threadIdx.x;
  for (; i + step < a.n; i += 2 * step) {
    add_row<kGeo, kPhoto, kLiveNormals>(a, i, pose, model, acc);
    add_row<kGeo, kPhoto, kLiveNormals>(a, i + step, pose, model, acc);
  }
  if (i < a.n) add_row<kGeo, kPhoto, kLiveNormals>(a, i, pose, model, acc);

  // The block's sums: a butterfly in each warp over the active slots
  // [kLo, kHi), then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kLo = kGeo ? 0 : kSums, kHi = kPhoto ? kSlots : kSums;
  constexpr int kN = kHi - kLo > 32 ? 64 : 32;
  float v[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) v[j] = j < kHi - kLo ? acc[kLo + j] : 0.0f;
  warp_reduce_scatter<kN>(v, lane);
#pragma unroll
  for (int j = 0; j < kN / 32; ++j) {
    const int k = kLo + kN / 32 * lane + j;
    if (k < kHi) warp_sums[warp][k] = v[j];
  }
  __syncthreads();

  // The cluster's sums: every CTA stores its sums (the warps' in order)
  // into rank 0's shared memory, through distributed shared memory; after
  // one barrier rank 0 adds them in rank order, and the others are done.
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait;" ::: "memory");
  if (threadIdx.x < kSlots) {
    const int k = threadIdx.x;
    float v = 0.0f;
    if ((k < kSums && kGeo) || (k >= kSums && kPhoto)) {
      for (int w = 0; w < kRowsWarps; ++w) v += warp_sums[w][k];
    }
    cluster.map_shared_rank(&cluster_sums[0][0], 0)[rank * kSlots + k] = v;
  }
  cluster.sync();
  if (rank != 0) return;
  __shared__ float sums[kSlots], pose_in[16];   // the solve's inputs
  if (threadIdx.x < kSlots) {
    const int k = threadIdx.x;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsCluster; ++r) v += cluster_sums[r][k];
    a.out[k] = v;
    sums[k] = v;
  } else if (kSolve && threadIdx.x < kSlots + 16) {
    pose_in[threadIdx.x - kSlots] = a.pose[threadIdx.x - kSlots];
  }
  if (!kSolve) return;
  __syncthreads();
  if (threadIdx.x < kSolveThreads)
    gn_solve(sums, pose_in, a.damping, kGeo, kPhoto, a.detect != 0, a.pose_out);
}

template <bool kGeo, bool kPhoto, bool kLiveNormals>
__global__ void __launch_bounds__(kRowsThreads, 1) rows_kernel(RowsArgs a) {
  rows_pass<kGeo, kPhoto, kLiveNormals, false>(a);
}

// icp_rows_solve: H1b, then H1c on rank 0.  The next kernel (H1a, a
// programmatic dependent launch) may start launching at once: it waits for
// this grid before it reads the pose.
template <bool kGeo, bool kPhoto, bool kLiveNormals>
__global__ void __launch_bounds__(kRowsThreads, 1) gn_step_kernel(RowsArgs a) {
  allow_dependents();
  rows_pass<kGeo, kPhoto, kLiveNormals, true>(a);
}

// --- H1c: 6x6 algebra on a warp -----------------------------------------

// Position of H[r][c] (r <= c) and of b[r] in the stacked sums.
__device__ __forceinline__ int row_start(int r) { return 7 * r - r * (r - 1) / 2; }
__device__ __forceinline__ int h_pos(int r, int c) {
  return r <= c ? row_start(r) + c - r : row_start(c) + r - c;
}
__device__ __forceinline__ int b_pos(int r) { return row_start(r) + 6 - r; }

// The lower Cholesky factor of a 6x6 matrix held by rows: lane i (i < 6;
// the lanes above pass i = 5 and hold a copy of row 5) holds row[0..5] of
// row i and ends with L[i][0..i] in row[0..i].  Column j: every lane sums
// row[j] - sum_k row[k] L[j][k] in k order, L[j][k] shuffled from lane j;
// lane j's sum is the pivot, which every lane takes from it; lane j keeps
// its root, the lanes below divide by it.  The serial code's arithmetic
// in its order.  False on every lane when a pivot is not positive (or not
// a number), as LAPACK's potrf reports it; the factor is then undefined.
__device__ __forceinline__ bool cholesky6_warp(float (&row)[6], int i) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = row[j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= row[k] * __shfl_sync(kFullWarp, row[k], j);
    const float pivot = __shfl_sync(kFullWarp, s, j);
    ok = ok && pivot > 0.0f;
    const float d = sqrtf(pivot);
    if (i == j) {
      row[j] = d;
    } else if (i > j) {
      row[j] = s / d;
    }
  }
  return ok;
}

// a / b rounded to nearest from inv = RN(1 / b): q = a inv, then two
// corrections q + (a - b q) inv, each residual exact by FMA.  The first
// brings q within an ulp of a / b, and the second then rounds it
// correctly (Markstein's theorem), so the result is a / b's (div.rn)
// wherever the quotient and the residuals are normal numbers; the chain
// is five dependent FMAs where a division's is a reciprocal and its
// refinement too.
__device__ __forceinline__ float div_by(float a, float b, float inv) {
  float q = __fmul_rn(a, inv);
  float r = __fmaf_rn(-b, q, a);
  q = __fmaf_rn(r, inv, q);
  r = __fmaf_rn(-b, q, a);
  return __fmaf_rn(r, inv, q);
}

// The factor and its diagonal's reciprocals, for cho_solve6.
struct Factor {
  float L[6][6];    // lower triangle
  float inv[6];     // RN(1 / L[i][i])
};

// Solve L L^T x = b with the factor, in one lane: the serial substitution,
// each division by the diagonal through its reciprocal (div_by).
__device__ __forceinline__ void cho_solve6(const Factor& f, const float* b, float* x) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= f.L[i][k] * y[k];
    y[i] = div_by(s, f.L[i][i], f.inv[i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= f.L[k][i] * x[k];
    x[i] = div_by(s, f.L[i][i], f.inv[i]);
  }
}

// L (lower triangle) and its diagonal's reciprocals in every lane, from
// the rows of cholesky6_warp.
__device__ __forceinline__ void gather_factor(const float (&row)[6], Factor& f) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int k = 0; k <= r; ++k) f.L[r][k] = __shfl_sync(kFullWarp, row[k], r);
    f.inv[r] = __frcp_rn(f.L[r][r]);
  }
}

// _min_eig_normalized on a warp: the smallest eigenvalue of D^-1/2 H D^-1/2
// by eight steps of inverse power iteration with a 1e-6 ridge; 0 when the
// factor fails or the estimate is not finite.  H = G + C from the stacked
// sums g and c (c null: H = G).  Lane i forms row i of the scaled matrix;
// the iteration runs in every lane on the gathered factor.
__device__ __forceinline__ float min_eig_warp(const float* g, const float* c, int lane) {
  const int i = min(lane, 5);
  float d[6], row[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int pos = h_pos(k, k);
    d[k] = sqrtf(fmaxf(c ? g[pos] + c[pos] : g[pos], 1e-20f));
  }
  float di = d[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) di = i == k ? d[k] : di;
  const float ridge = 1e-6f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int pos = h_pos(i, j);
    row[j] = (c ? g[pos] + c[pos] : g[pos]) / (di * d[j]);
    if (j == i) row[j] += ridge;
  }
  const bool ok = cholesky6_warp(row, i);
  Factor A;
  gather_factor(row, A);
  float x[6], y[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = (float)0.40824829046386296;  // 6 ** -0.5
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    cho_solve6(A, x, y);
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) ss += y[k] * y[k];
    const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-38f));
#pragma unroll
    for (int k = 0; k < 6; ++k) x[k] = y[k] * inv;
  }
  cho_solve6(A, x, y);
  float inv_lam = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) inv_lam += x[k] * y[k];
  const float lam = 1.0f / fmaxf(inv_lam, 1e-30f) - ridge;
  return ok && isfinite(lam) ? fmaxf(lam, 0.0f) : 0.0f;
}

// SE3.exp(xi) @ (R, t) of core/se3.py, with its small-angle series: lane l
// < 12 writes out[l] (R row-major, then t).  Every lane forms R and V.
__device__ __forceinline__ void exp_compose_warp(const float* xi, const float* pose,
                                                 int lane, float* out) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool series = theta2 < 1e-4f;
  const float s = sinf(theta), c = cosf(theta);
  const float a = series ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = series ? 0.5f - theta2 / 24.0f : (1.0f - c) / theta2;
  const float cc = series ? 1.0f / 6.0f - theta2 / 120.0f : (theta - s) / (theta2 * theta);
  const float K[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float kk = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) kk += K[i][k] * K[k][j];
      const float eye = i == j ? 1.0f : 0.0f;
      R[i][j] = eye + a * K[i][j] + b * kk;
      V[i][j] = eye + b * K[i][j] + cc * kk;
    }
  if (lane >= 12) return;
  // This lane's row of R and V.
  const int i = lane < 9 ? lane / 3 : lane - 9;
  float Ri[3], Vi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Ri[k] = i == 0 ? R[0][k] : (i == 1 ? R[1][k] : R[2][k]);
    Vi[k] = i == 0 ? V[0][k] : (i == 1 ? V[1][k] : V[2][k]);
  }
  if (lane < 9) {
    const int j = lane - 3 * i;
    float r = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) r += Ri[k] * pose[3 * k + j];
    out[lane] = r;
  } else {
    float t = 0.0f, te = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t += Ri[k] * pose[9 + k];
      te += Vi[k] * xi[3 + k];
    }
    out[lane] = t + te;
  }
}

// H1c on the (2, 29) sums (geometric, photometric: zeros where a term is
// absent) and the (16,) pose, both in shared memory, by the block's first
// kSolveThreads threads (two warps).
// Step (warp 0): pose' = exp(solve_gn(Hg + Hc, bg + bc)) @ pose (a zero
// step under 6 inliers or when the factor fails or the step is not
// finite), err = e / max(c, 1), inliers = c, from the geometric term when
// there is one.
// Detect: out[14] = the score of the summed matrix (warp 0), out[15] the
// geometric one (warp 1; 1 without a geometric term); the rest passes
// through.
// Not inlined: the solve's registers stay out of gn_step_kernel's pixel
// loop.
__device__ __noinline__ void gn_solve(const float* sums, const float* pose, float damping,
                                      bool geometric, bool photo, bool detect, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* g = sums;
  const float* c = sums + kSums;
  if (detect) {
    float score = 1.0f;
    if (warp == 0) {
      score = min_eig_warp(g, c, lane);
      if (lane < 14) out[lane] = pose[lane];
    } else if (geometric) {
      score = min_eig_warp(g, photo ? nullptr : c, lane);
    }
    if (lane == 0) out[14 + warp] = score;
    return;
  }
  if (warp != 0) return;
  const int i = min(lane, 5);
  float row[6], rhs[6], delta[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float h = g[h_pos(i, j)] + c[h_pos(i, j)];
    row[j] = j == i ? (h + damping * fmaxf(h, 1e-12f)) + 1e-12f : h;
    rhs[j] = -(g[b_pos(j)] + c[b_pos(j)]);
  }
  bool ok = cholesky6_warp(row, i);
  const float e = geometric ? g[27] : c[27];
  const float cnt = geometric ? g[28] : c[28];
  if (ok) {
    Factor L;
    gather_factor(row, L);
    cho_solve6(L, rhs, delta);
#pragma unroll
    for (int k = 0; k < 6; ++k) ok = ok && isfinite(delta[k]);
  }
  if (!ok || !(cnt >= 6.0f)) {
#pragma unroll
    for (int k = 0; k < 6; ++k) delta[k] = 0.0f;
  }
  exp_compose_warp(delta, pose, lane, out);
  if (lane == 12) out[12] = e / fmaxf(cnt, 1.0f);
  if (lane == 13) out[13] = cnt;
  if (lane == 14 || lane == 15) out[lane] = pose[lane];
}

// H1c alone, for the sharded track (its reducer adds the ranks' sums
// between H1b and this).
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const float* __restrict__ sums,
                                                             const float* __restrict__ pose,
                                                             float damping, int geometric,
                                                             int photo, int detect,
                                                             float* __restrict__ out,
                                                             unsigned int* launches) {
  count_launch(launches);
  allow_dependents();
  __shared__ float s[kSlots];
  __shared__ float p[16];
  for (int k = threadIdx.x; k < kSlots; k += kSolveThreads) s[k] = sums[k];
  if (threadIdx.x < 16) p[threadIdx.x] = pose[threadIdx.x];
  __syncthreads();
  gn_solve(s, p, damping, geometric != 0, photo != 0, detect != 0, out);
}

// H1b's launch (gn_step_kernel's with kSolve): one cluster of kRowsCluster
// CTAs, above the portable 8 (allowed once a kernel and device).
template <bool kGeo, bool kPhoto, bool kLiveNormals, bool kSolve>
cudaError_t launch_rows(const RowsArgs& a, cudaStream_t s) {
  auto kernel = kSolve ? gn_step_kernel<kGeo, kPhoto, kLiveNormals>
                       : rows_kernel<kGeo, kPhoto, kLiveNormals>;
  static std::mutex mu;
  static std::set<int> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!allowed.count(dev)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      allowed.insert(dev);
    }
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kRowsCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRowsCluster);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The rows pass of each term combination; live normals only with a
// geometric term.
template <bool kSolve>
cudaError_t launch_rows_for(const RowsArgs& a, bool geometric, bool photo, bool live_normals,
                            cudaStream_t s) {
  if (geometric && photo)
    return live_normals ? launch_rows<true, true, true, kSolve>(a, s)
                        : launch_rows<true, true, false, kSolve>(a, s);
  if (geometric)
    return live_normals ? launch_rows<true, false, true, kSolve>(a, s)
                        : launch_rows<true, false, false, kSolve>(a, s);
  return launch_rows<false, true, false, kSolve>(a, s);
}

// H1a's launch: a programmatic dependent launch, one block a
// kAssocBlockPixels pixels.
template <bool kGeo, bool kPhoto>
cudaError_t launch_associate(const AssocArgs& a, cudaStream_t s) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + kAssocBlockPixels - 1) / kAssocBlockPixels);
  cfg.blockDim = dim3(kAssocThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, associate_kernel<kGeo, kPhoto>, a);
}

RowsArgs rows_args(const void* depth, const void* vertices, const void* normals,
                   const void* intensity, const void* pose, const void* model,
                   const void* v_m, const void* n_m, const void* ok, const void* i_m0,
                   const void* gu, const void* gv, const void* u0, const void* v0,
                   const void* ok_c, int n, Camera cam, Scalars sc, void* out,
                   void* launches) {
  return RowsArgs{static_cast<const float*>(depth), static_cast<const float*>(vertices),
                  static_cast<const float*>(normals), static_cast<const float*>(intensity),
                  static_cast<const float*>(pose), static_cast<const float*>(model),
                  static_cast<const float*>(v_m), static_cast<const float*>(n_m),
                  static_cast<const uint8_t*>(ok), static_cast<const float*>(i_m0),
                  static_cast<const float*>(gu), static_cast<const float*>(gv),
                  static_cast<const float*>(u0), static_cast<const float*>(v0),
                  static_cast<const uint8_t*>(ok_c), n, cam, sc,
                  static_cast<float*>(out), static_cast<unsigned int*>(launches),
                  0.0f, 0, nullptr};
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// H1a.  Pointers of absent inputs/outputs may be null (wa, wb, samples,
// ok_c without the photometric term; vpack*, v_m, n_m, ok without the
// geometric one).  Returns cudaGetLastError().
extern "C" int vulcan_icp_associate(
    const void* depth, const void* vertices, const void* pose, const void* model,
    const void* vpack1, const void* vpack2, const void* npack, const void* wa,
    const void* wb, int n, int hm, int wm, float fx, float fy, float cx, float cy,
    float depth_min, float depth_max, int geometric, int photo, void* v_m, void* n_m,
    void* ok, void* samples, void* ok_c, void* launches, void* stream) {
  if (n < 0 || hm < 2 || wm < 2 || !(geometric || photo))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  AssocArgs a{static_cast<const float*>(depth), static_cast<const float*>(vertices),
              static_cast<const float*>(pose), static_cast<const float*>(model),
              static_cast<const int*>(vpack1), static_cast<const int*>(vpack2),
              static_cast<const int*>(npack), static_cast<const int*>(wa),
              static_cast<const int*>(wb), n, hm, wm, Camera{fx, fy, cx, cy},
              Scalars{depth_min, depth_max, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
              static_cast<float*>(v_m), static_cast<float*>(n_m),
              static_cast<uint8_t*>(ok), static_cast<float*>(samples),
              static_cast<uint8_t*>(ok_c), static_cast<unsigned int*>(launches)};
  cudaStream_t s = as_stream(stream);
  const cudaError_t err = geometric && photo ? launch_associate<true, true>(a, s)
                          : geometric        ? launch_associate<true, false>(a, s)
                                             : launch_associate<false, true>(a, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// H1b.  out: (2, 29).  Returns the launch's error.
extern "C" int vulcan_icp_rows(
    const void* depth, const void* vertices, const void* normals, const void* intensity,
    const void* pose, const void* model, const void* v_m, const void* n_m,
    const void* ok, const void* i_m0, const void* gu, const void* gv, const void* u0,
    const void* v0, const void* ok_c, int n, float fx, float fy, float cx, float cy,
    float depth_min, float depth_max, float dist2, float normal_thresh,
    float huber_delta, float rgb_huber_delta, float rgb_weight, int geometric,
    int photo, int live_normals, void* out, void* launches, void* stream) {
  if (n < 0 || !(geometric || photo)) return static_cast<int>(cudaErrorInvalidValue);
  const RowsArgs a = rows_args(depth, vertices, normals, intensity, pose, model, v_m, n_m, ok,
                               i_m0, gu, gv, u0, v0, ok_c, n, Camera{fx, fy, cx, cy},
                               Scalars{depth_min, depth_max, dist2, normal_thresh,
                                       huber_delta, rgb_huber_delta, rgb_weight},
                               out, launches);
  const cudaError_t err =
      launch_rows_for<false>(a, geometric, photo, live_normals, as_stream(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// H1b and H1c in one launch: sums (2, 29) and the next pose (16,) out, a
// GN step, or with detect the level's scores from the detector's rows (the
// live normals).  Returns the launch's error.
extern "C" int vulcan_icp_rows_solve(
    const void* depth, const void* vertices, const void* normals, const void* intensity,
    const void* pose, const void* model, const void* v_m, const void* n_m,
    const void* ok, const void* i_m0, const void* gu, const void* gv, const void* u0,
    const void* v0, const void* ok_c, int n, float fx, float fy, float cx, float cy,
    float depth_min, float depth_max, float dist2, float normal_thresh,
    float huber_delta, float rgb_huber_delta, float rgb_weight, float damping,
    int geometric, int photo, int detect, void* sums, void* pose_out, void* launches,
    void* stream) {
  if (n < 0 || !(geometric || photo)) return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a = rows_args(depth, vertices, normals, intensity, pose, model, v_m, n_m, ok,
                         i_m0, gu, gv, u0, v0, ok_c, n, Camera{fx, fy, cx, cy},
                         Scalars{depth_min, depth_max, dist2, normal_thresh, huber_delta,
                                 rgb_huber_delta, rgb_weight},
                         sums, launches);
  a.damping = damping;
  a.detect = detect;
  a.pose_out = static_cast<float*>(pose_out);
  const cudaError_t err =
      launch_rows_for<true>(a, geometric, photo, detect, as_stream(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// H1c.  sums (2, 29), pose (16,) in, out (16,).  Returns cudaGetLastError().
extern "C" int vulcan_icp_solve(const void* sums, const void* pose, float damping,
                                int geometric, int photo, int detect, void* out,
                                void* launches, void* stream) {
  if (!(geometric || photo)) return static_cast<int>(cudaErrorInvalidValue);
  solve_kernel<<<1, kSolveThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(sums), static_cast<const float*>(pose), damping,
      geometric, photo, detect, static_cast<float*>(out),
      static_cast<unsigned int*>(launches));
  return static_cast<int>(cudaGetLastError());
}
