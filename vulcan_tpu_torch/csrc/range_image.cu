// R1: the march's range image (ops/raycast.py compute_range_image), its
// stamps and its upsample, for Hopper (sm_90a).
//
// Replaces the XLA scatters of the reference's compute_range_image
// (vulcan_tpu/ops/raycast.py:70): three scatter-min/max of a fixed
// (V, st, st) stamp into the coarse (1 / range_scale) image, then a nearest
// upsample.  No Pallas kernel exists for it.  The port's plain version
// (ops/raycast.py _range_image_plain, the CPU's) is that code in PyTorch:
// three scatter_reduce_ calls whose masked lanes (rows past the visible
// count, overflow rows, stamp cells outside a block's footprint: well over
// 90% of V * st^2 = 589,824 lanes at the defaults) all go to one trash
// word, where aten's float min/max, a compare-and-swap loop, serializes
// them: ~2.3 ms a frame on the card for a few thousand real updates.
//
// The per-row values (depth range, footprint, stampable, the overflow's
// global range) stay in PyTorch, the plain version's own ops, so that a
// footprint's floor cannot differ by an ulp; the kernels take them and the
// visible count as device pointers (the count is read on the card, so the
// step stays capturable).
//
// stamp_kernel: one thread-block cluster of kCluster CTAs.  Each CTA keeps
// its own copy of the three coarse images (t_min, t_first_max, t_max) in
// shared memory; a stampable row takes exactly the cells of its footprint
// that the plain version's stamp marks inside (u_min + du, v_min + dv for
// du, dv < st, at most u_max / v_max, inside the image), no lane goes to a
// trash word.  After one cluster barrier each CTA reduces a share of the
// cells over every CTA's copy through distributed shared memory, folds in
// the overflow's global range and stores the cell's float: every cell is
// written once, so nothing has to be cleared before the launch and no
// global atomic is needed.  Where the three images exceed what a CTA may
// hold in shared memory (a larger sensor, a smaller range_scale), the
// same cluster clears a (3, cells) scratch in global memory, stamps it
// with global atomics and reduces it after the barrier: one launch either
// way (ops/cuda_kernels.py range_image_path chooses by the size alone).
//
// Exactness.  Min and max of floats are order-free, so privatisation and
// any order of the atomics give the same bits as scatter_reduce_.  The
// atomics act on the int key of each float (order_key: the bits, with the
// magnitude bits flipped for a negative float), whose signed order is the
// float order for every float but NaN; the values are clamped to
// [ray_near, ray_far] anyway, positive and finite, where the key is the
// float's own bits.  +inf and -inf keep their keys, so empty cells come out
// as the plain version's +inf / +inf / -inf.
//
// expand_kernel: one thread an output pixel reads its coarse cell
// (y / scale, x / scale) of the three images and writes the three (H, W)
// maps, in place of repeat_interleave twice, a slice and a where per map.
//
// What bounds it on the card: the three full-resolution maps, 3 x 640 x 480
// x 4 B = 3.7 MB, 1.1 us at 3.35 TB/s; the stamp's reads (V rows x 41 B,
// 0.67 MB) and its few thousand shared atomics are below that.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <set>

#include "launch_count.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;          // CTAs of the stamps' one cluster (non-portable)
constexpr int kThreads = 1024;        // a CTA's threads: one visible row each at 16384
constexpr int kExpandThreads = 256;
// What one CTA may hold on sm_90 (227 KB; ops/cuda_kernels.py RANGE_SMEM_BYTES).
constexpr int kSmemBytes = 232448;

__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

struct StampArgs {
  const float* z_min;               // (rows,) near depth of each visible row
  const float* z_max;               // (rows,) far depth
  const long long* u_min;           // (rows,) footprint in coarse cells
  const long long* u_max;
  const long long* v_min;
  const long long* v_max;
  const bool* stampable;            // (rows,)
  const int* num_visible;           // () rows at or past it hold no block
  const bool* any_overflow;         // () whether a row took the global range
  const float* g_min;               // () the overflow rows' range
  const float* g_max;
  int rows, hc, wc, stamp;
  int* keys;                        // (3, hc * wc) scratch of the global path
  float* out;                       // (3, hc * wc) t_min, t_first_max, t_max
  unsigned int* launches;
};

// One row's stamp into the images `img` (shared or global): the cells the
// plain version's (st, st) stamp marks inside.
__device__ __forceinline__ void stamp_row(const StampArgs& a, int r, int* img, int cells) {
  const long long u0 = a.u_min[r], v0 = a.v_min[r], last = a.stamp - 1;
  const long long ulo = max(u0, 0LL), uhi = min(min(u0 + last, a.u_max[r]), a.wc - 1LL);
  const long long vlo = max(v0, 0LL), vhi = min(min(v0 + last, a.v_max[r]), a.hc - 1LL);
  if (ulo > uhi || vlo > vhi) return;
  const int kmin = order_key(a.z_min[r]), kmax = order_key(a.z_max[r]);
  for (int v = static_cast<int>(vlo); v <= static_cast<int>(vhi); ++v) {
    for (int u = static_cast<int>(ulo); u <= static_cast<int>(uhi); ++u) {
      const int c = v * a.wc + u;
      atomicMin(img + c, kmin);
      atomicMin(img + cells + c, kmax);
      atomicMax(img + 2 * cells + c, kmax);
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1) stamp_kernel(StampArgs a) {
  extern __shared__ int smem[];
  count_launch(a.launches);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cells = a.hc * a.wc, n = 3 * cells;
  const int tid = static_cast<int>(threadIdx.x);
  const int total = kCluster * kThreads;
  const int kInf = order_key(__int_as_float(0x7f800000));       // +inf
  const int kNegInf = order_key(__int_as_float(0xff800000));    // -inf

  int* img = kShared ? smem : a.keys;
  if (kShared) {
    for (int i = tid; i < n; i += kThreads) img[i] = i < 2 * cells ? kInf : kNegInf;
    __syncthreads();
  } else {
    for (int i = rank * kThreads + tid; i < n; i += total)
      img[i] = i < 2 * cells ? kInf : kNegInf;
    cluster.sync();
  }

  // Rows: the 32 lanes of a warp take rows total / 32 apart, so that the
  // neighbouring blocks of the visible list, which cover the same cells,
  // fall to different warps rather than to one warp's lanes, whose atomics
  // on one word would serialize.
  const int nv = min(*a.num_visible, a.rows);
  const int warp = rank * (kThreads / 32) + tid / 32, lane = tid & 31;
  for (int base = 0; base < nv; base += total) {
    const int r = base + lane * (total / 32) + warp;
    if (r < nv && a.stampable[r]) stamp_row(a, r, img, cells);
  }
  cluster.sync();

  const bool overflow = *a.any_overflow;
  const float g_min = *a.g_min, g_max = *a.g_max;
  for (int i = rank * kThreads + tid; i < n; i += total) {
    const bool is_max = i >= 2 * cells;
    int k;
    if (kShared) {
      int got[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) got[q] = *cluster.map_shared_rank(smem + i, q);
      k = got[0];
#pragma unroll
      for (int q = 1; q < kCluster; ++q) k = is_max ? max(k, got[q]) : min(k, got[q]);
    } else {
      k = __ldcg(img + i);   // the atomics' result, from L2
    }
    float t = from_key(k);
    if (overflow) t = i < cells ? fminf(t, g_min) : is_max ? fmaxf(t, g_max) : fminf(t, g_max);
    a.out[i] = t;
  }
  // A CTA's shared memory must outlive the other CTAs' reads of it.
  if (kShared) cluster.sync();
}

__global__ void __launch_bounds__(kExpandThreads) expand_kernel(
    const float* __restrict__ coarse, float* __restrict__ out, int h, int w, int hc, int wc,
    int scale, unsigned int* launches) {
  count_launch(launches);
  const int i = blockIdx.x * kExpandThreads + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  const int cells = hc * wc, c = (y / scale) * wc + x / scale, hw = h * w;
  out[i] = __ldg(coarse + c);
  out[hw + i] = __ldg(coarse + cells + c);
  out[2 * hw + i] = __ldg(coarse + 2 * cells + c);
}

// The stamp's cluster is above the portable 8 and its shared images may be
// above the default 48 KB: both allowed once a kernel and device, on the
// first (eager) launch, never inside a capture.
cudaError_t allow(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, kernel})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.insert({dev, kernel});
  return err;
}

}  // namespace

// The stamps and their reduction: the (3, hc * wc) float32 coarse images
// t_min, t_first_max, t_max into `out`, the overflow's global range folded
// in.  `keys` null: the images in each CTA's shared memory (3 * hc * wc * 4
// bytes, at most kSmemBytes); else the (3, hc * wc) int32 scratch they are
// kept in.  Returns the error.
extern "C" int vulcan_range_stamp(void* z_min, void* z_max, void* u_min, void* u_max,
                                  void* v_min, void* v_max, void* stampable, void* num_visible,
                                  void* any_overflow, void* g_min, void* g_max, int rows,
                                  int hc, int wc, int stamp, void* keys, void* out,
                                  void* launches, void* stream) {
  const bool shared = keys == nullptr;
  const long long bytes = 3LL * hc * wc * 4;
  if (rows < 0 || hc < 1 || wc < 1 || stamp < 1 || (shared && bytes > kSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  StampArgs a{static_cast<const float*>(z_min), static_cast<const float*>(z_max),
              static_cast<const long long*>(u_min), static_cast<const long long*>(u_max),
              static_cast<const long long*>(v_min), static_cast<const long long*>(v_max),
              static_cast<const bool*>(stampable), static_cast<const int*>(num_visible),
              static_cast<const bool*>(any_overflow), static_cast<const float*>(g_min),
              static_cast<const float*>(g_max), rows, hc, wc, stamp,
              static_cast<int*>(keys), static_cast<float*>(out),
              static_cast<unsigned int*>(launches)};
  auto kernel = shared ? stamp_kernel<true> : stamp_kernel<false>;
  cudaError_t err = allow(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shared ? static_cast<size_t>(bytes) : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The nearest upsample of the (3, hc * wc) coarse images by `scale` into
// the (3, h, w) float32 maps `out`.  Returns the error.
extern "C" int vulcan_range_expand(void* coarse, void* out, int h, int w, int hc, int wc,
                                   int scale, void* launches, void* stream) {
  if (h < 1 || w < 1 || scale < 1 || (h - 1) / scale >= hc || (w - 1) / scale >= wc)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (h * w + kExpandThreads - 1) / kExpandThreads;
  expand_kernel<<<blocks, kExpandThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coarse), static_cast<float*>(out), h, w, hc, wc, scale,
      static_cast<unsigned int*>(launches));
  return static_cast<int>(cudaGetLastError());
}
