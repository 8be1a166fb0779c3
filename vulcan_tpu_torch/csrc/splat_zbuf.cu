// S1: the surfel splat's z-buffer (ops/splat.py _splat_zbuf_surfels) as one
// hand kernel, for Hopper (sm_90a).
//
// Replaces the XLA code of the reference's surfel z-buffer
// (vulcan_tpu/ops/splat.py _splat_zbuf_surfels, its two lax.while_loops
// over the surface blocks); no Pallas kernel exists for it.  The port's
// plain version (ops/splat.py _splat_zbuf_surfels_plain, the CPU's) runs
// two tiers of chunk loops: slots [0, S/2) of every visible block with a
// surfel, in chunks of 2048 blocks, then slots [S/2, S) of the blocks
// holding more than S/2, in chunks of 512.  A chunk is about ninety PyTorch
// kernels on (chunk, S/2) lanes (the unpack, the block coordinates, the
// pose, the back-face cull, the projection, the colour-word gather, the
// luma pack) and one scatter_reduce_ whose masked lanes all go to a trash
// word; on the card each tier is a WHILE node of such chunks.
//
// One launch (two for rgb).  A persistent grid (as many CTAs of kThreads as
// the card holds at once) walks the visible list's rows r = blockIdx.x,
// + gridDim.x, ... below min(*count, capacity): the count is read on the
// card, so the captured step needs no loop node here.  A row whose id is
// <= 0 is skipped, as visible_rows masks it, and so is a block whose
// surf_count is 0, as the surfel list leaves it out.  A CTA takes one block
// at a time and walks the block's slots a thread each: slots [0, S/2) when
// it holds a surfel, [0, S) when it holds more than S/2, the two tiers'
// slots exactly; an EMPTY_SURFEL word is skipped, as the plain version
// masks it.  A surfel that survives the cull and the depth range and
// projects inside the image updates its pixel with one integer atomic; a
// masked lane writes nothing, so the buffer has no trash word.
//
// The three modes (a template parameter, chosen by what the caller asks):
//  - kDepth: the float depth, as its int32 bits, atomicMin'd into a buffer
//    of +inf.  Depths lie above ray_near >= 0 (the wrapper refuses a
//    negative one), so the bits' signed order is the floats' order.
//  - kLuma: the packed zq19 << 12 | luma12 word atomicMin'd (the nearest
//    depth bin wins, ties to the darker luma).
//  - kColor: the second launch of the rgb form: rgb888 atomicMax'd where
//    the surfel's depth is within 1e-5 m of the finished depth buffer zref.
// Min and max of integers are order-free: one pass over every slot of every
// listed block gives the two tiers' words, whatever the atomics' order.
//
// Arithmetic.  Every float operation is the plain version's on the card in
// its order, one rounding each (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: no contraction into FMAs): splat._to_camera's three products
// and three sums, the cull's differences, products and sums, PinholeCamera
// projection's product, quotient and sum, round half to even (rintf) after
// dense.round_to_int's clamp, the luma's products and sums and the depth's
// quantization, with each Python float rounded to float32 as PyTorch rounds
// a scalar that multiplies a float32 tensor.
//
// What bounds it on the card.  A listed block reads its id, surf_count and
// coordinates (20 B), its surfel row (4 B a slot) and, in the colour modes,
// one 4 B colour word a live surfel; the buffer takes an atomic a surfel
// that lands.  At the desk cells' ~3,000 surface blocks and ~100 surfels a
// block that is ~2.5 MB with the 1.2 MB buffer: under 1 us at 3.35 TB/s.
// A block's dependent chain (id, count, row, colour word, atomic) bounds
// it instead.
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 128;           // a CTA's threads, walking a block's slots
constexpr int kMaxSlots = 512;          // surfel slots a block row may have (I1's)
constexpr int kEmptySurfel = 0x7FFFFFFF;  // ops/blocks.py EMPTY_SURFEL
constexpr float kCoordClamp = 1e7f;       // ops/dense.py COORD_CLAMP
constexpr int kZqTop = (1 << 19) - 2;     // splat._ZQ_MAX - 1
// The plain version's Python constants, rounded to float32 as PyTorch
// rounds a Python float that multiplies a float32 tensor.
constexpr float kInv16383 = static_cast<float>(1.0 / 16383.0);
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kLumaR = static_cast<float>(0.299);
constexpr float kLumaG = static_cast<float>(0.587);
constexpr float kLumaB = static_cast<float>(0.114);
constexpr float kZTol = static_cast<float>(1e-5);
constexpr float kZMin = static_cast<float>(1e-6);

enum Mode { kDepth = 0, kLuma = 1, kColor = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// dense.round_to_int: clamp, then round half to even.
__device__ __forceinline__ int round_to_int(float x) {
  return static_cast<int>(rintf(clampf(x, -kCoordClamp, kCoordClamp)));
}

// One row of splat._to_camera: three products summed left to right, then
// the translation.
__device__ __forceinline__ float pose_row(const float* r, float t, float x, float y, float z) {
  return add(add(add(mul(r[0], x), mul(r[1], y)), mul(r[2], z)), t);
}

struct SplatArgs {
  const int* ids;             // (capacity,) the visible list
  const int* count;           // () its rows; rows at or past it are idle
  const int* surfpack;        // (num_blocks, slots)
  const int* surf_count;      // (num_blocks,)
  const int* colorpack;       // (num_blocks, 512) w8|r8|g8|b8
  const int* block_coords;    // (num_blocks, 3)
  const float* frame;         // (15,) world-to-camera R row-major, t, camera centre
  const float* zref;          // (h * w,) the finished depth buffer (kColor)
  int capacity, slots, h, w, cull;
  float fx, fy, cx, cy;
  float voxel_size, mu, ray_near, ray_far, zq_scale;
  int* out;                   // (h * w,) updated by atomics
  unsigned int* launches;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads) splat_zbuf_kernel(SplatArgs a) {
  count_launch(a.launches);
  const int t = static_cast<int>(threadIdx.x);
  float p[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) p[k] = __ldg(a.frame + k);
  const int n = min(*a.count, a.capacity);
  const int half = a.slots / 2;

  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const int id = __ldg(a.ids + r);
    if (id <= 0) continue;   // the same for the whole CTA
    const int held = __ldg(a.surf_count + id);
    if (held <= 0) continue;
    const int stop = held > half ? a.slots : half;   // the tiers' slots
    const int* bc = a.block_coords + 3LL * id;
    const int bx = __ldg(bc) * 8, by = __ldg(bc + 1) * 8, bz = __ldg(bc + 2) * 8;
    const int* row = a.surfpack + static_cast<long long>(id) * a.slots;

    for (int s = t; s < stop; s += kThreads) {
      const int word = __ldg(row + s);
      if (word == kEmptySurfel) continue;
      // blocks.unpack_surfels
      const int lidx = word & 0x1FF;
      const float mag = mul(static_cast<float>((word >> 10) & 0x3FFF), kInv16383);
      const float tsdf = ((word >> 9) & 1) ? -mag : mag;
      const int lx = lidx >> 6, ly = (lidx >> 3) & 7, lz = lidx & 7;
      const float wx = mul(static_cast<float>(bx + lx), a.voxel_size);
      const float wy = mul(static_cast<float>(by + ly), a.voxel_size);
      const float wz = mul(static_cast<float>(bz + lz), a.voxel_size);
      const float x = pose_row(p, p[9], wx, wy, wz);
      const float y = pose_row(p + 3, p[10], wx, wy, wz);
      const float z = pose_row(p + 6, p[11], wx, wy, wz);
      const float z_surf = add(z, mul(tsdf, a.mu));
      if (a.cull) {
        // The stored orientation points outward: a surfel facing away
        // from the camera writes nothing.
        const float gx = static_cast<float>(((word >> 24) & 3) - 1);
        const float gy = static_cast<float>(((word >> 26) & 3) - 1);
        const float gz = static_cast<float>(((word >> 28) & 3) - 1);
        const float facing = add(add(mul(gx, sub(wx, p[12])), mul(gy, sub(wy, p[13]))),
                                 mul(gz, sub(wz, p[14])));
        if (facing > 0.0f) continue;
      }
      if (!(z_surf > a.ray_near && z_surf < a.ray_far && z > kZMin)) continue;
      // splat._pixel
      const float zc = fmaxf(z, kZMin);
      const int u = round_to_int(add(dvd(mul(x, a.fx), zc), a.cx));
      const int v = round_to_int(add(dvd(mul(y, a.fy), zc), a.cy));
      if (u < 0 || u >= a.w || v < 0 || v >= a.h) continue;
      const int pix = v * a.w + u;
      if (kMode == kDepth) {
        atomicMin(a.out + pix, __float_as_int(z_surf));
        continue;
      }
      // The voxel's colour word (w8|r8|g8|b8) within its block's row.
      const int c = __ldg(a.colorpack + static_cast<long long>(id) * 512 + lidx);
      const int red = (c >> 16) & 0xFF, green = (c >> 8) & 0xFF, blue = c & 0xFF;
      if (kMode == kLuma) {
        const float lum = mul(add(add(mul(static_cast<float>(red), kLumaR),
                                      mul(static_cast<float>(green), kLumaG)),
                                  mul(static_cast<float>(blue), kLumaB)),
                              kInv255);
        const int i12 = static_cast<int>(clampf(rintf(mul(lum, 4095.0f)), 0.0f, 4095.0f));
        const int zq = static_cast<int>(
            clampf(rintf(mul(z_surf, a.zq_scale)), 0.0f, static_cast<float>(kZqTop)));
        atomicMin(a.out + pix, (zq << 12) | i12);
      } else if (z_surf <= add(__ldg(a.zref + pix), kZTol)) {
        atomicMax(a.out + pix, (red << 16) | (green << 8) | blue);
      }
    }
  }
}

template <int kMode>
void launch(const SplatArgs& a, int blocks, cudaStream_t stream) {
  splat_zbuf_kernel<kMode><<<blocks, kThreads, 0, stream>>>(a);
}

// CTAs of the persistent grid for mode ``mode`` on the current device: as
// many as its SMs hold at once, found once a device and mode.
cudaError_t grid_size(int mode, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find({dev, mode});
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const void* fn = mode == kDepth  ? reinterpret_cast<const void*>(splat_zbuf_kernel<kDepth>)
                   : mode == kLuma ? reinterpret_cast<const void*>(splat_zbuf_kernel<kLuma>)
                                   : reinterpret_cast<const void*>(splat_zbuf_kernel<kColor>);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = known[{dev, mode}] = sms * std::max(per_sm, 1);
  return cudaSuccess;
}

}  // namespace

// Splat the surfels of the blocks listed in ids[:*count] (at most capacity)
// into out, an (h * w) int32 buffer the caller has filled (+inf's bits,
// the empty luma word, or -1); see the file's head.  mode: 0 depth, 1
// luma, 2 colour (reads zref).  cull: the back-face cull is on.  Returns
// the error.
extern "C" int vulcan_splat_zbuf(int mode, void* ids, void* count, void* surfpack,
                                 void* surf_count, void* colorpack, void* block_coords,
                                 void* frame, void* zref, int capacity, int slots, int h,
                                 int w, int cull, float fx, float fy, float cx, float cy,
                                 float voxel_size, float mu, float ray_near, float ray_far,
                                 float zq_scale, void* out, void* launches, void* stream) {
  if (mode < kDepth || mode > kColor || capacity < 0 || slots < 1 || slots > kMaxSlots ||
      h < 1 || w < 1 || (mode == kColor && zref == nullptr) || !(ray_near >= 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = grid_size(mode, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  blocks = std::max(1, std::min(blocks, capacity));
  SplatArgs a{static_cast<const int*>(ids), static_cast<const int*>(count),
              static_cast<const int*>(surfpack), static_cast<const int*>(surf_count),
              static_cast<const int*>(colorpack), static_cast<const int*>(block_coords),
              static_cast<const float*>(frame), static_cast<const float*>(zref),
              capacity, slots, h, w, cull, fx, fy, cx, cy,
              voxel_size, mu, ray_near, ray_far, zq_scale,
              static_cast<int*>(out), static_cast<unsigned int*>(launches)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kDepth) launch<kDepth>(a, blocks, s);
  else if (mode == kLuma) launch<kLuma>(a, blocks, s);
  else launch<kColor>(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
