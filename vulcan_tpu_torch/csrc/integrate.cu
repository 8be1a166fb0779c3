// I1: the sparse TSDF integration of one frame (ops/sparse.py
// integrate_sparse) as one hand kernel, for Hopper (sm_90a).
//
// Replaces the XLA code of the reference's flat integrate loop
// (vulcan_tpu/ops/sparse.py integrate_sparse, :377, its lax.while_loop over
// chunks of the block list); no Pallas kernel exists for it.  The port's
// plain version (ops/sparse.py _integrate_batch under utils/sync.py
// chunk_loop, the CPU's) works a chunk of 1024 listed blocks x 512 voxels
// as (1024, 512) tensors: about a hundred PyTorch kernels a chunk (the pose
// apply, the projection and nearest sample, the depth/colour unpack,
// voxel_update, pack_surfels with its gradients, cumsums and trash-slot
// scatter, the dirty gate, a where and an index_copy_ a field), and on the
// card a WHILE node of up to alloc_capacity / integrate_chunk iterations.
//
// One launch a frame.  A persistent grid (as many CTAs of kThreads as the
// card holds at once) walks the list's rows r = blockIdx.x, + gridDim.x, ...
// below min(*count, capacity): the count is read on the card, so the
// captured step needs no loop node here.  A row whose id is <= 0 is skipped,
// as the plain version masks it.  A CTA takes one block at a time, one
// voxel a thread (lidx = (lx * 8 + ly) * 8 + lz = threadIdx.x): the world
// point, its camera point under the inverse pose (12 floats read from the
// card, so a replayed graph sees each frame's pose), the projection, the
// nearest sample of the packed depth16 | rgb565 image (round half to even,
// as ops/dense.py round_to_int), the unpack, voxel_update's TSDF and colour
// running averages and pack_voxel_color, all in registers; tsdf, weight and
// colorpack go back in place, a block's row being 512 contiguous words.
//
// The surfels.  The new tsdf row (2 KB) goes to shared memory; after one
// barrier each thread takes its central (one-sided at the block's faces)
// differences from its neighbours and quantizes them as
// blocks.quantized_orientation does, and builds its packed word and its
// live, inner and outer flags.  A live voxel's slot (inner-first, then
// outer, each in lidx order: pack_surfels' order) comes from two warp
// ballots, __popc and the 16 warps' counts in shared memory: no scatter and
// no trash slot.  Slots at or past the kept count are written EMPTY_SURFEL.
// The dropped count goes to surf_overflow with one atomicAdd a CTA (the
// wrapper zeroes it first), the mesh-dirty gate is one __syncthreads_or.
//
// Arithmetic.  Every float operation is the plain version's on the card in
// its order, one rounding each (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: no contraction into FMAs), and where PyTorch's CUDA kernels
// take a shortcut this kernel takes it too: a tensor divided by a Python
// float is a product with its reciprocal, taken in float64 and rounded to
// float32 (inv_mu, computed by the wrapper so; checked on the card).  The plain version applies
// the pose as the reference's compiled dot does (a product, two fused
// multiply-adds written out in float64, the translation; no einsum, whose
// order is not fixed on the card), and this kernel repeats it, so that on
// the card the seven outputs are bit-identical.
//
// What bounds it on the card.  A listed block reads and writes its 512
// tsdf, weight and colour words (12,288 B), writes its surfel row (768 B
// at 192 slots) and gathers up to 512 pixels of a 1.2 MB image that stays
// in L2: ~13 KB a block, 65-100 MB for the cells' 5,000-7,500 band blocks,
// 20-30 us at 3.35 TB/s; its ~150 float operations a voxel are ~0.3 GFLOP,
// below that.
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 512;           // a block's 8 x 8 x 8 voxels, one a thread
constexpr int kWarps = kThreads / 32;
// CTAs an SM must hold (__launch_bounds__): 64 registers a thread, no
// spills.  Three or four (40 or 32 registers, with spills) time the same.
constexpr int kMinCtas = 2;
constexpr int kMaxSlots = kThreads;     // surfel slots a block row may have
constexpr int kEmptySurfel = 0x7FFFFFFF;  // ops/blocks.py EMPTY_SURFEL
constexpr float kCoordClamp = 1e7f;       // ops/dense.py COORD_CLAMP
// The plain version's Python constants, rounded to float32 as PyTorch
// rounds a Python float that multiplies a float32 tensor.
constexpr float kInv31 = static_cast<float>(1.0 / 31.0);
constexpr float kInv63 = static_cast<float>(1.0 / 63.0);
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int32)
__device__ __forceinline__ int byte_of(float x) {
  return static_cast<int>(clampf(rintf(mul(x, 255.0f)), 0.0f, 255.0f));
}

// fl(a * b + c) as the plain version writes a fused multiply-add: the
// product is exact in float64, the sum rounds there, then to float32.
__device__ __forceinline__ float fma_via_double(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// One row of the world-to-camera transform (r: the rotation's row, t: its
// translation), as sparse._to_camera: the first product, two fused
// multiply-adds, then the translation.
__device__ __forceinline__ float pose_row(const float* r, float t, float x, float y, float z) {
  return add(fma_via_double(r[2], z, fma_via_double(r[1], y, mul(r[0], x))), t);
}

// blocks.quantized_orientation's rule for one component.
__device__ __forceinline__ int quantize(float g, float gm) {
  return g > gm ? 1 : (g < -gm ? -1 : 0);
}

struct IntegrateArgs {
  const int* ids;             // (capacity,) block ids of the list
  const int* count;           // () listed rows; rows at or past it are idle
  const int* block_coords;    // (num_blocks, 3)
  const float* pose;          // (12,) world-to-camera R row-major, t
  const int* image;           // (h, w) depth16 << 16 | rgb565
  int capacity, h, w, slots, gate;
  float fx, fy, cx, cy;
  float voxel_size, depth_scale, depth_min, depth_max;
  float mu, inv_mu, max_weight, band, half_band, eps;
  float* tsdf;                // (num_blocks, 512), updated in place
  float* weight;
  int* colorpack;
  int* surfpack;              // (num_blocks, slots)
  int* surf_count;            // (num_blocks,)
  unsigned char* mesh_dirty;  // (num_blocks,) bool
  int* surf_overflow;         // () added to
  unsigned int* launches;
};

__global__ void __launch_bounds__(kThreads, kMinCtas) integrate_kernel(IntegrateArgs a) {
  __shared__ float row[kThreads];
  __shared__ int inner_of[kWarps], outer_of[kWarps];
  count_launch(a.launches);
  const int t = static_cast<int>(threadIdx.x);
  const int lane = t & 31, warp = t >> 5;
  const int lx = t >> 6, ly = (t >> 3) & 7, lz = t & 7;
  const unsigned lower = (1u << lane) - 1u;   // the lanes below this one
  float p[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k] = __ldg(a.pose + k);
  const int n = min(*a.count, a.capacity);
  int dropped = 0;   // thread 0's sum over this CTA's blocks

  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const int id = __ldg(a.ids + r);
    if (id <= 0) continue;   // the same for the whole CTA
    const long long v = static_cast<long long>(id) * kThreads + t;
    const float old_t = a.tsdf[v], old_w = a.weight[v];
    const int old_c = a.colorpack[v];

    // The voxel's world point (integer voxel coords times the voxel size)
    // and its camera point (sparse._to_camera).
    const int* bc = a.block_coords + 3LL * id;
    const float wx = mul(static_cast<float>(__ldg(bc) * 8 + lx), a.voxel_size);
    const float wy = mul(static_cast<float>(__ldg(bc + 1) * 8 + ly), a.voxel_size);
    const float wz = mul(static_cast<float>(__ldg(bc + 2) * 8 + lz), a.voxel_size);
    const float x = pose_row(p, p[9], wx, wy, wz);
    const float y = pose_row(p + 3, p[10], wx, wy, wz);
    const float z = pose_row(p + 6, p[11], wx, wy, wz);

    // PinholeCamera.project (z <= 1e-12 projects to -1e9), then
    // dense._sample_nearest.
    const bool bad = z <= 1e-12f;
    const float sz = bad ? 1.0f : z;
    const float u = bad ? -1e9f : add(dvd(mul(x, a.fx), sz), a.cx);
    const float vf = bad ? -1e9f : add(dvd(mul(y, a.fy), sz), a.cy);
    const int ui = static_cast<int>(rintf(clampf(u, -kCoordClamp, kCoordClamp)));
    const int vi = static_cast<int>(rintf(clampf(vf, -kCoordClamp, kCoordClamp)));
    const bool in_bounds = ui >= 0 && ui < a.w && vi >= 0 && vi < a.h;
    const int pix = __ldg(a.image + min(max(vi, 0), a.h - 1) * a.w + min(max(ui, 0), a.w - 1));

    // sparse._unpack_depth_color
    const float depth = mul(static_cast<float>((pix >> 16) & 0xFFFF), a.depth_scale);
    const float sample[3] = {mul(static_cast<float>((pix >> 11) & 0x1F), kInv31),
                             mul(static_cast<float>((pix >> 5) & 0x3F), kInv63),
                             mul(static_cast<float>(pix & 0x1F), kInv31)};
    const bool valid = in_bounds && depth > a.depth_min && depth < a.depth_max && z > 0.0f;
    const float sdf = sub(depth, z);

    // dense.voxel_update on blocks.unpack_voxel_color's colour.
    const bool update = valid && sdf > -a.mu;
    const float tsdf_obs = clampf(mul(sdf, a.inv_mu), -1.0f, 1.0f);
    const float w_obs = update ? 1.0f : 0.0f;
    const float w_sum = add(old_w, w_obs);
    const float new_t = update ? dvd(add(mul(old_w, old_t), mul(w_obs, tsdf_obs)),
                                     fmaxf(w_sum, 1e-12f))
                               : old_t;
    const float new_w = fminf(w_sum, a.max_weight);
    const bool cupdate = update && fabsf(sdf) < a.mu;
    const float cw_obs = cupdate ? 1.0f : 0.0f;
    const float cw = static_cast<float>((old_c >> 24) & 0xFF);
    const float cw_sum = add(cw, cw_obs);
    int rgb = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float c = mul(static_cast<float>((old_c >> (16 - 8 * k)) & 0xFF), kInv255);
      const float nc = cupdate ? dvd(add(mul(cw, c), mul(cw_obs, sample[k])),
                                     fmaxf(cw_sum, 1e-12f))
                               : c;
      rgb |= byte_of(nc) << (16 - 8 * k);
    }
    const int w8 = static_cast<int>(clampf(rintf(fminf(cw_sum, a.max_weight)), 0.0f, 255.0f));
    const int cpack = static_cast<int>(static_cast<unsigned>(w8) << 24) | rgb;
    a.tsdf[v] = new_t;
    a.weight[v] = new_w;
    a.colorpack[v] = cpack;
    const bool changed = fabsf(sub(new_t, old_t)) > a.eps ||
                         (cpack & 0xFFFFFF) != (old_c & 0xFFFFFF);

    // blocks.pack_surfels on the new row.
    row[t] = new_t;
    __syncthreads();
    const float gx = sub(row[lx < 7 ? t + 64 : t], row[lx > 0 ? t - 64 : t]);
    const float gy = sub(row[ly < 7 ? t + 8 : t], row[ly > 0 ? t - 8 : t]);
    const float gz = sub(row[lz < 7 ? t + 1 : t], row[lz > 0 ? t - 1 : t]);
    const float gm = mul(0.25f, fmaxf(fabsf(gx), fmaxf(fabsf(gy), fabsf(gz))));
    const float mag_f = fabsf(new_t);
    const int mag = static_cast<int>(clampf(rintf(mul(mag_f, 16383.0f)), 0.0f, 16383.0f));
    const int val = ((quantize(gz, gm) + 1) << 28) | ((quantize(gy, gm) + 1) << 26) |
                    ((quantize(gx, gm) + 1) << 24) | (mag << 10) |
                    (static_cast<int>(new_t < 0.0f) << 9) | t;
    const bool live = mag_f < a.band && new_w > 0.0f;
    const bool inner = live && mag_f < a.half_band;
    const bool outer = live && !inner;
    const unsigned inner_bits = __ballot_sync(0xFFFFFFFFu, inner);
    const unsigned outer_bits = __ballot_sync(0xFFFFFFFFu, outer);
    if (lane == 0) {
      inner_of[warp] = __popc(inner_bits);
      outer_of[warp] = __popc(outer_bits);
    }
    const bool any_changed = __syncthreads_or(changed) != 0;
    int inner_before = 0, outer_before = 0, n_inner = 0, n_outer = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int ni = inner_of[k], no = outer_of[k];
      inner_before += k < warp ? ni : 0;
      outer_before += k < warp ? no : 0;
      n_inner += ni;
      n_outer += no;
    }
    const int live_count = n_inner + n_outer;
    const int kept = min(live_count, a.slots);
    int* surf = a.surfpack + static_cast<long long>(id) * a.slots;
    const int pos = inner ? inner_before + __popc(inner_bits & lower)
                          : n_inner + outer_before + __popc(outer_bits & lower);
    if (live && pos < a.slots) surf[pos] = val;
    if (t >= kept && t < a.slots) surf[t] = kEmptySurfel;
    if (t == 0) {
      a.surf_count[id] = kept;
      dropped += live_count - kept;
      if (!a.gate || any_changed) a.mesh_dirty[id] = 1;
    }
    // The next block's first barrier orders this block's reads of row and
    // of the warps' counts before their next writes.
  }
  if (t == 0 && dropped != 0) atomicAdd(a.surf_overflow, dropped);
}

// CTAs of the persistent grid on the current device: as many as its SMs
// hold at once, found once a device.
cudaError_t grid_size(int* blocks) {
  static std::mutex mu;
  static std::map<int, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(dev);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrate_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = known[dev] = sms * std::max(per_sm, 1);
  return cudaSuccess;
}

}  // namespace

// Fuse the frame's packed image into the blocks listed in ids[:*count] (at
// most capacity), in place; see the file's head.  gate: the mesh-dirty gate
// is on (mesh_dirty_eps > 0), else every fused block is marked.  Returns the
// error.
extern "C" int vulcan_integrate(void* ids, void* count, void* block_coords, void* pose,
                                void* image, int capacity, int h, int w, int slots, int gate,
                                float fx, float fy, float cx, float cy, float voxel_size,
                                float depth_scale, float depth_min, float depth_max, float mu,
                                float inv_mu, float max_weight, float band, float half_band,
                                float eps, void* tsdf, void* weight, void* colorpack,
                                void* surfpack, void* surf_count, void* mesh_dirty,
                                void* surf_overflow, void* launches, void* stream) {
  if (capacity < 0 || h < 1 || w < 1 || slots < 1 || slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = grid_size(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  blocks = std::max(1, std::min(blocks, capacity));
  IntegrateArgs a{static_cast<const int*>(ids), static_cast<const int*>(count),
                  static_cast<const int*>(block_coords), static_cast<const float*>(pose),
                  static_cast<const int*>(image), capacity, h, w, slots, gate,
                  fx, fy, cx, cy, voxel_size, depth_scale, depth_min, depth_max,
                  mu, inv_mu, max_weight, band, half_band, eps,
                  static_cast<float*>(tsdf), static_cast<float*>(weight),
                  static_cast<int*>(colorpack), static_cast<int*>(surfpack),
                  static_cast<int*>(surf_count), static_cast<unsigned char*>(mesh_dirty),
                  static_cast<int*>(surf_overflow), static_cast<unsigned int*>(launches)};
  integrate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
