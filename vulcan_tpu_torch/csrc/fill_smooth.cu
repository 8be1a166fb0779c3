// K2: post-splat z-buffer hole fill + edge-aware smoothing for Hopper
// (sm_90a).
//
// Replaces the TPU kernel vulcan_tpu/ops/splat.py::_fill_smooth_pallas
// (body _fill_smooth_math).  Input: depth with +inf for empty pixels.
//   fill round (x rounds): an empty pixel takes the min of its 8 neighbours
//     when their finite depths span < 2 mu; every round reads the previous
//     round's whole image;
//   smooth: a finite pixel becomes the mean of itself and the neighbours
//     within 0.5 mu of it (acc starts at the centre, cnt at 1; neighbours
//     added dy-outer, dx-inner like the reference).
// Off-image taps read +inf.  Min and max are exact; the smoothing sum uses
// __fadd_rn so it rounds like the plain PyTorch version.
//
// What bounds it on the card: at 640x480 each pass reads 1.2 MB (nine taps
// of it, served by L1/L2) and writes 1.2 MB -- a few microseconds of
// memory traffic per pass -- so the three passes are bound by launch
// latency.  Design: the fill rounds are global dependencies, so each pass
// is its own launch, one thread per pixel, ping-ponging between two
// scratch buffers the wrapper allocates; the smoothing pass writes the
// output.  Fusing the passes into one tile with a rounds+1 halo is later
// work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__device__ __forceinline__ float tap(const float* __restrict__ d, int h, int w,
                                     int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? d[y * w + x] : INFINITY;
}

__global__ void __launch_bounds__(kBX * kBY)
fill_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
            int w, float two_mu) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float c = in[y * w + x];
  if (isfinite(c)) {
    out[y * w + x] = c;
    return;
  }
  float best = c;
  float worst = -INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const float n = tap(in, h, w, y + dy, x + dx);
      best = fminf(best, n);
      worst = fmaxf(worst, isfinite(n) ? n : -INFINITY);
    }
  }
  out[y * w + x] = (__fsub_rn(worst, best) < two_mu) ? best : c;
}

__global__ void __launch_bounds__(kBX * kBY)
smooth_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
              int w, float half_mu) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float c = in[y * w + x];
  if (!isfinite(c)) {
    out[y * w + x] = c;
    return;
  }
  float acc = c;
  float cnt = 1.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const float n = tap(in, h, w, y + dy, x + dx);
      if (isfinite(n) && fabsf(__fsub_rn(n, c)) < half_mu) {
        acc = __fadd_rn(acc, n);
        cnt = __fadd_rn(cnt, 1.0f);
      }
    }
  }
  out[y * w + x] = acc / fmaxf(cnt, 1.0f);
}

}  // namespace

// Runs `rounds` fill passes (in -> a -> b -> a ...) and the smoothing pass
// into `out`.  `a` and `b` are scratch images of the same shape; `in` is
// not written.  Returns cudaGetLastError().
extern "C" int vulcan_fill_smooth(const float* in, float* a, float* b,
                                  float* out, int h, int w, int rounds,
                                  float two_mu, float half_mu, void* stream) {
  if (rounds < 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  const float* src = in;
  for (int r = 0; r < rounds; ++r) {
    float* dst = (r % 2 == 0) ? a : b;
    fill_kernel<<<grid, block, 0, s>>>(src, dst, h, w, two_mu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  smooth_kernel<<<grid, block, 0, s>>>(src, out, h, w, half_mu);
  return static_cast<int>(cudaGetLastError());
}
