// K1: edge-preserving bilateral depth filter for Hopper (sm_90a).
//
// Replaces the TPU kernel vulcan_tpu/ops/preprocess.py::_bilateral_pallas
// (body _bilateral_math).  Same math, tap for tap:
//   w = space_w[dy,dx] * exp(-(d - c)^2 / (2 sigma_d^2)), w = 0 where d <= 0,
//   out = sum(w d) / sum(w) over the (2r+1)^2 window, 0 where the centre is
//   invalid or no tap has weight.  Off-image taps read 0 (excluded).
// Taps are summed dy-outer, dx-inner like the reference, and the sums use
// __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs: the kernel
// then rounds like the plain PyTorch version, apart from expf's last ulp.
// The (2r+1)^2 spatial weights are computed on the host exactly as the
// reference does (math.exp, rounded to f32) and passed by value.
//
// What bounds it on the card: at 640x480 the image is 1.2 MB in and 1.2 MB
// out (~2.5 MB of DRAM traffic, under a microsecond at HBM rate) and 25
// expf per pixel (~7.7M, a few microseconds of SFU time), so one call is
// bound by launch latency and the tile load, not by bandwidth or math.
// Design: one thread per pixel, a 32x8 block over a shared-memory tile with
// an r-pixel zero halo, so each depth value is read from DRAM once per
// tile; the radius is a template parameter so the tap loop unrolls and the
// weights stay in the kernel's parameter bank.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 4;
constexpr int kBX = 32;
constexpr int kBY = 8;

struct SpaceWeights {
  float w[(2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];
};

template <int R>
__global__ void __launch_bounds__(kBX * kBY)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int h, int w, SpaceWeights sw, float inv_2sd) {
  constexpr int TW = kBX + 2 * R;
  constexpr int TH = kBY + 2 * R;
  __shared__ float tile[TH * TW];

  const int x0 = blockIdx.x * kBX - R;
  const int y0 = blockIdx.y * kBY - R;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < TH * TW; i += kBX * kBY) {
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? depth[gy * w + gx]
                                                       : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;

  const float c = tile[(threadIdx.y + R) * TW + threadIdx.x + R];
  float acc = 0.0f;
  float wacc = 0.0f;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float d = tile[(threadIdx.y + R + dy) * TW + threadIdx.x + R + dx];
      const float diff = d - c;
      const float e = expf(__fmul_rn(-__fmul_rn(diff, diff), inv_2sd));
      float wt = __fmul_rn(sw.w[(dy + R) * (2 * R + 1) + (dx + R)], e);
      wt = d > 0.0f ? wt : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(wt, d));
      wacc = __fadd_rn(wacc, wt);
    }
  }
  const float o = wacc > 0.0f ? acc / fmaxf(wacc, 1e-12f) : 0.0f;
  out[y * w + x] = c > 0.0f ? o : 0.0f;
}

template <int R>
void launch(const float* depth, float* out, int h, int w,
            const SpaceWeights& sw, float inv_2sd, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  bilateral_kernel<R><<<grid, block, 0, stream>>>(depth, out, h, w, sw,
                                                   inv_2sd);
}

}  // namespace

// space_w is a HOST array of (2r+1)^2 floats.  Returns cudaGetLastError();
// cudaErrorInvalidValue for a radius outside [0, kMaxRadius].
extern "C" int vulcan_bilateral(const float* depth, float* out, int h, int w,
                                int radius, const float* space_w,
                                float inv_2sd, void* stream) {
  if (radius < 0 || radius > kMaxRadius || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpaceWeights sw = {};
  const int n = (2 * radius + 1) * (2 * radius + 1);
  for (int i = 0; i < n; ++i) sw.w[i] = space_w[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: launch<0>(depth, out, h, w, sw, inv_2sd, s); break;
    case 1: launch<1>(depth, out, h, w, sw, inv_2sd, s); break;
    case 2: launch<2>(depth, out, h, w, sw, inv_2sd, s); break;
    case 3: launch<3>(depth, out, h, w, sw, inv_2sd, s); break;
    default: launch<4>(depth, out, h, w, sw, inv_2sd, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
