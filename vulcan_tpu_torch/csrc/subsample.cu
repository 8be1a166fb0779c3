// T5: stride-2 image subsample, out[y, x] = in[2y, 2x], for Hopper (sm_90a).
//
// Replaces the TPU probe tools/bench_subsample.py::s_pallas, which takes
// x[::2, ::2] of a (480, 640) int32 image by an in-kernel reshape.  The
// output is ((H + 1) / 2, (W + 1) / 2), exactly the elements x[::2, ::2]
// selects, so odd sizes are taken too.  It is pure selection: the kernel
// copies 32-bit words and serves int32 and float32 alike, bit-exact.
//
// What bounds it on the card: bytes.  Only the even rows are needed (the
// odd columns come with them in every 32-byte sector), so at 480x640 the
// function reads 614,400 B and writes 307,200 B: 921,600 B, 0.28 us at
// the H100 SXM's 3.35 TB/s.  A launch costs more than that, so one call is
// launch-bound.  Design: one thread per output element, 32x8 blocks; a
// warp's loads span 256 contiguous bytes of one even row and its stores
// 128 contiguous bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__global__ void __launch_bounds__(kBX * kBY)
subsample2_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int w, int ho, int wo) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= wo || y >= ho) return;
  out[y * wo + x] = in[(2 * y) * w + 2 * x];
}

}  // namespace

// in: (h, w) 4-byte elements; out: ((h+1)/2, (w+1)/2).  Returns
// cudaGetLastError().
extern "C" int vulcan_subsample2(const void* in, void* out, int h, int w,
                                 void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h + 1) / 2;
  const int wo = (w + 1) / 2;
  const dim3 block(kBX, kBY);
  const dim3 grid((wo + kBX - 1) / kBX, (ho + kBY - 1) / kBY);
  subsample2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), w, ho,
      wo);
  return static_cast<int>(cudaGetLastError());
}
