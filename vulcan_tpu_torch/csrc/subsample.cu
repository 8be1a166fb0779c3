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
// the H100 SXM's 3.35 TB/s.  A launch and the first load's latency cost
// more than that, so one call is bound by launch and latency, and the
// design keeps the work in flight short: each thread writes 4 outputs (one
// 16-byte store) from two 16-byte loads of the even row, so 480x640 takes
// 19,200 working threads in 360 blocks of 32x2 (a warp along a row, no
// division in the index), under one wave on 132 SMs, with 3 memory
// instructions a thread where the first design (one thread an output) had
// 2 for every output.  A chunk of 4 outputs whose 8 input words run past
// the row's end, or whose addresses are not 16-byte aligned (odd W, or an
// output row of W/2 not a multiple of 4), is copied word by word by the
// same thread: the remainder is part of the kernel, so any (H, W) works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;    // threads along a row, kChunk outputs each
constexpr int kBY = 2;     // output rows a block
constexpr int kChunk = 4;  // outputs a thread: one 16-byte store

__global__ void __launch_bounds__(kBX * kBY)
subsample2_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int w, int ho, int wo) {
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int x0 = (blockIdx.x * kBX + threadIdx.x) * kChunk;
  if (y >= ho || x0 >= wo) return;
  const uint32_t* src = in + static_cast<size_t>(2 * y) * w + 2 * x0;
  uint32_t* dst = out + static_cast<size_t>(y) * wo + x0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (aligned && 2 * x0 + 2 * kChunk <= w) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    *reinterpret_cast<uint4*>(dst) = make_uint4(a.x, a.z, b.x, b.z);
  } else {
    const int n = min(kChunk, wo - x0);
    for (int k = 0; k < n; ++k) dst[k] = __ldg(src + 2 * k);
  }
}

}  // namespace

// in: (h, w) 4-byte elements; out: ((h+1)/2, (w+1)/2).  Returns
// cudaGetLastError().
extern "C" int vulcan_subsample2(const void* in, void* out, int h, int w,
                                 void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h + 1) / 2;
  const int wo = (w + 1) / 2;
  const int chunks = (wo + kChunk - 1) / kChunk;
  const dim3 grid((chunks + kBX - 1) / kBX, (ho + kBY - 1) / kBY);
  subsample2_kernel<<<grid, dim3(kBX, kBY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), w, ho,
      wo);
  return static_cast<int>(cudaGetLastError());
}
