// K1: edge-preserving bilateral depth filter for Hopper (sm_90a).
//
// Replaces the TPU kernel vulcan_tpu/ops/preprocess.py::_bilateral_pallas
// (body _bilateral_math).  Same function:
//   w = exp(-(dy^2+dx^2) / (2 sigma_s^2)) * exp(-(d - c)^2 / (2 sigma_d^2)),
//   w = 0 where d <= 0, out = sum(w d) / sum(w) over the (2r+1)^2 window,
//   0 where the centre is invalid.  Off-image taps are invalid.
//
// What bounds it on the card: at 640x480 the image is 1.2 MB in and 1.2 MB
// out (under a microsecond at HBM rate) against 7.4M taps, so the kernel is
// bound by instruction throughput, above all by what one tap costs, and
// after that by one launch's latency.  What the design does about it:
//   * One ex2 a tap.  The two exponentials fold into one power of two,
//       w = exp2(diff^2 * neg_a + neg_s[dy][dx]),
//     neg_a = -log2(e) / (2 sigma_d^2), neg_s = -(dy^2+dx^2) log2(e) /
//     (2 sigma_s^2), both computed on the host in double, rounded to f32 and
//     cached per filter setting (ops/cuda_kernels.py bilateral_constants).
//     A tap is a subtract, a multiply, an FMA, ex2.approx.ftz.f32 (one
//     MUFU.EX2, no range reduction), an FMA into the weighted sum and an add
//     into the weight sum.  ex2.approx is good to 2 ulp and the folded
//     argument rounds to 2^-24 of itself: a weight is off by a few 1e-6 of
//     itself and the filtered depth by about 1e-6 m, inside the 1e-5 m it is
//     held to.  A weight flushed to 0 is harmless: the centre weighs 1.
//   * No validity test a tap.  An invalid or off-image depth is staged as
//     kInvalid, so far from any real depth that its weight comes out as
//     exactly 0 (diff^2 = 1e36, ex2 of a huge negative number) and 0 * d
//     adds nothing.  The centre tap is weight 1 without an ex2, which also
//     makes the weight sum >= 1 wherever an output is written.
//   * Several outputs a thread.  A thread filters kP vertically adjacent
//     pixels from a (kP + 2r) x (2r + 1) window it loads once from shared
//     memory: 10 shared loads a pixel at r = 2 instead of 25.
//   * Staging in 16-byte loads.  A tile row is the aligned 40-float span
//     that contains the 32 pixels and their halo; a chunk of 4 lies wholly
//     inside or outside the image when the width is a multiple of 4 (any
//     other width, or an unaligned image, takes the word-by-word loop).
//   * A 32 x (kP * kBY) tile small enough that the tiles spread evenly over
//     the SMs in one wave (600 tiles of 256 threads at 640x480).
// The radius is a template parameter so the tap loops unroll and the
// exponents stay in the kernel's parameter bank.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_count.cuh"

#ifndef K1_ROWS_PER_THREAD
#define K1_ROWS_PER_THREAD 2
#endif
#ifndef K1_BLOCK_ROWS
#define K1_BLOCK_ROWS 8
#endif

namespace {

constexpr int kMaxRadius = 4;
constexpr int kBX = 32;
constexpr int kP = K1_ROWS_PER_THREAD;   // outputs a thread, down a column
constexpr int kBY = K1_BLOCK_ROWS;       // thread rows a block
constexpr int kTY = kP * kBY;            // tile height
constexpr int kPad = 4;                  // staged margin each side, in floats
constexpr int kTW = kBX + 2 * kPad;      // staged row: 10 chunks of 16 bytes
constexpr float kInvalid = -1e18f;       // ops/cuda_kernels.py BILATERAL_INVALID

static_assert(kPad >= kMaxRadius && kPad % 4 == 0, "the margin holds the halo");

struct TapExponents {
  float neg_s[(2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float staged(float d) {
  return d > 0.0f ? d : kInvalid;
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kBX * kBY)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int h, int w, TapExponents te, float neg_a, unsigned int* launches) {
  count_launch(launches);
  constexpr int TH = kTY + 2 * R;
  __shared__ __align__(16) float tile[TH * kTW];

  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kTY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  if (kVec) {
    constexpr int kChunks = kTW / 4;
    for (int i = tid; i < TH * kChunks; i += kBX * kBY) {
      const int ty = i / kChunks;
      const int ch = i - ty * kChunks;
      const int gy = y0 - R + ty;
      const int gx = x0 - kPad + 4 * ch;
      float4 q = make_float4(kInvalid, kInvalid, kInvalid, kInvalid);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        q = __ldg(reinterpret_cast<const float4*>(
            depth + static_cast<size_t>(gy) * w + gx));
        q = make_float4(staged(q.x), staged(q.y), staged(q.z), staged(q.w));
      }
      *reinterpret_cast<float4*>(&tile[ty * kTW + 4 * ch]) = q;
    }
  } else {
    for (int i = tid; i < TH * kTW; i += kBX * kBY) {
      const int ty = i / kTW;
      const int gy = y0 - R + ty;
      const int gx = x0 - kPad + (i - ty * kTW);
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      tile[i] = in ? staged(depth[static_cast<size_t>(gy) * w + gx]) : kInvalid;
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= w) return;
  const int ly = threadIdx.y * kP;
  float win[kP + 2 * R][2 * R + 1];
#pragma unroll
  for (int j = 0; j < kP + 2 * R; ++j) {
#pragma unroll
    for (int i = 0; i < 2 * R + 1; ++i) {
      win[j][i] = tile[(ly + j) * kTW + kPad - R + threadIdx.x + i];
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int y = y0 + ly + p;
    if (y >= h) break;
    const float c = win[p + R][R];
    float acc = c;
    float wacc = 1.0f;
#pragma unroll
    for (int dy = 0; dy < 2 * R + 1; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2 * R + 1; ++dx) {
        if (dy == R && dx == R) continue;
        const float d = win[p + dy][dx];
        const float diff = d - c;
        const float wt =
            ex2(fmaf(diff * diff, neg_a, te.neg_s[dy * (2 * R + 1) + dx]));
        acc = fmaf(wt, d, acc);
        wacc += wt;
      }
    }
    out[static_cast<size_t>(y) * w + x] = c > 0.0f ? acc / wacc : 0.0f;
  }
}

template <int R>
void launch(const float* depth, float* out, int h, int w,
            const TapExponents& te, float neg_a, unsigned int* launches,
            cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kTY - 1) / kTY);
  if (w % 4 == 0 && reinterpret_cast<uintptr_t>(depth) % 16 == 0) {
    bilateral_kernel<R, true><<<grid, block, 0, stream>>>(depth, out, h, w, te,
                                                          neg_a, launches);
  } else {
    bilateral_kernel<R, false><<<grid, block, 0, stream>>>(depth, out, h, w,
                                                           te, neg_a, launches);
  }
}

}  // namespace

// neg_s is a HOST array of (2r+1)^2 floats, dy-outer.  Returns
// cudaGetLastError(); cudaErrorInvalidValue for a radius outside
// [0, kMaxRadius].
extern "C" int vulcan_bilateral(const float* depth, float* out, int h, int w,
                                int radius, const float* neg_s, float neg_a,
                                void* launches, void* stream) {
  if (radius < 0 || radius > kMaxRadius || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TapExponents te = {};
  const int n = (2 * radius + 1) * (2 * radius + 1);
  for (int i = 0; i < n; ++i) te.neg_s[i] = neg_s[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* counter = static_cast<unsigned int*>(launches);
  switch (radius) {
    case 0: launch<0>(depth, out, h, w, te, neg_a, counter, s); break;
    case 1: launch<1>(depth, out, h, w, te, neg_a, counter, s); break;
    case 2: launch<2>(depth, out, h, w, te, neg_a, counter, s); break;
    case 3: launch<3>(depth, out, h, w, te, neg_a, counter, s); break;
    default: launch<4>(depth, out, h, w, te, neg_a, counter, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
