// K2: post-splat z-buffer hole fill + edge-aware smoothing in ONE launch,
// for Hopper (sm_90a).
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
// __fadd_rn and the mean __fdiv_rn, so it rounds like the plain version.
//
// What bounds it on the card: at 640x480 the function reads the image once
// and writes it once, 2.46 MB, 0.73 us at the H100 SXM's 3.35 TB/s, and its
// ~118 f32 operations a pixel take 0.54 us at 67 TFLOP/s.  So neither bytes
// nor operations set its time: launch, the latency of staging a tile, and
// the dependent phases (fill rounds, then smoothing) do.  The earlier design
// ran each pass as its own launch over the whole image (three launches for
// two rounds); the T1 probe (csrc/fill_smooth_fused.cu) showed one launch
// with a rounds + 1 halo saves a quarter of that, and still sat 11x over
// the bound with one thread walking 4-6 pixels a phase, 9 shared loads and
// ~40 instructions a fill pixel.
//
// Design: one launch runs R <= kMaxRounds fill rounds and the smoothing
// pass.  A block of 128 threads owns a 32x16 output tile: 600 blocks of 4
// warps at 480x640, 4-5 an SM, which spread over 132 SMs more evenly than
// the 300 blocks of a 32x32 tile.  It stages the tile plus a halo of R + 1
// pixels into shared memory with cp.async, a thread a column (no register
// round trip; off-image pixels are written +inf; TMA would need a tensor
// map encoded on the host for every call and 16-byte row strides, cp.async
// takes any width), then runs fill round r on the tile grown by R - r
// pixels, ping-ponging two shared buffers, and smooths the tile straight to
// global memory.  In every pass a thread owns
// one column of a strip of rows and slides a 3-row window down it: each
// new row is 3 shared loads (9 for the old walk), all of them independent
// and issued ahead of the arithmetic; the fill takes its box min/max
// separably (a row's min/max of 3 once, reused by the three rows below).
// The strip height is the pass height over the strips the block's threads
// make, so every pass is one step a thread.  The count check of the
// smoothing drops the reference's isfinite(n): |n - c| < 0.5 mu is false
// for an infinite n when c is finite.
//
// Rounds beyond kMaxRounds run as more launches of the same kernel, the
// first ones filling only (kSmooth false, exactly kMaxRounds rounds, halo
// kMaxRounds); ops/cuda_kernels.py fill_smooth_plan splits them.
#include <cuda_runtime.h>
#include <math.h>

#include "launch_count.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreads = 128;
constexpr int kMaxRounds = 4;
// Rows of slack below each shared buffer: the last strip of a pass may
// load up to a strip's height past the region (its results are not kept).
constexpr int kPadRows = 8;

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return static_cast<unsigned>(y) < static_cast<unsigned>(h) &&
         static_cast<unsigned>(x) < static_cast<unsigned>(w);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// How the block's threads walk a region of NH x NW pixels: a thread owns
// one column of a strip of kRows rows; the strips stack down the region.
template <int SH, int NH, int NW, int LO>
struct Walk {
  static_assert(NW <= kThreads, "a region row needs a thread a column");
  static constexpr int kRows = (NH + kThreads / NW - 1) / (kThreads / NW);
  static constexpr int kStrips = (NH + kRows - 1) / kRows;
  static constexpr int kUnits = kStrips * NW;
  static_assert(LO + kStrips * kRows + 1 <= SH + kPadRows,
                "the last strip's window runs past the padded buffer");
};

struct Row {
  float l, c, r;
};

__device__ __forceinline__ Row load_row(const float* p) {
  return {p[-1], p[0], p[1]};
}

__device__ __forceinline__ float finite_or_neg_inf(float v) {
  return isfinite(v) ? v : -INFINITY;
}

// One fill round over rows/columns [LO, LO + NH) x [LO, LO + NW) of the
// SH x SW shared tile whose pixel (0, 0) is image pixel (gy0, gx0).
template <int SH, int SW, int LO>
__device__ __forceinline__ void fill_pass(const float* __restrict__ src,
                                          float* __restrict__ dst, int gy0,
                                          int gx0, int h, int w,
                                          float two_mu) {
  constexpr int NH = SH - 2 * LO;
  constexpr int NW = SW - 2 * LO;
  using Wk = Walk<SH, NH, NW, LO>;
  const int u = threadIdx.x;
  if (u >= Wk::kUnits) return;
  const int tx = LO + u % NW;
  const int ty0 = LO + (u / NW) * Wk::kRows;
  const int n = min(Wk::kRows, LO + NH - ty0);
  const bool col_in = static_cast<unsigned>(gx0 + tx) < static_cast<unsigned>(w);

  Row rows[Wk::kRows + 2];
#pragma unroll
  for (int i = 0; i < Wk::kRows + 2; ++i) {
    rows[i] = load_row(src + (ty0 - 1 + i) * SW + tx);
  }
  float hmin[Wk::kRows + 2], hmax[Wk::kRows + 2];
#pragma unroll
  for (int i = 0; i < Wk::kRows + 2; ++i) {
    hmin[i] = fminf(fminf(rows[i].l, rows[i].c), rows[i].r);
    hmax[i] = fmaxf(fmaxf(finite_or_neg_inf(rows[i].l), finite_or_neg_inf(rows[i].c)),
                    finite_or_neg_inf(rows[i].r));
  }
#pragma unroll
  for (int i = 0; i < Wk::kRows; ++i) {
    if (i < n) {
      // The centre is +inf wherever the fill applies, so the box min over
      // all 9 is the min over the 8 neighbours, and the box max of the
      // finite values is the neighbours' (the centre maps to -inf).
      const float c = rows[i + 1].c;
      const float best = fminf(fminf(hmin[i], hmin[i + 1]), hmin[i + 2]);
      const float worst = fmaxf(fmaxf(hmax[i], hmax[i + 1]), hmax[i + 2]);
      const bool in = col_in && static_cast<unsigned>(gy0 + ty0 + i) <
                                    static_cast<unsigned>(h);
      dst[(ty0 + i) * SW + tx] =
          (in && !isfinite(c) && __fsub_rn(worst, best) < two_mu) ? best : c;
    }
  }
}

__device__ __forceinline__ void tap(float n, float c, float half_mu,
                                    float& acc, int& cnt) {
  if (fabsf(__fsub_rn(n, c)) < half_mu) {
    acc = __fadd_rn(acc, n);
    ++cnt;
  }
}

// The smoothing pass over the output tile, written to global memory.
template <int SH, int SW, int LO>
__device__ __forceinline__ void smooth_pass(const float* __restrict__ src,
                                            float* __restrict__ out, int gy0,
                                            int gx0, int h, int w,
                                            float half_mu) {
  using Wk = Walk<SH, kTileH, kTileW, LO>;
  const int u = threadIdx.x;
  if (u >= Wk::kUnits) return;
  const int tx = LO + u % kTileW;
  const int ty0 = LO + (u / kTileW) * Wk::kRows;
  const int n = min(Wk::kRows, LO + kTileH - ty0);
  const int gx = gx0 + tx;
  if (static_cast<unsigned>(gx) >= static_cast<unsigned>(w)) return;

  Row rows[Wk::kRows + 2];
#pragma unroll
  for (int i = 0; i < Wk::kRows + 2; ++i) {
    rows[i] = load_row(src + (ty0 - 1 + i) * SW + tx);
  }
#pragma unroll
  for (int i = 0; i < Wk::kRows; ++i) {
    const int gy = gy0 + ty0 + i;
    if (i < n && gy < h) {
      const Row& a = rows[i];
      const Row& b = rows[i + 1];
      const Row& c = rows[i + 2];
      const float v = b.c;
      float o = v;
      if (isfinite(v)) {
        float acc = v;
        int cnt = 1;
        tap(a.l, v, half_mu, acc, cnt);
        tap(a.c, v, half_mu, acc, cnt);
        tap(a.r, v, half_mu, acc, cnt);
        tap(b.l, v, half_mu, acc, cnt);
        tap(b.r, v, half_mu, acc, cnt);
        tap(c.l, v, half_mu, acc, cnt);
        tap(c.c, v, half_mu, acc, cnt);
        tap(c.r, v, half_mu, acc, cnt);
        o = __fdiv_rn(acc, static_cast<float>(cnt));
      }
      out[gy * w + gx] = o;
    }
  }
}

template <int SH, int SW, int R, int r = 0>
__device__ __forceinline__ void fill_rounds(float* b0, float* b1, int gy0,
                                            int gx0, int h, int w,
                                            float two_mu) {
  if constexpr (r < R) {
    fill_pass<SH, SW, r + 1>(r % 2 ? b1 : b0, r % 2 ? b0 : b1, gy0, gx0, h, w,
                             two_mu);
    __syncthreads();
    fill_rounds<SH, SW, R, r + 1>(b0, b1, gy0, gx0, h, w, two_mu);
  }
}

template <int R, bool kSmooth>
__global__ void __launch_bounds__(kThreads)
fill_smooth_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int h, int w, float two_mu, float half_mu, unsigned int* launches) {
  count_launch(launches);
  constexpr int kHalo = R + (kSmooth ? 1 : 0);
  constexpr int SH = kTileH + 2 * kHalo;
  constexpr int SW = kTileW + 2 * kHalo;
  __shared__ float buf[2][(SH + kPadRows) * SW];
  const int gy0 = blockIdx.y * kTileH - kHalo;
  const int gx0 = blockIdx.x * kTileW - kHalo;

  // Staging: a thread owns one column of the tile and walks its rows,
  // kRowStep rows apart (kRowStep rows of the tile are staged at once).
  constexpr int kRowStep = kThreads / SW;
  static_assert(kRowStep >= 1, "a tile row needs a thread a column");
  if (threadIdx.x < kRowStep * SW) {
    const int tx = threadIdx.x % SW;
    const int gx = gx0 + tx;
    const bool col_in = static_cast<unsigned>(gx) < static_cast<unsigned>(w);
    for (int ty = threadIdx.x / SW; ty < SH; ty += kRowStep) {
      const int gy = gy0 + ty;
      float* s = &buf[0][ty * SW + tx];
      if (col_in && static_cast<unsigned>(gy) < static_cast<unsigned>(h)) {
        cp_async4(s, in + gy * w + gx);
      } else {
        *s = INFINITY;  // the reference pads every shift with +inf
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  fill_rounds<SH, SW, R>(buf[0], buf[1], gy0, gx0, h, w, two_mu);
  const float* src = buf[R % 2];
  if constexpr (kSmooth) {
    smooth_pass<SH, SW, kHalo>(src, out, gy0, gx0, h, w, half_mu);
  } else {
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int ty = kHalo + i / kTileW;
      const int tx = kHalo + i % kTileW;
      if (inside(gy0 + ty, gx0 + tx, h, w)) {
        out[(gy0 + ty) * w + gx0 + tx] = src[ty * SW + tx];
      }
    }
  }
}

template <int R, bool kSmooth>
void launch(const float* in, float* out, int h, int w, float two_mu,
            float half_mu, unsigned int* launches, cudaStream_t s) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fill_smooth_kernel<R, kSmooth><<<grid, kThreads, 0, s>>>(in, out, h, w,
                                                          two_mu, half_mu, launches);
}

}  // namespace

// One launch: `rounds` fill rounds of `in` into `out` (both (h, w) f32,
// +inf = empty), then the smoothing pass when `smooth` is nonzero.  Takes
// rounds in [0, 4] with smooth, exactly 4 without (the fill-only launches
// of a longer plan).  `in` is not written.  Returns cudaGetLastError();
// cudaErrorInvalidValue for anything else.
extern "C" int vulcan_fill_smooth(const float* in, float* out, int h, int w,
                                  int rounds, int smooth, float two_mu,
                                  float half_mu, void* launches, void* stream) {
  if (h <= 0 || w <= 0 || rounds < 0 || rounds > kMaxRounds ||
      (!smooth && rounds != kMaxRounds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* counter = static_cast<unsigned int*>(launches);
  if (!smooth) {
    launch<kMaxRounds, false>(in, out, h, w, two_mu, half_mu, counter, s);
  } else {
    switch (rounds) {
      case 0: launch<0, true>(in, out, h, w, two_mu, half_mu, counter, s); break;
      case 1: launch<1, true>(in, out, h, w, two_mu, half_mu, counter, s); break;
      case 2: launch<2, true>(in, out, h, w, two_mu, half_mu, counter, s); break;
      case 3: launch<3, true>(in, out, h, w, two_mu, half_mu, counter, s); break;
      default: launch<4, true>(in, out, h, w, two_mu, half_mu, counter, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
