// Span marks of the online step: the device side of utils/timing.py's
// SpanTracer.  A mark is one thread that reads the card's %globaltimer (ns)
// and writes it to the tracer's ring on the device, so that a span's two
// marks time the stage where it runs: in the eager step, and inside the
// captured CUDA graph, where a mark is one kernel node on the top-level
// stream and every WHILE iteration and IF/ELSE branch between a stage's two
// marks falls inside its span.
//
// Replaces no TPU kernel: the reference's step is one XLA program, which
// jax.profiler traces from outside; a CUDA graph's replay has no profiler
// ranges, so the spans are written from inside it.
//
// The ring is (frames, width) int64: row f % frames holds frame f, column 0
// the frame's number and column 1 + slot the time of mark `slot`.  The
// frame's number comes from the tracer's device counter, never from the
// host: the frame's first mark (kFirst) clears its row and tags it, its last
// (kLast) advances the counter.  The host checks the tags at read-out.
//
// Bound: one launch of a one-thread kernel (the launch floor, an empty
// kernel node 0.000988 ms) and two 8-byte stores.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kFirst = 1;   // ops/cuda_kernels.py TRACE_FIRST
constexpr int kLast = 2;    // ops/cuda_kernels.py TRACE_LAST

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void mark_kernel(long long* ring, long long* frame, int width, int frames, int slot,
                            int flags, unsigned int* launches) {
  const long long t = globaltimer();
  count_launch(launches);
  const long long f = *frame;
  long long* row = ring + (f % frames) * width;
  if (flags & kFirst) {
    row[0] = f;
    for (int i = 1; i < width; ++i) row[i] = 0;
  }
  row[1 + slot] = t;
  if (flags & kLast) *frame = f + 1;
}

}  // namespace

// Load the mark's module before a capture (a first launch inside one would
// load it there).  Returns the error.
extern "C" int vulcan_trace_prepare(void* stream) {
  (void)stream;
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, mark_kernel));
}

// One mark on `stream`: the time into slot `slot` of the row of frame
// *frame of the (frames, width) int64 `ring`.
extern "C" int vulcan_trace_mark(void* ring, void* frame, int width, int frames, int slot,
                                 int flags, void* launches, void* stream) {
  mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(frame), width, frames, slot, flags,
      static_cast<unsigned int*>(launches));
  return static_cast<int>(cudaGetLastError());
}
