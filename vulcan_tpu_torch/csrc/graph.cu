// Conditional IF nodes inside a CUDA graph capture: the device-side branch
// that the step's lax.cond and lax.while_loop counterparts need
// (utils/sync.py run_if / cond), built with the runtime's graph API because
// the PyTorch of the card's machine does not expose one.
//
// vulcan_graph_if_begin, called while `stream` is being captured:
//   1. creates a conditional handle in the graph `stream` captures into;
//   2. captures a one-thread kernel that sets the handle from the 0-d bool
//      `pred` on the device (cudaGraphSetConditional) at every replay;
//   3. adds an IF node after it, makes it the stream's capture dependency,
//      so that later work on `stream` follows the node;
//   4. starts capturing `body` into the node's body graph.
// vulcan_graph_if_end ends the body's capture.  The body runs at a replay
// only where *pred is true; nodes nest (an IF inside a body).
//
// Bound: one launch of a one-thread kernel a node (the launch floor), and
// the IF node's own scheduling.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                              unsigned int* launches) {
  count_launch(launches);
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Load the kernel's module before a capture (a first launch inside one
// would load it there).  Returns the error.
extern "C" int vulcan_graph_prepare(void* stream) {
  (void)stream;
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_if_kernel));
}

// A stream of the IF bodies' own, non-blocking (PyTorch's pooled streams
// cycle, so a nested body could be handed its parent's).  out: the stream.
extern "C" int vulcan_graph_stream(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(err);
}

extern "C" int vulcan_graph_if_begin(const void* pred, void* launches, void* body,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred),
                                static_cast<unsigned int*>(launches));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0], nullptr, nullptr,
      0, cudaStreamCaptureModeThreadLocal));
}

extern "C" int vulcan_graph_if_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}
