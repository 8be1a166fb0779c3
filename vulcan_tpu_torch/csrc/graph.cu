// Conditional nodes inside a CUDA graph capture: the device-side loop and
// branch of the step's lax.while_loop and lax.cond counterparts
// (utils/sync.py chunk_loop / cond), built with the runtime's graph API
// because the PyTorch of the card's machine does not expose one.
//
// Replaces the reference's XLA control flow: lax.while_loop at
// vulcan_tpu/ops/sparse.py:377 and vulcan_tpu/ops/splat.py:434,536, and
// lax.cond at vulcan_tpu/pipeline/fusion.py:147,308.
//
// A WHILE node (cudaGraphCondTypeWhile, CUDA 12.4+) runs one chunk loop:
//   vulcan_graph_while, called while `stream` is being captured, creates a
//   conditional handle, captures while_begin_kernel (*offset = 0, handle =
//   min(*count, bound) > 0), adds the WHILE node after it and makes the
//   node the stream's capture dependency.  It returns the handle and the
//   node's body graph, which the caller captures the chunk's body into
//   (vulcan_graph_body_begin / _end).  The body's last node is
//   while_next_kernel (vulcan_graph_while_next): *offset += chunk, handle =
//   *offset < min(*count, bound).  The body runs ceil(min(count, bound) /
//   chunk) times at a replay, reading the chunk's start from *offset.
// An IF/ELSE node (cudaGraphCondTypeIf of size 2, CUDA 12.8+) runs one
//   branch: vulcan_graph_cond captures set_cond_kernel (handle = *pred)
//   and adds the node; body 0 runs where *pred is true, body 1 where it is
//   false.  Size 1 is a plain IF node (only the measurement of phase 2 of
//   chip_smoke.py builds one, as the earlier design's yardstick).
// Nodes nest: a WHILE inside an IF/ELSE body is added to the graph that
// the body's stream captures into.  A refused node returns the runtime's
// error; there is no fallback.
//
// Bound: one launch of a one-thread kernel a node, one more an iteration
// (the launch floor), and the conditional node's own scheduling.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

__device__ __forceinline__ long long trips_end(const int* count, int bound) {
  return static_cast<long long>(min(*count, bound));
}

__global__ void while_begin_kernel(cudaGraphConditionalHandle handle, const int* count,
                                   int bound, long long* offset, unsigned int* launches) {
  count_launch(launches);
  *offset = 0;
  cudaGraphSetConditional(handle, trips_end(count, bound) > 0 ? 1u : 0u);
}

__global__ void while_next_kernel(cudaGraphConditionalHandle handle, const int* count,
                                  int bound, int chunk, long long* offset,
                                  unsigned int* launches) {
  count_launch(launches);
  const long long next = *offset + chunk;
  *offset = next;
  cudaGraphSetConditional(handle, next < trips_end(count, bound) ? 1u : 0u);
}

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                                unsigned int* launches) {
  count_launch(launches);
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph `s` captures into, or an error when it is not capturing.
cudaError_t capturing_graph(cudaStream_t s, cudaGraph_t* graph) {
  cudaStreamCaptureStatus status;
  const cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

// Add a conditional node of `type` and `size` on `handle` after the stream's
// current capture dependencies (the set kernel just captured), make it the
// stream's dependency and write its body graphs to `bodies`.
cudaError_t add_conditional(cudaStream_t s, cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, unsigned int size,
                            cudaGraph_t* bodies) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = size;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  for (unsigned int i = 0; i < size; ++i) bodies[i] = params.conditional.phGraph_out[i];
  return cudaSuccess;
}

}  // namespace

// Load the kernels' module before a capture (a first launch inside one
// would load it there).  Returns the error.
extern "C" int vulcan_graph_prepare(void* stream) {
  (void)stream;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, while_begin_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, while_next_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, set_cond_kernel);
  return static_cast<int>(err);
}

// A stream of the bodies' own, non-blocking (PyTorch's pooled streams
// cycle, so a nested body could be handed its parent's).  out: the stream.
extern "C" int vulcan_graph_stream(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(err);
}

// A WHILE node on `stream` over the 0-d int32 `count`, capped at `bound`;
// `offset` is the 0-d int64 chunk start the body reads.  out: the handle
// and the body graph.
extern "C" int vulcan_graph_while(const void* count, int bound, void* offset, void* launches,
                                  unsigned long long* handle_out, void** body_out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  cudaError_t err = capturing_graph(s, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  while_begin_kernel<<<1, 1, 0, s>>>(handle, static_cast<const int*>(count), bound,
                                     static_cast<long long*>(offset),
                                     static_cast<unsigned int*>(launches));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = nullptr;
  err = add_conditional(s, handle, cudaGraphCondTypeWhile, 1, &body);
  *handle_out = handle;
  *body_out = body;
  return static_cast<int>(err);
}

// The last node of a WHILE body, captured on the body's stream: the next
// chunk's start and whether it runs.
extern "C" int vulcan_graph_while_next(unsigned long long handle, const void* count, int bound,
                                       int chunk, void* offset, void* launches, void* stream) {
  while_next_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const int*>(count), bound, chunk, static_cast<long long*>(offset),
      static_cast<unsigned int*>(launches));
  return static_cast<int>(cudaGetLastError());
}

// An IF node (size 1) or IF/ELSE node (size 2) on the 0-d bool `pred`.
// out: the `size` body graphs (body 0: pred true, body 1: pred false).
extern "C" int vulcan_graph_cond(const void* pred, int size, void* launches, void** bodies_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (size != 1 && size != 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t graph;
  cudaError_t err = capturing_graph(s, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_cond_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred),
                                  static_cast<unsigned int*>(launches));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t bodies[2] = {nullptr, nullptr};
  err = add_conditional(s, handle, cudaGraphCondTypeIf, static_cast<unsigned int>(size),
                        bodies);
  for (int i = 0; i < size; ++i) bodies_out[i] = bodies[i];
  return static_cast<int>(err);
}

// Capture the stream `body` into the body graph `graph` until
// vulcan_graph_body_end.
extern "C" int vulcan_graph_body_begin(void* graph, void* body) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), static_cast<cudaGraph_t>(graph), nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int vulcan_graph_body_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}
