// A device-side branch inside a captured CUDA graph: the counterpart of
// gridpp_tpu's jax.lax.cond in the general path's guard
// (gridpp_tpu/api/pipeline.py:257), for gridpp_tpu_torch/ops/graph.py.
//
// gc_begin_if, called while `stream` captures a graph, adds to that graph a
// one-thread kernel that reads a 0-dim bool on the device and sets a new
// conditional handle from it, then an IF node on that handle. Work captured
// on `stream` after the call depends on the IF node; `body_stream` starts
// capturing into the node's body graph, which runs at a replay only when the
// bool is true. gc_end_if ends the body's capture. The host never reads the
// bool. gc_upload uploads an instantiated graph before its first launch.
//
// What bounds it: nothing measurable. The setter reads one byte; the node
// costs the graph a launch of its body when taken. It needs CUDA 12.4 or
// later (conditional nodes, cudaStreamBeginCaptureToGraph).
#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "graph_cond.cu needs CUDA 12.4 or later (conditional graph nodes)"
#endif

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Returns 0, -3 when `stream` is not capturing, or the cudaError_t that
// failed.
int gc_begin_if(const void* pred, void* stream, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return -3;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_conditional<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the IF node goes after the setter: the capture's dependencies now
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  return static_cast<int>(err);
}

// Uploads an instantiated graph's work to the device on `stream`, so that
// its first launch costs what later ones do. Returns 0 or the cudaError_t.
int gc_upload(void* graph_exec, void* stream) {
  return static_cast<int>(
      cudaGraphUpload(static_cast<cudaGraphExec_t>(graph_exec),
                      static_cast<cudaStream_t>(stream)));
}

// Ends the body's capture that gc_begin_if began on body_stream. Returns 0
// or the cudaError_t that failed.
int gc_end_if(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

}  // extern "C"
