// An IF node added to a CUDA graph under stream capture: the device-side
// branch of the resident loops' rebin decision (ops/resident_graph.py, the
// counterpart of the lax.cond inside the JAX package's compiled loops).
//
// egg_if_node, called while `stream` is capturing, appends to the captured
// graph, after the work captured so far: a one-thread kernel that reads the
// device flag `pred` (one bool) into a conditional handle, then an IF node
// on that handle whose body runs a copy of `body` (a graph captured before,
// the branch), and the capture continues after the IF node. At each replay
// the card sets the handle from the flag and takes the branch or not:
// nothing is read back to the host.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph `stream` captures into and the nodes the next one depends on.
cudaError_t capture_tip(cudaStream_t stream, cudaGraph_t* graph,
                        const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess : cudaErrorIllegalState;
}

}  // namespace

extern "C" int egg_if_node(cudaStream_t stream, const void* pred,
                           cudaGraph_t body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_tip(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, stream>>>(handle,
                                            static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_tip(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, body);
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
}
