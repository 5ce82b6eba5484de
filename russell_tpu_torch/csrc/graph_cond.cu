// CUDA graph conditional (IF) nodes for a stream capture in progress: the
// device side of russell_tpu_torch/ode/_device_loop.py's `when`.
//
// Not a port of a TPU kernel. The reference package's fused ODE loops
// skip work with lax.cond / lax.while_loop inside one XLA computation;
// on the card one step attempt is captured as a CUDA graph and replayed,
// and the work that lax.cond skips sits in the body of an IF node whose
// condition a one-thread kernel reads from a bool tensor on the device at
// that point of the replay. PyTorch's own entry points for this
// (CUDAGraph.begin_capture_to_if_node) are missing from the releases the
// card runs, so this file adds the node to the graph that the capturing
// stream records into (CUDA >= 12.4), makes the stream's later work
// depend on it, and starts capturing a second stream into the node's
// body graph. What runs in the body is whatever the caller launches on
// that second stream until cond_if_end.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

}  // namespace

// Adds an IF node, taken when *pred (a bool on the device) is true at that
// point of the replay, to the graph that `parent` is capturing into, after
// the work captured so far; `parent`'s later work depends on the node.
// Then `child` (a stream not capturing) captures into the node's body in
// capture mode `mode` (a cudaStreamCaptureMode) until cond_if_end(child).
// Writes the body graph to *body. Returns a cudaError_t code.
extern "C" int cond_if_begin(void* parent, void* child, const void* pred,
                             int mode, void** body) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(ps, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(ps, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      ps, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      ps, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), body_graph, nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode));
  if (err != cudaSuccess) return err;
  *body = body_graph;
  return cudaSuccess;
}

// Ends the capture of `child` into an IF node's body.
extern "C" int cond_if_end(void* child) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &graph);
}

// The number of nodes of `graph` (a body's conditional nodes count once
// here; their own bodies are separate graphs).
extern "C" int graph_node_count(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph),
                                      nullptr, &n);
  *count = n;
  return err;
}

// The number of nodes captured so far into the graph that `stream` is
// capturing into.
extern "C" int capture_node_count(void* stream, unsigned long long* count) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph,
                                 &deps, &n_deps);
  if (err != cudaSuccess) return err;
  return graph_node_count(graph, count);
}
