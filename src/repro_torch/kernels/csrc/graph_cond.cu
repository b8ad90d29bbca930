// IF nodes of a CUDA graph, emitted into a stream capture.
//
// The fused serve program and the fused load program (repro_torch.core.
// graphloop) capture one protocol round as a CUDA graph and replay it.
// The round's control flow -- whether the loop still runs, whether the
// engine phase or the idle phase runs, whether a round prefills, how many
// prompt positions it feeds -- is decided on the device, from device
// tensors, by conditional nodes: the reference expresses the same flow
// as lax.while_loop / lax.cond / fori_loop inside one XLA program.
//
// graph_if_begin, called while `stream` is being captured:
//   1. launches set_condition_kernel on `stream` (captured as a kernel
//      node): it reads the one-byte predicate at `pred` when the graph
//      runs and sets the conditional handle from it;
//   2. adds an IF node after it to the graph being captured, and makes
//      it the stream's only capture dependency;
//   3. starts capturing `body_stream` into the IF node's body graph.
// Everything launched on `body_stream` until graph_if_end runs, when the
// graph is replayed, only if the predicate held at that point.
// graph_if_end ends the body capture and counts the body's own nodes
// (a nested IF node counts as one).  Both return a cudaError_t (0 on
// success; cudaErrorStreamCaptureUnsupported when `stream` is not being
// captured).
//
// No TPU kernel corresponds: this is the control flow XLA keeps inside a
// program.  The bound of set_condition_kernel is one byte read.

#include <cuda_runtime.h>

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int graph_if_begin(void* stream_ptr, const void* pred,
                              void* body_stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStream_t body_stream = static_cast<cudaStream_t>(body_stream_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnsupported;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_condition_kernel<<<1, 1, 0, stream>>>(
      handle, static_cast<const unsigned char*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the set kernel is now the capture's frontier: the IF node follows it
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                               &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body_stream,
                                       params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_end(void* body_stream_ptr, size_t* n_nodes) {
  cudaGraph_t body;
  cudaError_t e = cudaStreamEndCapture(
      static_cast<cudaStream_t>(body_stream_ptr), &body);
  if (e != cudaSuccess) return e;
  return cudaGraphGetNodes(body, nullptr, n_nodes);
}

// A stream of its own for each nesting depth of IF bodies, so no other
// code shares the streams the bodies are captured on.
extern "C" int graph_body_stream(void** out) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(out),
                                   cudaStreamNonBlocking);
}
