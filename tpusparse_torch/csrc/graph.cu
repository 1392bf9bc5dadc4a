// Conditional nodes of a CUDA graph for Hopper (sm_90a): the device-resident CG loop's
// condition, evaluated on the card.
//
// Ports no TPU kernel.  It is the counterpart of the condition of the JAX package's
// lax.while_loop (tpusparse/solvers/cg.py:360-379): k < max_iters and rr > tol2, read
// from device memory, never by the host.  tpusparse_torch/solvers/cg.py (DeviceLoop)
// captures the CG iteration into the body of a WHILE node and guards each further
// iteration of the body with an IF node; cond_kernel, one thread, sets the node's
// condition from the loop's state.  What bounds it: launch latency (it reads three
// words); a solve runs it 1 + U times per U iterations.
//
// The outer graph is PyTorch's (torch.cuda.graph on its capture stream).  A node's body is
// captured on a stream of the port's own (tps_graph_stream_create) that is not capturing:
// tps_graph_cond_begin adds the node behind the work captured so far, makes it the
// capturing stream's only dependency and starts capturing the body graph on the body
// stream (cudaStreamBeginCaptureToGraph); tps_graph_cond_end ends that capture.
// PyTorch's allocator does not see the body's capture, so the body must allocate nothing
// (the caller checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The loop's condition: k < max_iters and rr > tol2 (strict: a zero right-hand side,
// rr = 0 = tol2, runs no step; a NaN stops the loop).  T is the dots' type, f32 or f64.
template <typename T>
__global__ void cond_kernel(cudaGraphConditionalHandle handle, const int64_t* k,
                            int64_t max_iters, const T* rr, const T* tol2) {
  cudaGraphSetConditional(handle, (*k < max_iters && *rr > *tol2) ? 1u : 0u);
}

cudaError_t capture_graph(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                          size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr,
                                             ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

template <typename T>
int cond_set(cudaGraphConditionalHandle handle, const void* k, int64_t max_iters,
             const void* rr, const void* tol2, cudaStream_t s) {
  cond_kernel<T><<<1, 1, 0, s>>>(handle, (const int64_t*)k, max_iters, (const T*)rr,
                                 (const T*)tol2);
  return (int)cudaGetLastError();
}

// kind 0: an IF node, 1: a WHILE node.  Its condition is set by cond_kernel captured on
// `capturing` just before the node; a WHILE body sets it again at its end
// (tps_graph_cond_set_*).
template <typename T>
int cond_begin(int kind, const void* k, int64_t max_iters, const void* rr, const void* tol2,
               void* capturing, void* body, unsigned long long* handle_out) {
  cudaStream_t s = (cudaStream_t)capturing;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_graph(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  int e = cond_set<T>(handle, k, max_iters, rr, tol2, s);
  if (e != 0) return e;
  err = capture_graph(s, &graph, &deps, &ndeps);  // now the condition's kernel
  if (err != cudaSuccess) return (int)err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

}  // namespace

extern "C" {

// Load cond_kernel's module now: under lazy loading a kernel is loaded at its first
// launch, and cond_kernel's first launch is inside a capture.
int tps_graph_preload() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, cond_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncGetAttributes(&attr, cond_kernel<double>);
}

int tps_graph_cond_begin_f32(int kind, const void* k, int64_t max_iters, const void* rr,
                             const void* tol2, void* capturing, void* body,
                             unsigned long long* handle_out) {
  return cond_begin<float>(kind, k, max_iters, rr, tol2, capturing, body, handle_out);
}

int tps_graph_cond_begin_f64(int kind, const void* k, int64_t max_iters, const void* rr,
                             const void* tol2, void* capturing, void* body,
                             unsigned long long* handle_out) {
  return cond_begin<double>(kind, k, max_iters, rr, tol2, capturing, body, handle_out);
}

int tps_graph_cond_set_f32(unsigned long long handle, const void* k, int64_t max_iters,
                           const void* rr, const void* tol2, void* stream) {
  return cond_set<float>((cudaGraphConditionalHandle)handle, k, max_iters, rr, tol2,
                         (cudaStream_t)stream);
}

int tps_graph_cond_set_f64(unsigned long long handle, const void* k, int64_t max_iters,
                           const void* rr, const void* tol2, void* stream) {
  return cond_set<double>((cudaGraphConditionalHandle)handle, k, max_iters, rr, tol2,
                          (cudaStream_t)stream);
}

// A stream of the port's own for capturing bodies: a stream from PyTorch's pool may be the
// one torch.cuda.graph captures on (the pool hands its streams out in turn).
int tps_graph_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err == cudaSuccess) *out = (void*)s;
  return (int)err;
}

int tps_graph_cond_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}

}  // extern "C"
