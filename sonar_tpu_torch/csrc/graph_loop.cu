// A device-side loop around a captured CUDA graph: JAX's lax.while_loop,
// whose exit test runs on the device, as a CUDA graph conditional WHILE node
// (CUDA 12.4 or later).
//
// The loop graph is
//
//   set_while(done) -> WHILE { body (a child graph) -> set_while(done) }
//
// where `body` is a graph captured by PyTorch (one beam-search step) and
// `done` a device bool it writes. set_while sets the loop's condition to
// !*done, so the body runs until it reports done, and not at all when done
// already holds at launch. The host launches the loop once and reads
// nothing back while it runs.
#include <cuda_runtime.h>

__global__ void graph_loop_set_while(cudaGraphConditionalHandle handle, const bool* done) {
  cudaGraphSetConditional(handle, *done ? 0u : 1u);
}

#define GL_CHECK(call)                \
  do {                                \
    const cudaError_t gl_err = (call); \
    if (gl_err != cudaSuccess) {       \
      if (graph) cudaGraphDestroy(graph); \
      return (int)gl_err;              \
    }                                  \
  } while (0)

// Build and instantiate the loop around `body` (a cudaGraph_t, cloned: the
// caller keeps it and the memory its kernels use) -> *exec_out, a
// cudaGraphExec_t for sonar_graph_launch.
extern "C" int sonar_graph_while(void* body, const void* done, void** exec_out) {
  cudaGraph_t graph = nullptr;
  GL_CHECK(cudaGraphCreate(&graph, 0));
  cudaGraphConditionalHandle handle;
  GL_CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault));
  const bool* flag = static_cast<const bool*>(done);
  void* args[2] = {&handle, &flag};
  cudaKernelNodeParams set = {};
  set.func = (void*)graph_loop_set_while;
  set.gridDim = dim3(1);
  set.blockDim = dim3(1);
  set.kernelParams = args;
  cudaGraphNode_t first, loop, step, last;
  GL_CHECK(cudaGraphAddKernelNode(&first, graph, nullptr, 0, &set));
  cudaGraphNodeParams cond = {};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
#if CUDART_VERSION >= 13000
  GL_CHECK(cudaGraphAddNode(&loop, graph, &first, nullptr, 1, &cond));
#else
  GL_CHECK(cudaGraphAddNode(&loop, graph, &first, 1, &cond));
#endif
  cudaGraph_t inner = cond.conditional.phGraph_out[0];
  GL_CHECK(cudaGraphAddChildGraphNode(&step, inner, nullptr, 0, (cudaGraph_t)body));
  GL_CHECK(cudaGraphAddKernelNode(&last, inner, &step, 1, &set));
  cudaGraphExec_t exec;
  GL_CHECK(cudaGraphInstantiate(&exec, graph, 0));
  cudaGraphDestroy(graph);
  *exec_out = (void*)exec;
  return 0;
}

extern "C" int sonar_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int sonar_graph_exec_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
