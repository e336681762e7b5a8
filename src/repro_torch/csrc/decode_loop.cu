// The decode loop on the device: one CUDA graph whose WHILE node replays a
// captured decode step for as long as the loop is live.
//
// Replaces the host side of the JAX package's decode loops, which run the
// decode stage as one `lax.while_loop` (src/repro/serving/engine.py:
// `_decode_loop_fn`, `_decode_chunk_fn`, `_decode_chunk_paged_fn`): their
// `cond` is "t < t_end and some row can emit", evaluated on the device.
//
// The step itself is captured by PyTorch (torch.cuda.CUDAGraph with
// keep_graph=True); `decode_loop_build` wraps a clone of it, as a child
// graph, in the body of a conditional WHILE node:
//
//   loop_cond -> WHILE { step -> loop_cond }
//
// `loop_cond` is one thread: it reads the loop's counter t, its bound t_end
// and the rows' emission state (lengths, caps, done), sets the node's
// condition with cudaGraphSetConditional, and counts in `iters` the
// iterations it lets run (the host reads that count back to count the
// step's kernel launches).  No iteration runs once every row is dead.
// The work is one launch a segment and a few bytes read per iteration;
// nothing here is bound by bytes or operations.
//
// `graph_kernel_nodes` counts the kernel nodes of a graph (a captured
// step's, read once after its capture): what one iteration launches.
#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void loop_cond(cudaGraphConditionalHandle handle, const int* t,
                          const int* t_end, const long long* lengths,
                          const int* caps, const bool* done, int B,
                          long long* iters) {
  unsigned int live = 0;
  if (*t < *t_end)
    for (int b = 0; b < B; ++b)
      live |= (!done[b] && lengths[b] < caps[b]) ? 1u : 0u;
  *iters += live;
  cudaGraphSetConditional(handle, live);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

// The kernel nodes of graph, child graphs counted through, into *n.
cudaError_t count_kernels(cudaGraph_t graph, long long* n) {
  size_t count = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &count);
  if (e != cudaSuccess || count == 0) return e;
  std::vector<cudaGraphNode_t> nodes(count);
  e = cudaGraphGetNodes(graph, nodes.data(), &count);
  for (size_t i = 0; e == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) break;
    if (type == cudaGraphNodeTypeKernel) {
      ++*n;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = count_kernels(child, n);
    }
  }
  return e;
}

}  // namespace

extern "C" {

// step_graph: a cudaGraph_t (the captured step; cloned, not taken over).
// t, t_end: int32 scalars; lengths (B,) int64; caps (B,) int32; done (B,)
// bool: device pointers whose addresses the step graph also uses; iters:
// an int64 scalar, the count of iterations run.  On success *exec_out
// holds an instantiated cudaGraphExec_t; release it with
// decode_loop_destroy.
int decode_loop_build(void* step_graph, const void* t, const void* t_end,
                      const void* lengths, const void* caps, const void* done,
                      int B, void* iters, void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphExec_t exec = nullptr;
  do {
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) break;
    const int* tp = static_cast<const int*>(t);
    const int* tep = static_cast<const int*>(t_end);
    const long long* lp = static_cast<const long long*>(lengths);
    const int* cp = static_cast<const int*>(caps);
    const bool* dp = static_cast<const bool*>(done);
    long long* ip = static_cast<long long*>(iters);
    void* args[] = {&handle, &tp, &tep, &lp, &cp, &dp, &B, &ip};
    cudaGraphNodeParams cond = {};
    cond.type = cudaGraphNodeTypeKernel;
    cond.kernel.func = (void*)loop_cond;
    cond.kernel.gridDim = dim3(1);
    cond.kernel.blockDim = dim3(1);
    cond.kernel.kernelParams = args;
    cudaGraphNode_t first;
    e = add_node(&first, graph, nullptr, 0, &cond);
    if (e != cudaSuccess) break;
    cudaGraphNodeParams loop = {};
    loop.type = cudaGraphNodeTypeConditional;
    loop.conditional.handle = handle;
    loop.conditional.type = cudaGraphCondTypeWhile;
    loop.conditional.size = 1;
    cudaGraphNode_t node;
    e = add_node(&node, graph, &first, 1, &loop);
    if (e != cudaSuccess) break;
    cudaGraph_t body = loop.conditional.phGraph_out[0];
    cudaGraphNode_t step;
    e = cudaGraphAddChildGraphNode(&step, body, nullptr, 0,
                                   static_cast<cudaGraph_t>(step_graph));
    if (e != cudaSuccess) break;
    cudaGraphNode_t last;
    e = add_node(&last, body, &step, 1, &cond);
    if (e != cudaSuccess) break;
    e = cudaGraphInstantiate(&exec, graph, 0);
  } while (false);
  cudaGraphDestroy(graph);
  if (e != cudaSuccess) return (int)e;
  *exec_out = exec;
  return 0;
}

int decode_loop_launch(void* exec, void* stream) {
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// graph: a cudaGraph_t (not changed); *n_out: its kernel nodes.
int graph_kernel_nodes(void* graph, void* n_out) {
  long long n = 0;
  cudaError_t e = count_kernels(static_cast<cudaGraph_t>(graph), &n);
  if (e != cudaSuccess) return (int)e;
  *static_cast<long long*>(n_out) = n;
  return 0;
}

int decode_loop_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

}  // extern "C"
