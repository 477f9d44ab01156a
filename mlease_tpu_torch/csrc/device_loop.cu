// The device loop of AdmmTrainer.run_fused: a CUDA graph that loops on the
// card until a phase word says stop, with no host in the loop.
//
//   while (*phase != 0) {
//     for each branch k, in order:  if (*phase == want[k]) branch_k();
//   }
//
// Each branch is a graph captured by torch (torch.cuda.CUDAGraph with
// keep_graph=True, its raw cudaGraph_t): one CG trip, the Newton epilogue,
// the end of an ADMM iteration, the next x-update's start, the CG start.
// Every branch ends by writing the next phase, so one pass of the body can
// run several branches, in the order given. The branches are copied into
// the loop as child graphs of conditional IF nodes, inside one conditional
// WHILE node; one tiny kernel before each IF node sets its condition from
// the phase word, one at the end of the body sets the WHILE's. Conditional
// nodes need CUDA 12.4 or later (12.3 for IF/WHILE with their handles set
// from a kernel).
//
// No counterpart among the TPU kernels: the JAX package runs the same loop
// as one lax.while_loop (mlease_tpu/train/admm.py::run_fused). What bounds
// it on the card is the branches' own work; the loop adds two one-thread
// kernels per branch and pass.
//
// Plain C interface, each entry returning a cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle h, const int* phase,
                       int want) {
  cudaGraphSetConditional(h, *phase == want ? 1u : 0u);
}

__global__ void set_while(cudaGraphConditionalHandle h, const int* phase) {
  cudaGraphSetConditional(h, *phase != 0 ? 1u : 0u);
}

cudaError_t add_setter(cudaGraph_t g, cudaGraphNode_t* prev, void* fn,
                       void** args) {
  cudaKernelNodeParams kp = {};
  kp.func = fn;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(&node, g, *prev ? prev : nullptr,
                                           *prev ? 1 : 0, &kp);
  if (err == cudaSuccess) *prev = node;
  return err;
}

}  // namespace

extern "C" {

// branches: nb raw cudaGraph_t handles; wants: the phase value that runs
// each; phase: the device int32 the branches write. On success *graph_out
// and *exec_out hold the loop (free both with device_loop_destroy).
int device_loop_build(void** branches, const int* wants, int nb,
                      int* phase, void** graph_out, void** exec_out) {
  cudaGraph_t top = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = cudaGraphCreate(&top, 0);
  if (err != cudaSuccess) return err;
#define CHECK(x)                      \
  do {                                \
    err = (x);                        \
    if (err != cudaSuccess) goto out; \
  } while (0)
  {
    cudaGraphConditionalHandle hw;
    // default 1: the body runs at least once a launch and then reads the
    // phase word itself (the handle is reset to 1 at every launch)
    CHECK(cudaGraphConditionalHandleCreate(&hw, top, 1,
                                           cudaGraphCondAssignDefault));
    cudaGraphNodeParams wp = {};
    wp.type = cudaGraphNodeTypeConditional;
    wp.conditional.handle = hw;
    wp.conditional.type = cudaGraphCondTypeWhile;
    wp.conditional.size = 1;
    cudaGraphNode_t wnode;
    CHECK(cudaGraphAddNode(&wnode, top, nullptr, 0, &wp));
    cudaGraph_t body = wp.conditional.phGraph_out[0];
    cudaGraphNode_t prev = nullptr;
    for (int k = 0; k < nb; ++k) {
      cudaGraphConditionalHandle h;
      CHECK(cudaGraphConditionalHandleCreate(&h, body, 0, 0));
      int want = wants[k];
      void* args[] = {&h, &phase, &want};
      CHECK(add_setter(body, &prev, (void*)set_if, args));
      cudaGraphNodeParams ip = {};
      ip.type = cudaGraphNodeTypeConditional;
      ip.conditional.handle = h;
      ip.conditional.type = cudaGraphCondTypeIf;
      ip.conditional.size = 1;
      cudaGraphNode_t inode;
      CHECK(cudaGraphAddNode(&inode, body, &prev, 1, &ip));
      cudaGraphNode_t child;
      CHECK(cudaGraphAddChildGraphNode(&child, ip.conditional.phGraph_out[0],
                                       nullptr, 0, (cudaGraph_t)branches[k]));
      prev = inode;
    }
    void* wargs[] = {&hw, &phase};
    CHECK(add_setter(body, &prev, (void*)set_while, wargs));
    CHECK(cudaGraphInstantiate(&exec, top, 0));
  }
#undef CHECK
out:
  if (err != cudaSuccess) {
    if (exec) cudaGraphExecDestroy(exec);
    cudaGraphDestroy(top);
    return err;
  }
  *graph_out = top;
  *exec_out = exec;
  return cudaSuccess;
}

int device_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int device_loop_destroy(void* graph, void* exec) {
  cudaError_t e1 = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
  return e1 != cudaSuccess ? e1 : e2;
}

}  // extern "C"
