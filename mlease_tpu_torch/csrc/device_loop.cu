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
// A conditional node's body may hold only kernel, memcpy, memset, empty,
// child-graph and conditional nodes. A branch that holds a collective is
// NCCL's capture, which may leave other nodes (a host node for a proxy, an
// event record); device_loop_build then fails without building and names
// the branch and the node type it found, and device_loop_node_types counts
// a captured graph's node types (child graphs included) for the record.
//
// No counterpart among the TPU kernels: the JAX package runs the same loop
// as one lax.while_loop (mlease_tpu/train/admm.py::run_fused). What bounds
// it on the card is the branches' own work; the loop adds two one-thread
// kernels per branch and pass, and the clock's open stamp one more per
// branch run (its close stamp is the branch's execution count).
//
// The clock (ops/device_loop.py::DeviceClock): one-thread kernels that read
// %globaltimer, the card's nanosecond clock, into a slot of four int64s
// [open, total ns, executions, closed] on the stream they are launched on,
// so each runs once the work queued before it has finished. An open stamp
// writes the time into `open`; a close stamp adds the time since `open` to
// `total`, one to `executions`, and writes the time into `closed`.
// Captured into a branch they are kernel nodes, which a conditional body
// may hold; they read and write nothing but their slot.
//
// Plain C interface, each entry returning a cudaError_t.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_if(cudaGraphConditionalHandle h, const int* phase,
                       int want) {
  cudaGraphSetConditional(h, *phase == want ? 1u : 0u);
}

__global__ void set_while(cudaGraphConditionalHandle h, const int* phase) {
  cudaGraphSetConditional(h, *phase != 0 ? 1u : 0u);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void clock_open(long long* slot) { slot[0] = global_ns(); }

__global__ void clock_close(long long* slot) {
  long long t = global_ns();
  slot[1] += t - slot[0];
  slot[2] += 1;
  slot[3] = t;
}

bool allowed_in_body(cudaGraphNodeType t) {
  return t == cudaGraphNodeTypeKernel || t == cudaGraphNodeTypeMemcpy ||
         t == cudaGraphNodeTypeMemset || t == cudaGraphNodeTypeEmpty ||
         t == cudaGraphNodeTypeGraph || t == cudaGraphNodeTypeConditional;
}

// Visits every node of g and of its child graphs: counts[type] += 1 (when
// counts is set, types past n - 1 in counts[n - 1]) and *bad = the first
// type a conditional body may not hold (when bad is set and still -1).
cudaError_t scan(cudaGraph_t g, int* counts, int n, int* bad) {
  size_t num = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &num);
  if (err != cudaSuccess || num == 0) return err;
  std::vector<cudaGraphNode_t> nodes(num);
  err = cudaGraphGetNodes(g, nodes.data(), &num);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < num; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) return err;
    if (counts) counts[(int)t < n ? (int)t : n - 1] += 1;
    if (bad && *bad < 0 && !allowed_in_body(t)) *bad = (int)t;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = scan(child, counts, n, bad);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
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
// and *exec_out hold the loop (free both with device_loop_destroy). A
// branch holding a node a conditional body may not hold fails the build
// with cudaErrorNotSupported before anything is made: bad[0] is then the
// branch, bad[1] the node type (bad[0] = -1 otherwise).
int device_loop_build(void** branches, const int* wants, int nb,
                      int* phase, void** graph_out, void** exec_out,
                      int* bad) {
  bad[0] = bad[1] = -1;
  for (int k = 0; k < nb; ++k) {
    cudaError_t e = scan((cudaGraph_t)branches[k], nullptr, 0, &bad[1]);
    if (e != cudaSuccess) return e;
    if (bad[1] >= 0) {
      bad[0] = k;
      return cudaErrorNotSupported;
    }
  }
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

// counts[t] += the nodes of type t in graph and its child graphs, for the
// n entries of counts (types past n - 1 counted in counts[n - 1]).
int device_loop_node_types(void* graph, int* counts, int n) {
  return scan((cudaGraph_t)graph, counts, n, nullptr);
}

int device_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// One stamp on `stream`: close = 0 opens the slot, 1 closes it.
int device_clock_stamp(void* slot, int close, void* stream) {
  long long* p = (long long*)slot;
  if (close)
    clock_close<<<1, 1, 0, (cudaStream_t)stream>>>(p);
  else
    clock_open<<<1, 1, 0, (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

// counts[0] += the open stamps and counts[1] += the close stamps on `slot`
// among the kernel nodes of graph and its child graphs. A node whose
// parameters this runtime cannot read (a kernel of another library) is
// not a stamp.
int device_clock_nodes(void* graph, void* slot, int* counts) {
  size_t num = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &num);
  if (err != cudaSuccess || num == 0) return err;
  std::vector<cudaGraphNode_t> nodes(num);
  err = cudaGraphGetNodes((cudaGraph_t)graph, nodes.data(), &num);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < num; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) return err;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = (cudaError_t)device_clock_nodes(
          child, slot, counts);
      if (err != cudaSuccess) return err;
      continue;
    }
    if (t != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(nodes[i], &p) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    int which = p.func == (void*)clock_open    ? 0
                : p.func == (void*)clock_close ? 1
                                               : -1;
    if (which >= 0 && p.kernelParams &&
        *(long long**)p.kernelParams[0] == (long long*)slot)
      counts[which] += 1;
  }
  return cudaSuccess;
}

int device_loop_destroy(void* graph, void* exec) {
  cudaError_t e1 = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
  return e1 != cudaSuccess ? e1 : e2;
}

}  // extern "C"
