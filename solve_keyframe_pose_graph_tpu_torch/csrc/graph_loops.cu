// The LM solve's device-resident loops: CUDA graphs with conditional WHILE
// nodes, composed from the captured pieces of one LM iteration.
//
// Replaces jax.lax.while_loop in the JAX package's compiled solve: the LM
// loop of solve_keyframe_pose_graph_tpu/ops/lm.py lm_solve (the while_loop
// at lm.py:634, its cond at lm.py:477) and the CG loop of ops/pcg.py
// pcg_nodes (the while_loop at pcg.py:104, its cond at pcg.py:72-75). Both
// conds are !done && k < cap on the loop state, and both are tested before
// the first iteration, as lax.while_loop tests them.
//
// ops/graphs.py captures four pieces of a solve as CUDA graphs, each on
// static buffers: init (the loop's first state), pre (one LM iteration up to
// the CG start), cg_iter (one PCG iteration, in place) and post (from the
// switch recovery to the next loop state). kpg_graph_loops_compose builds
// three executables from them: init alone, and
//
//   step  = pre -> set_cond(cg) -> WHILE(cg) { cg_iter -> set_cond(cg) }
//           -> post
//   solve = init -> set_cond(lm) -> WHILE(lm) { step's nodes -> set_cond(lm) }
//
// The pieces go in as child-graph nodes (each a clone of the piece's graph,
// whose memory stays owned by the caller's captures). The step's nodes are
// built into the LM body directly rather than as a child graph holding a
// conditional node. set_cond is a one-thread kernel that reads the loop
// state's `done` flag (bool) and count `k` (int32) and the cap (int32) at
// their static device addresses and sets the WHILE node's condition.
//
// What bounds it: nothing of bytes or operations (one thread reads 9
// bytes); a WHILE iteration costs the card's scheduling of the conditional
// body and one tiny kernel, a few microseconds, against the host round trip
// per LM iteration that it replaces.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// lax.while_loop's cond: !done && k < cap.
__global__ void set_cond(cudaGraphConditionalHandle handle, const bool* done,
                         const int* k, const int* cap) {
  cudaGraphSetConditional(handle, (!*done && *k < *cap) ? 1u : 0u);
}

struct Cond {
  const bool* done;
  const int* k;
  const int* cap;
};

struct Pieces {
  cudaGraph_t init, pre, cg_iter, post;
};

// Destroys a graph that was only needed until its instantiation.
struct OwnedGraph {
  cudaGraph_t g = nullptr;
  ~OwnedGraph() {
    if (g) cudaGraphDestroy(g);
  }
};

#define KPG_CHECK(x)                          \
  do {                                        \
    const cudaError_t e_ = (x);               \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

// The dependency list of a node that follows `dep` (none if null).
inline size_t deps(const cudaGraphNode_t* dep) { return dep ? 1 : 0; }

cudaError_t add_child(cudaGraph_t g, cudaGraphNode_t* node,
                      const cudaGraphNode_t* dep, cudaGraph_t child) {
  return cudaGraphAddChildGraphNode(node, g, dep, deps(dep), child);
}

cudaError_t add_set_cond(cudaGraph_t g, cudaGraphNode_t* node,
                         const cudaGraphNode_t* dep,
                         cudaGraphConditionalHandle handle, const Cond& c) {
  cudaGraphConditionalHandle h = handle;
  const bool* done = c.done;
  const int* k = c.k;
  const int* cap = c.cap;
  void* args[] = {&h, &done, &k, &cap};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_cond);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, dep, deps(dep), &p);
}

// A WHILE node on `handle` after `dep`; *body is its body graph, owned by
// the node.
cudaError_t add_while(cudaGraph_t g, cudaGraphNode_t* node,
                      const cudaGraphNode_t* dep,
                      cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  KPG_CHECK(cudaGraphAddNode(node, g, dep, deps(dep), &p));
  *body = p.conditional.phGraph_out[0];
  return cudaSuccess;
}

// pre -> set_cond(cg) -> WHILE(cg) { cg_iter -> set_cond(cg) } -> post,
// appended to g after `dep`; *last is post's node.
cudaError_t add_step(cudaGraph_t g, const cudaGraphNode_t* dep,
                     const Pieces& pieces, const Cond& cg,
                     cudaGraphNode_t* last) {
  cudaGraphConditionalHandle h;
  KPG_CHECK(cudaGraphConditionalHandleCreate(&h, g, 0, 0));
  cudaGraphNode_t pre, set, loop, iter, again;
  cudaGraph_t body;
  KPG_CHECK(add_child(g, &pre, dep, pieces.pre));
  KPG_CHECK(add_set_cond(g, &set, &pre, h, cg));
  KPG_CHECK(add_while(g, &loop, &set, h, &body));
  KPG_CHECK(add_child(body, &iter, nullptr, pieces.cg_iter));
  KPG_CHECK(add_set_cond(body, &again, &iter, h, cg));
  return add_child(g, last, &loop, pieces.post);
}

// execs[0..2]: init, step, solve (see the note at the top).
cudaError_t compose(const Pieces& pieces, const Cond& cg, const Cond& lm,
                    cudaGraphExec_t* execs) {
  OwnedGraph init, step, solve;
  cudaGraphNode_t node, last;
  KPG_CHECK(cudaGraphCreate(&init.g, 0));
  KPG_CHECK(add_child(init.g, &node, nullptr, pieces.init));

  KPG_CHECK(cudaGraphCreate(&step.g, 0));
  KPG_CHECK(add_step(step.g, nullptr, pieces, cg, &last));

  KPG_CHECK(cudaGraphCreate(&solve.g, 0));
  cudaGraphConditionalHandle h;
  KPG_CHECK(cudaGraphConditionalHandleCreate(&h, solve.g, 0, 0));
  cudaGraphNode_t first, set, loop, again;
  cudaGraph_t body;
  KPG_CHECK(add_child(solve.g, &first, nullptr, pieces.init));
  KPG_CHECK(add_set_cond(solve.g, &set, &first, h, lm));
  KPG_CHECK(add_while(solve.g, &loop, &set, h, &body));
  KPG_CHECK(add_step(body, nullptr, pieces, cg, &last));
  KPG_CHECK(add_set_cond(body, &again, &last, h, lm));

  const cudaGraph_t graphs[3] = {init.g, step.g, solve.g};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = cudaGraphInstantiate(&execs[i], graphs[i], 0);
    if (e != cudaSuccess) {
      for (int j = 0; j < i; ++j) {
        cudaGraphExecDestroy(execs[j]);
        execs[j] = nullptr;
      }
      return e;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Plain C entry points for ctypes; every one returns a cudaError_t code
// (0 = success).
//
// kpg_graph_loops_compose: init, pre, cg_iter, post are the pieces'
// cudaGraph_t (cloned here, not kept); cg_* and lm_* the device addresses
// of the CG and LM loop states' done (bool), k (int32) and cap (int32),
// which must stay valid while the executables live. Writes the
// instantiated init, step and solve executables (on the current device)
// into execs_out[0..2], or nulls on failure.
extern "C" int kpg_graph_loops_compose(
    void* init, void* pre, void* cg_iter, void* post, const bool* cg_done,
    const int* cg_k, const int* cg_cap, const bool* lm_done, const int* lm_k,
    const int* lm_cap, void** execs_out) {
  const Pieces pieces{static_cast<cudaGraph_t>(init),
                      static_cast<cudaGraph_t>(pre),
                      static_cast<cudaGraph_t>(cg_iter),
                      static_cast<cudaGraph_t>(post)};
  cudaGraphExec_t execs[3] = {nullptr, nullptr, nullptr};
  const cudaError_t e = compose(pieces, Cond{cg_done, cg_k, cg_cap},
                                Cond{lm_done, lm_k, lm_cap}, execs);
  for (int i = 0; i < 3; ++i) execs_out[i] = execs[i];
  return static_cast<int>(e);
}

// One launch of a composed executable on `stream`, asynchronous.
extern "C" int kpg_graph_loops_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int kpg_graph_loops_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

// The CUDA runtime this library was built with and the driver's version.
extern "C" int kpg_graph_loops_versions(int* runtime, int* driver) {
  KPG_CHECK(cudaRuntimeGetVersion(runtime));
  return static_cast<int>(cudaDriverGetVersion(driver));
}

extern "C" const char* kpg_graph_loops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
