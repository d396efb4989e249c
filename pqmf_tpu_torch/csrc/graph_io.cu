// The host side of a CUDA graph's replay (pqmf_tpu_torch/graphs.py).  Plain
// C interface, built with nvcc and loaded with ctypes with the kernels
// (pqmf_tpu_torch/kernels/_build.py); no device code.
//
// A program's graph is captured with its own input and output copies: each
// tensor argument copied into a buffer of the graph, the body, each tensor
// output copied out of it.  PyTorch records each such dense copy as a 1-D
// memcpy node.  A replay re-points those nodes at the call's tensors (an
// argument's node reads the caller's tensor, an output's node writes a
// fresh one) and launches the graph: one call from Python, no operator
// dispatched.  A change to an instantiated graph's node affects only later
// launches, so a replay queued behind another never changes what the
// earlier one copies.

#include <cuda_runtime.h>

#include <vector>

extern "C" {

// One graph's replay, mirrored field for field by graphs._Plan: the
// instantiated graph, its n re-pointed copy nodes with each one's kind and
// bytes, the (source, destination) pairs the next launch copies (2n
// pointers) and the pairs the instantiated graph holds now.
struct pqmf_graph_plan {
  cudaGraphExec_t exec;
  int n;
  cudaGraphNode_t* nodes;
  int* kinds;
  size_t* bytes;
  void** next;
  void** held;
};

// The 1-D memcpy nodes of `graph` (no array, one row): the first `cap` of
// them into nodes / kinds / src / dst / bytes, and how many there are into
// *count.  Returns a cudaError_t.
int pqmf_graph_copies(cudaGraph_t graph, int cap, cudaGraphNode_t* nodes,
                      int* kinds, void** src, void** dst, size_t* bytes,
                      int* count) {
  *count = 0;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> all(n);
  err = cudaGraphGetNodes(graph, all.data(), &n);
  if (err != cudaSuccess) return err;
  int k = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(all[i], &type);
    if (err != cudaSuccess) return err;
    if (type != cudaGraphNodeTypeMemcpy) continue;
    cudaMemcpy3DParms p = {};
    err = cudaGraphMemcpyNodeGetParams(all[i], &p);
    if (err != cudaSuccess) return err;
    if (p.srcArray || p.dstArray || p.extent.height != 1 ||
        p.extent.depth != 1 || p.srcPos.y || p.srcPos.z || p.dstPos.y ||
        p.dstPos.z)
      continue;
    if (k < cap) {
      nodes[k] = all[i];
      kinds[k] = (int)p.kind;
      src[k] = (char*)p.srcPtr.ptr + p.srcPos.x;
      dst[k] = (char*)p.dstPtr.ptr + p.dstPos.x;
      bytes[k] = p.extent.width;
    }
    ++k;
  }
  *count = k;
  return cudaSuccess;
}

// One replay: every node whose next pair differs from the one it holds is
// re-pointed, then the graph is launched on `stream`.  Returns a
// cudaError_t, the first that failed.
int pqmf_graph_replay(pqmf_graph_plan* p, cudaStream_t stream) {
  for (int i = 0; i < p->n; ++i) {
    void* src = p->next[2 * i];
    void* dst = p->next[2 * i + 1];
    if (src == p->held[2 * i] && dst == p->held[2 * i + 1]) continue;
    cudaError_t err = cudaGraphExecMemcpyNodeSetParams1D(
        p->exec, p->nodes[i], dst, src, p->bytes[i],
        (cudaMemcpyKind)p->kinds[i]);
    if (err != cudaSuccess) return err;
    p->held[2 * i] = src;
    p->held[2 * i + 1] = dst;
  }
  return cudaGraphLaunch(p->exec, stream);
}

}  // extern "C"
