// Host functions of `utils.profiling`'s region map of a captured CUDA graph
// (no kernel): the capture's frontier while a stream captures, then the
// graph's nodes in their order of execution and each kernel node's name.
#include <cuda.h>
#include <cxxabi.h>
#include <dlfcn.h>

#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

// The nodes that the next operation captured on `stream` will depend on:
// up to `cap` handles into `out`.  Returns their count, -1 where the stream
// is not capturing, or -2 on an error of the query.
extern "C" int mmvae_capture_frontier(void* stream, unsigned long long* out, int cap) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* edges = nullptr;  // asked for: a programmatic edge has data
  size_t n = 0;
#if CUDART_VERSION >= 13000
  const cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr,
                                                   nullptr, &deps, &edges, &n);
#else
  const cudaError_t err = cudaStreamGetCaptureInfo_v3((cudaStream_t)stream, &status, nullptr,
                                                      nullptr, &deps, &edges, &n);
#endif
  if (err != cudaSuccess) return -2;
  if (status != cudaStreamCaptureStatusActive) return -1;
  for (size_t i = 0; i < n && (int)i < cap; ++i) out[i] = (unsigned long long)deps[i];
  return (int)n;
}

// The nodes of `graph`: up to `cap` handles into `nodes` and their
// cudaGraphNodeType into `kinds`.  Where the graph is one path (one root,
// every node at most one dependency and one dependent) `*chain` is 1 and
// the nodes come in the path's order, the order they run in; else `*chain`
// is 0 and they come in cudaGraphGetNodes' order.  Returns the node count,
// or -(CUDA error) on an error.
extern "C" int mmvae_graph_nodes(void* graph, unsigned long long* nodes, int* kinds, int* chain,
                                 int cap) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0, m = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return -(int)err;
  std::vector<cudaGraphNode_t> all(n);
  if (n && (err = cudaGraphGetNodes(g, all.data(), &n)) != cudaSuccess) return -(int)err;
  // with the edges' data: a programmatic (early-launch) edge has some, and
  // a query without it fails
#if CUDART_VERSION >= 13000
  err = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &m);
#else
  err = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &m);
#endif
  if (err != cudaSuccess) return -(int)err;
  std::vector<cudaGraphNode_t> from(m), to(m);
  std::vector<cudaGraphEdgeData> data(m);
#if CUDART_VERSION >= 13000
  if (m && (err = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &m)) != cudaSuccess)
    return -(int)err;
#else
  if (m && (err = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &m)) !=
               cudaSuccess)
    return -(int)err;
#endif
  std::unordered_map<cudaGraphNode_t, size_t> index;
  for (size_t i = 0; i < n; ++i) index[all[i]] = i;
  std::vector<int> in(n, 0), out(n, 0);
  std::vector<size_t> next(n, n);
  for (size_t e = 0; e < m; ++e) {
    const size_t a = index[from[e]], b = index[to[e]];
    next[a] = b;
    ++out[a];
    ++in[b];
  }
  size_t roots = 0, root = n;
  int one = 1;
  for (size_t i = 0; i < n; ++i) {
    if (in[i] == 0) ++roots, root = i;
    one &= in[i] <= 1 && out[i] <= 1;
  }
  *chain = one && roots == 1;
  for (size_t k = 0, i = *chain ? root : 0; k < n && (int)k < cap; ++k) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(all[i], &type)) != cudaSuccess) return -(int)err;
    nodes[k] = (unsigned long long)all[i];
    kinds[k] = (int)type;
    i = *chain ? next[i] : k + 1;
  }
  return (int)n;
}

namespace {

// A function of libcuda by name, from the copy the process has loaded.
void* libcuda_fn(const char* name) {
  static void* lib = dlopen("libcuda.so.1", RTLD_NOW);
  return lib ? dlsym(lib, name) : nullptr;
}

const char* kernel_node_function_name(cudaGraphNode_t node) {
  const char* name = nullptr;
#if CUDART_VERSION >= 12030
  cudaKernelNodeParams p{};
  if (cudaGraphKernelNodeGetParams(node, &p) == cudaSuccess && p.func &&
      cudaFuncGetName(&name, p.func) == cudaSuccess && name)
    return name;
  cudaGetLastError();
#endif
  // a kernel launched through libcuda's API (a library's, Triton's)
  using GetParams = CUresult (*)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
  using FuncName = CUresult (*)(const char**, CUfunction);
  using KernelName = CUresult (*)(const char**, CUkernel);
  auto get = (GetParams)libcuda_fn("cuGraphKernelNodeGetParams_v2");
  auto func_name = (FuncName)libcuda_fn("cuFuncGetName");
  auto kernel_name = (KernelName)libcuda_fn("cuKernelGetName");
  CUDA_KERNEL_NODE_PARAMS_v2 q{};
  if (!get || get((CUgraphNode)node, &q) != CUDA_SUCCESS) return nullptr;
  if (q.func && func_name && func_name(&name, q.func) == CUDA_SUCCESS && name) return name;
  if (q.kern && kernel_name && kernel_name(&name, q.kern) == CUDA_SUCCESS && name) return name;
  return nullptr;
}

}  // namespace

// The demangled name of the kernel node `node`'s function into `buf` (cut
// to `cap` - 1 bytes).  Returns its length, or -1 where it has none.
extern "C" int mmvae_graph_kernel_name(unsigned long long node, char* buf, int cap) {
  const char* name = kernel_node_function_name((cudaGraphNode_t)node);
  if (!name || cap <= 0) return -1;
  int status = 1;
  char* plain = strncmp(name, "_Z", 2) == 0 ? abi::__cxa_demangle(name, nullptr, nullptr, &status)
                                            : nullptr;
  const char* text = status == 0 && plain ? plain : name;
  const int len = (int)strlen(text);
  strncpy(buf, text, cap - 1);
  buf[cap - 1] = '\0';
  std::free(plain);
  return len;
}
