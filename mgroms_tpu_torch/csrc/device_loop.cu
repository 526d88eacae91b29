// The outer convergence loop on the card (solver.solve_p with device_loop):
// the loop's condition kernel, the CUDA graph that runs the whole loop as
// one WHILE node, and a census of the kernel nodes of a graph.
//
// Replaces what the JAX package leaves to XLA inside lax.while_loop
// (mgroms_tpu/solver.py:731-742, _solve_device_loop's cond and the end of
// its body): res = ||r|| / ||b||, i += cycles_per_check, hist[i] = res, and
// the test i < maxiter && res > tol.  No Pallas kernel computes it; it is
// a kernel of glue, as K3's residual mode is.
//
// loop_condition_kernel reads ||r||^2 (the step's norm_sq) and ||b||, forms
// the relative residual as the host loop does (solver.solve_p: the square
// root in the state's type, the division in double; in its first mode, the
// prologue's, the division in the state's type, as solve_init's res0), so
// that the history equals the host loop's to every digit, writes it into
// the history, counts its own runs in `runs` (what the device ran, read
// back with the history), and sets the WHILE node's condition with
// cudaGraphSetConditional (a NaN residual ends the loop).  Outside a graph
// (in_graph 0) it only writes the decision to `cont` (the eager loop and
// the checks against the plain version).
//
// Bound on this card: latency.  One thread does one dependent global round
// trip (the two norms, the counters and the limits read, then the stores):
// a launch and one memory latency, nothing of bandwidth or arithmetic.
//
// The device loop's graph is
//     init condition kernel -> WHILE(handle) { step -> condition kernel }
// mg_loop_graph_open builds the root (the prologue's condition kernel and
// the WHILE node) and hands back the empty body; mg_loop_body_clone fills
// it with a clone of the captured step (a child graph node: its buffers
// stay in the step's memory pool) and the condition kernel, and
// mg_graph_instantiate instantiates the root.  Conditional nodes need
// CUDA 12.4 or newer.  The other way to fill the body, capturing the step
// and the condition straight into it (mg_capture_begin:
// cudaStreamBeginCaptureToGraph, with mg_loop_condition_node), is kept for
// scripts/loop_graph_build.py, which times both builds: on an H100 with
// CUDA 12.8 the instantiation of a WHILE body grows with the square of its
// node count whichever way it was filled.
//
// mg_graph_kernels lists the kernel nodes of a graph (child graphs
// included) by function name, demangled, with their counts: what a launch
// of the graph runs, for the launch counters.
//
// Plain C interface (loaded with ctypes): each entry returns a CUDA error
// code, 0 on success.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cxxabi.h>

#include <chrono>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

template <typename T>
__global__ void loop_condition_kernel(const T* rsq, const T* bnorm, int* it,
                                      double* hist, const double* lim,
                                      int cpc, int init, int* cont,
                                      int* runs,
                                      cudaGraphConditionalHandle handle,
                                      int in_graph) {
    const T s = sqrt(rsq[0]);
    const int maxiter = (int)lim[0];
    const double tol = lim[1];
    int i;
    double res;
    if (init) {
        i = 0;
        res = (double)(s / bnorm[0]);
    } else {
        i = *it + cpc;
        res = (double)s / (double)bnorm[0];
    }
    *it = i;
    hist[i] = res;
    *runs += 1;
    // false for a NaN res: the loop ends
    const unsigned int go = (i < maxiter && res > tol) ? 1u : 0u;
    *cont = (int)go;
    if (in_graph) cudaGraphSetConditional(handle, go);
}

template <typename T>
int launch_condition(const void* rsq, const void* bnorm, int* it,
                     double* hist, const double* lim, int cpc, int init,
                     int* cont, int* runs,
                     cudaGraphConditionalHandle handle, int in_graph,
                     void* stream) {
    loop_condition_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(rsq), static_cast<const T*>(bnorm), it, hist,
        lim, cpc, init, cont, runs, handle, in_graph);
    return (int)cudaGetLastError();
}

// The driver's graph queries (through the runtime's entry-point table:
// the library links no libcuda).
typedef CUresult (*GetNodesFn)(CUgraph, CUgraphNode*, size_t*);
typedef CUresult (*NodeTypeFn)(CUgraphNode, CUgraphNodeType*);
typedef CUresult (*ChildGraphFn)(CUgraphNode, CUgraph*);
typedef CUresult (*NodeParamsFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
typedef CUresult (*FuncNameFn)(const char**, CUfunction);
typedef CUresult (*KernelNameFn)(const char**, CUkernel);

template <typename F>
F driver_entry(const char* sym) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint(sym, &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
        cudaGetLastError();
        return nullptr;
    }
    return reinterpret_cast<F>(fn);
}

// Error codes of the census: the stage that failed x 1000 + its CUresult
// (1 a query missing from the driver, 2 listing nodes, 3 a node's type,
// 4 a child graph).
struct Census {
    GetNodesFn get_nodes = driver_entry<GetNodesFn>("cuGraphGetNodes");
    NodeTypeFn node_type = driver_entry<NodeTypeFn>("cuGraphNodeGetType");
    ChildGraphFn child_graph =
        driver_entry<ChildGraphFn>("cuGraphChildGraphNodeGetGraph");
    NodeParamsFn params = driver_entry<NodeParamsFn>(
        "cuGraphKernelNodeGetParams");
    FuncNameFn func_name = driver_entry<FuncNameFn>("cuFuncGetName");
    KernelNameFn kernel_name = driver_entry<KernelNameFn>("cuKernelGetName");
    std::map<const void*, std::string> names;   // by function handle
    std::map<std::string, long> counts;

    std::string name_of(CUgraphNode node) {
        CUDA_KERNEL_NODE_PARAMS_v2 kp;
        std::memset(&kp, 0, sizeof(kp));
        if (!params || params(node, &kp) != CUDA_SUCCESS)
            return "?params";
        const void* key = kp.func ? static_cast<const void*>(kp.func)
                                  : static_cast<const void*>(kp.kern);
        auto hit = names.find(key);
        if (hit != names.end()) return hit->second;
        const char* raw = nullptr;
        if (kp.func && func_name) func_name(&raw, kp.func);
        if (!raw && kp.kern && kernel_name) kernel_name(&raw, kp.kern);
        std::string name = raw ? raw : "?name";
        if (raw) {
            int status = 0;
            char* d = abi::__cxa_demangle(raw, nullptr, nullptr, &status);
            if (d && status == 0) name = d;
            std::free(d);
        }
        names[key] = name;
        return name;
    }

    int walk(CUgraph g) {
        if (!get_nodes || !node_type || !child_graph) return 1000;
        size_t n = 0;
        CUresult e = get_nodes(g, nullptr, &n);
        if (e != CUDA_SUCCESS) return 2000 + (int)e;
        std::vector<CUgraphNode> nodes(n);
        if (n) e = get_nodes(g, nodes.data(), &n);
        if (e != CUDA_SUCCESS) return 2000 + (int)e;
        for (CUgraphNode node : nodes) {
            CUgraphNodeType t;
            e = node_type(node, &t);
            if (e != CUDA_SUCCESS) return 3000 + (int)e;
            if (t == CU_GRAPH_NODE_TYPE_KERNEL) {
                counts[name_of(node)] += 1;
            } else if (t == CU_GRAPH_NODE_TYPE_GRAPH) {
                CUgraph child = nullptr;
                e = child_graph(node, &child);
                if (e != CUDA_SUCCESS) return 4000 + (int)e;
                counts["#child graph"] += 1;
                const int w = walk(child);
                if (w != 0) return w;
            } else {
                counts["#node type " + std::to_string((int)t)] += 1;
            }
        }
        return 0;
    }
};

}  // namespace

extern "C" {

int mg_loop_condition_f32(const void* rsq, const void* bnorm, int* it,
                          double* hist, const double* lim, int cpc,
                          int init, int* cont, int* runs, void* stream) {
    return launch_condition<float>(rsq, bnorm, it, hist, lim, cpc, init,
                                   cont, runs, 0, 0, stream);
}

int mg_loop_condition_f64(const void* rsq, const void* bnorm, int* it,
                          double* hist, const double* lim, int cpc,
                          int init, int* cont, int* runs, void* stream) {
    return launch_condition<double>(rsq, bnorm, it, hist, lim, cpc, init,
                                    cont, runs, 0, 0, stream);
}

// The condition kernel in the loop's mode (not the prologue's) setting
// `handle`: launched on a stream that captures into the WHILE body
// (scripts/loop_graph_build.py).
int mg_loop_condition_node(int f64, const void* rsq, const void* bnorm,
                           int* it, double* hist, const double* lim, int cpc,
                           int* cont, int* runs,
                           unsigned long long handle, void* stream) {
    return f64 ? launch_condition<double>(rsq, bnorm, it, hist, lim, cpc, 0,
                                          cont, runs, handle, 1, stream)
               : launch_condition<float>(rsq, bnorm, it, hist, lim, cpc, 0,
                                         cont, runs, handle, 1, stream);
}

// The device loop's root graph: the prologue's condition kernel (it sets
// the WHILE node's condition at every launch of the graph), then the
// WHILE node.  *graph_out is the root, *body_out the node's empty body,
// *handle_out its condition.
int mg_loop_graph_open(int f64, const void* rsq, const void* bnorm, int* it,
                       double* hist, const double* lim, int cpc, int* cont,
                       int* runs, void** graph_out, void** body_out,
                       unsigned long long* handle_out) {
    const void* func =
        f64 ? reinterpret_cast<const void*>(&loop_condition_kernel<double>)
            : reinterpret_cast<const void*>(&loop_condition_kernel<float>);
    cudaGraph_t g = nullptr;
    cudaError_t e = cudaGraphCreate(&g, 0);
    if (e != cudaSuccess) return (int)e;
    cudaGraphConditionalHandle handle = 0;
    cudaGraphNode_t init_node, loop_node;
    int init = 1, in_graph = 1;
    void* params[] = {&rsq, &bnorm, &it, &hist, &lim, &cpc, &init,
                      &cont, &runs, &handle, &in_graph};
    cudaKernelNodeParams kp = {};
    cudaGraphNodeParams cp = {};
    e = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
    if (e != cudaSuccess) goto fail;
    kp.func = const_cast<void*>(func);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = params;
    e = cudaGraphAddKernelNode(&init_node, g, nullptr, 0, &kp);
    if (e != cudaSuccess) goto fail;
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    e = cudaGraphAddNode(&loop_node, g, &init_node, 1, &cp);
    if (e != cudaSuccess) goto fail;
    *graph_out = g;
    *body_out = cp.conditional.phGraph_out[0];
    *handle_out = handle;
    return 0;
fail:
    cudaGraphDestroy(g);
    return (int)e;
}

// Fills the WHILE node's `body`: `step` (a captured graph, not modified)
// cloned into it as a child graph node, the condition kernel after it.
// *seconds is the wall time of the clone.
int mg_loop_body_clone(void* body, void* step, int f64, const void* rsq,
                       const void* bnorm, int* it, double* hist,
                       const double* lim, int cpc, int* cont, int* runs,
                       unsigned long long handle, double* seconds) {
    const void* func =
        f64 ? reinterpret_cast<const void*>(&loop_condition_kernel<double>)
            : reinterpret_cast<const void*>(&loop_condition_kernel<float>);
    cudaGraph_t b = static_cast<cudaGraph_t>(body);
    cudaGraphNode_t child, cond;
    const auto t0 = std::chrono::steady_clock::now();
    cudaError_t e = cudaGraphAddChildGraphNode(
        &child, b, nullptr, 0, static_cast<cudaGraph_t>(step));
    *seconds = std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0).count();
    if (e != cudaSuccess) return (int)e;
    int init = 0, in_graph = 1;
    cudaGraphConditionalHandle h = handle;
    void* params[] = {&rsq, &bnorm, &it, &hist, &lim, &cpc, &init,
                      &cont, &runs, &h, &in_graph};
    cudaKernelNodeParams kp = {};
    kp.func = const_cast<void*>(func);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = params;
    return (int)cudaGraphAddKernelNode(&cond, b, &child, 1, &kp);
}

// Captures the work enqueued on `stream` from now on into `graph` (the
// WHILE body), in global capture mode, until mg_capture_end
// (scripts/loop_graph_build.py).
int mg_capture_begin(void* stream, void* graph) {
    return (int)cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph),
        nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
}

int mg_capture_end(void* stream) {
    cudaGraph_t g = nullptr;
    return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &g);
}

// Instantiates `graph` into *exec_out; *seconds is the call's wall time.
int mg_graph_instantiate(void* graph, void** exec_out, double* seconds) {
    cudaGraphExec_t exec = nullptr;
    const auto t0 = std::chrono::steady_clock::now();
    const cudaError_t e =
        cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
    *seconds = std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0).count();
    if (e != cudaSuccess) return (int)e;
    *exec_out = exec;
    return 0;
}

int mg_graph_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                static_cast<cudaStream_t>(stream));
}

int mg_graph_destroy(void* graph, void* exec) {
    cudaError_t e = cudaSuccess;
    if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
    if (graph) {
        const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
        if (e == cudaSuccess) e = e2;
    }
    return (int)e;
}

// The nodes of `graph` (child graphs walked, not a conditional node's
// body) as "count<TAB>name" lines into out[cap]: a kernel node by its
// function's demangled name, another node as "#node type N" (the
// CUgraphNodeType) or "#child graph".  *len is the text's length; -1
// (nothing written) where it does not fit in cap bytes; else 0, or the
// census's error code (Census).
int mg_graph_kernels(void* graph, char* out, size_t cap, size_t* len) {
    Census c;
    const int e = c.walk(static_cast<CUgraph>(graph));
    if (e != 0) return e;
    std::string text;
    for (const auto& kv : c.counts)
        text += std::to_string(kv.second) + "\t" + kv.first + "\n";
    *len = text.size();
    if (text.size() + 1 > cap) return -1;
    std::memcpy(out, text.c_str(), text.size() + 1);
    return 0;
}

}  // extern "C"
