// Launching a kernel as one thread block cluster on Hopper (K6's cluster
// form, relax_fused.cu; K10's step floor, roofline.cu): non-portable
// cluster sizes (up to 16 blocks) allowed, the dynamic shared memory set,
// and whether the card can make such a cluster resident asked once per
// kernel, device and shape (cudaOccupancyMaxActiveClusters), not at
// every call: on the host-bound levels the host's time a call counts.
// kernel_attributes sets a kernel's attributes once per kernel and device
// (raised when a call needs more shared memory), for the one-block
// launches too.

#pragma once

#include <cuda_runtime.h>

namespace {

// returned when the card cannot make the cluster resident (the caller
// may try fewer blocks)
constexpr int kNoCluster = -1;

// Let kern take smem bytes of dynamic shared memory (with `cluster`, also
// non-portable cluster sizes) on the current device.  The attributes are
// set once per kernel and device, and again only to raise the limit:
// a kernel's limit never falls below what an earlier call was given.
inline int kernel_attributes(const void* kern, size_t smem, bool cluster) {
    struct Set {
        const void* kern;
        int dev;
        size_t smem;
        bool cluster;
    };
    static Set done[64];
    static int ndone = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    Set* d = nullptr;
    for (int i = 0; i < ndone && i < 64; ++i)
        if (done[i].kern == kern && done[i].dev == dev) d = &done[i];
    if (d && d->smem >= smem && (d->cluster || !cluster)) return 0;
    if (!d) {
        d = &done[ndone++ % 64];
        *d = {kern, dev, 0, false};
    }
    if (smem > d->smem) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        d->smem = smem;
    }
    if (cluster && !d->cluster) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        d->cluster = true;
    }
    return 0;
}

struct ClusterQuery {
    const void* kern;
    int dev, nb, nt;
    size_t smem;
    int nclusters;
};

// Launch kern<<<nb, nt, smem, s>>>(args...) as one cluster of nb blocks;
// returns the CUDA error code, or kNoCluster
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), int nb, int nt, size_t smem,
                   cudaStream_t s, A... args) {
    static ClusterQuery asked[32];
    static int nasked = 0;
    int e = kernel_attributes((const void*)kern, smem, true);
    if (e != 0) return e;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb);
    cfg.blockDim = dim3(nt);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int nclusters = -1;
    for (int i = 0; i < nasked && i < 32; ++i) {
        const ClusterQuery& q = asked[i];
        if (q.kern == (const void*)kern && q.dev == dev && q.nb == nb
            && q.nt == nt && q.smem == smem)
            nclusters = q.nclusters;
    }
    if (nclusters < 0) {
        const cudaError_t q =
            cudaOccupancyMaxActiveClusters(&nclusters, kern, &cfg);
        if (q != cudaSuccess) return (int)q;
        asked[nasked++ % 32] = {(const void*)kern, dev, nb, nt, smem,
                                nclusters};
    }
    if (nclusters < 1) return kNoCluster;
    return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace
