// Residual r = b - A p on one tile of a (1, npx) mesh, the x-seam halo read
// from the neighbour tiles (K7).
//
// Replaces the Pallas TPU kernel mgroms_tpu/ops/pallas/rdma_halo.py:
// residual_overlap_x (_kernel).  That kernel starts an inter-chip RDMA of
// its edge columns, computes the interior columns while the copies fly,
// waits on the receive semaphores and finishes the two seam columns.  Here
// the same overlap is one launch: the interior blocks (columns 1 .. nx-2)
// read only the tile's own memory, and the seam blocks (columns 0 and
// nx-1), scheduled in the same grid, read the west and east neighbours'
// edge columns directly through their device pointers (another device's
// memory through peer access, which the wrapper requires).  No halo is
// built in memory.  y and the outer domain edges use the Neumann mirror
// (edge copy; rdma_halo._mirror_y and bc.extend_h1).
//
// Term order: stencil15.cuh's offdiag and the K5 expression, with
// -fmad=false, so the result equals ops/stencil.residual on the
// halo-extended tile (parallel/exchange.halo_extend) to 0 ulp.
//
// Bound on this card: memory.  Per point it reads the 8 bands, b and p once
// and writes r (44 bytes in f32) for ~30 flops.  The interior blocks run
// one thread per (j, i) column walking a chunk of k, i fastest, over whole
// 32-column groups (aligned loads; the threads of the two seam columns
// return), as K5; a tile is a fraction of a level, so the planes are cut
// into grid.z chunks until the launch has about as many threads as K5 has
// on a whole CUC level (2^20), or the four tile launches would each end in
// a long tail of 64-plane columns.  The seam blocks run one thread per
// (k, j, side) point: a seam
// column's reads are strided (one per row), and a thread per point keeps
// enough of them in flight that the seam is no tail behind the interior.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>

#include "stencil15.cuh"

namespace {

constexpr int kBx = 32, kBy = 8;

// State read of a seam column: the tile's p (nz, ny, nx) clamped in j (the
// y mirror), and in i the west neighbour's last column (i < 0) or the east
// neighbour's first (i >= nx); without that neighbour (domain edge) the
// tile's own edge column.
template <typename T>
struct Seamed {
    const T* p;
    const T* pw;     // west neighbour (nz, ny, nxw) or nullptr
    const T* pe;     // east neighbour (nz, ny, nxe) or nullptr
    Level g;
    int nxw, nxe;
    __device__ __forceinline__ T operator()(int kk, int jj, int ii) const {
        if (kk < 0 || kk >= g.nz) return T(0);
        jj = jj < 0 ? 0 : (jj >= g.ny ? g.ny - 1 : jj);
        const size_t row = (size_t)kk * g.ny + jj;
        if (ii < 0)
            return pw ? pw[row * nxw + (nxw - 1)] : p[row * g.nx];
        if (ii >= g.nx)
            return pe ? pe[row * nxe] : p[row * g.nx + (g.nx - 1)];
        return p[row * g.nx + ii];
    }
};

template <typename T, typename S>
__device__ __forceinline__ void point(const T* __restrict__ b,
                                      const T* __restrict__ cA,
                                      T* __restrict__ r, const S& st,
                                      const Level& g, int real, int k, int j,
                                      int i) {
    const size_t o = k * g.plane() + (size_t)j * g.nx + i;
    r[o] = b[o] - band(cA, g, 0, k, j, i) * st(k, j, i)
           - band(cA, g, 1, k, j, i) * st(k - 1, j, i)
           - band(cA, g, 1, k + 1, j, i) * st(k + 1, j, i)
           - offdiag(cA, st, g, real, k, j, i);
}

// blockIdx.x < nbx: interior blocks over the columns 1 .. nx-2, planes
// [blockIdx.z * kc, +kc) (local reads only; Clamped clamps only j there).
// blockIdx.x >= nbx (and blockIdx.z == 0): the seam blocks, point
// s = ((blockIdx.x - nbx) * gridDim.y + blockIdx.y) * 256 + t of the
// 2 * nz * ny seam points, side fastest, then j, then k.
template <typename T>
__global__ void overlap_kernel(const T* __restrict__ p,
                               const T* __restrict__ pw,
                               const T* __restrict__ pe,
                               const T* __restrict__ b,
                               const T* __restrict__ cA,
                               T* __restrict__ r, Level g, int nxw, int nxe,
                               int real, int nbx, int kc) {
    if ((int)blockIdx.x < nbx) {
        const int i = blockIdx.x * kBx + threadIdx.x;
        const int j = blockIdx.y * kBy + threadIdx.y;
        if (i == 0 || i >= g.nx - 1 || j >= g.ny) return;
        const Clamped<T> st{p, g};
        const int k1 = min(g.nz, ((int)blockIdx.z + 1) * kc);
        for (int k = blockIdx.z * kc; k < k1; ++k)
            point(b, cA, r, st, g, real, k, j, i);
        return;
    }
    if (blockIdx.z != 0) return;
    const size_t s = ((size_t)(blockIdx.x - nbx) * gridDim.y + blockIdx.y)
                     * (kBx * kBy) + threadIdx.y * kBx + threadIdx.x;
    if (s >= (size_t)2 * g.nz * g.ny) return;
    const int side = (int)(s % 2);
    const int j = (int)((s / 2) % g.ny);
    const int k = (int)(s / 2 / g.ny);
    const Seamed<T> st{p, pw, pe, g, nxw, nxe};
    point(b, cA, r, st, g, real, k, j, side ? g.nx - 1 : 0);
}

template <typename T>
int launch(const void* p, const void* pw, const void* pe, const void* b,
           const void* cA, void* r, int nz, int ny, int nx, int nxw, int nxe,
           int real, void* stream) {
    const Level g{nz, ny, nx};
    const int nbx = nx > 2 ? (nx + kBx - 1) / kBx : 0;  // interior blocks
    const int gy = (ny + kBy - 1) / kBy;
    const long seam = 2L * nz * ny;                      // seam points
    const int nsx = (int)((seam + (long)gy * kBx * kBy - 1)
                          / ((long)gy * kBx * kBy));     // seam blocks in x
    // plane chunks: about 2^20 interior threads in all, at most nz chunks
    const long cols = (long)nx * ny;
    const int nzc = (int)std::min<long>(nz, std::max<long>(
        1, ((1L << 20) + cols - 1) / cols));
    const int kc = (nz + nzc - 1) / nzc;                 // planes a chunk
    const dim3 block(kBx, kBy);
    const dim3 grid(nbx + nsx, gy, (nz + kc - 1) / kc);
    overlap_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        (const T*)p, (const T*)pw, (const T*)pe, (const T*)b, (const T*)cA,
        (T*)r, g, nxw, nxe, real, nbx, kc);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_residual_overlap_x_f32(const void* p, const void* pw, const void* pe,
                              const void* b, const void* cA, void* r, int nz,
                              int ny, int nx, int nxw, int nxe, int real,
                              void* stream) {
    return launch<float>(p, pw, pe, b, cA, r, nz, ny, nx, nxw, nxe, real,
                         stream);
}

int mg_residual_overlap_x_f64(const void* p, const void* pw, const void* pe,
                              const void* b, const void* cA, void* r, int nz,
                              int ny, int nx, int nxw, int nxe, int real,
                              void* stream) {
    return launch<double>(p, pw, pe, b, cA, r, nz, ny, nx, nxw, nxe, real,
                          stream);
}

// Let the current device's kernels read device ``peer``'s memory; 0 when
// that is (or already was) enabled, else the CUDA error.
int mg_enable_peer(int peer) {
    cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        return 0;
    }
    return (int)e;
}

}  // extern "C"
