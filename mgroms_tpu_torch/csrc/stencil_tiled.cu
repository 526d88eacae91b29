// Full-layout 15-point residual r = b - A p (K5).
//
// Replaces the Pallas TPU kernel mgroms_tpu/ops/pallas/stencil_tiled.py:
// residual_tiled (_kernel) and computes, term for term and in the same
// operation order, ops/stencil.residual(pe, b, cA, real):
// b - d p - lo p(k-1) - hi p(k+1) - offdiag (stencil15.cuh).
//
// Bound on this card: memory.  Per point it reads the 8 bands, b and the
// state once from device memory and writes r: ~30 flops against 44 bytes
// (f32).  One thread per (j, i) column walks k; i is the fastest thread
// index, so a warp reads 32 adjacent addresses of every array, and the
// state's reuse across the 15 stencil points (neighbouring columns and
// planes) is served by L1/L2.  The TPU's row padding and pl.Element
// windows have no counterpart: the kernel takes any shape.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil15.cuh"

namespace {

template <typename T>
__global__ void residual_kernel(const T* __restrict__ pe,
                                const T* __restrict__ b,
                                const T* __restrict__ cA,
                                T* __restrict__ r, Level g, int real) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= g.nx || j >= g.ny) return;
    const Extended<T> st{pe, g};
    const size_t P = g.plane();
    const size_t col = (size_t)j * g.nx + i;
    for (int k = 0; k < g.nz; ++k) {
        const size_t o = k * P + col;
        r[o] = b[o] - band(cA, g, 0, k, j, i) * st(k, j, i)
               - band(cA, g, 1, k, j, i) * st(k - 1, j, i)
               - band(cA, g, 1, k + 1, j, i) * st(k + 1, j, i)
               - offdiag(cA, st, g, real, k, j, i);
    }
}

template <typename T>
int launch_residual(const void* pe, const void* b, const void* cA, void* r,
                    int nz, int ny, int nx, int real, void* stream) {
    const Level g{nz, ny, nx};
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x,
                    (ny + block.y - 1) / block.y);
    residual_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        (const T*)pe, (const T*)b, (const T*)cA, (T*)r, g, real);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_residual_f32(const void* pe, const void* b, const void* cA, void* r,
                    int nz, int ny, int nx, int real, void* stream) {
    return launch_residual<float>(pe, b, cA, r, nz, ny, nx, real, stream);
}

int mg_residual_f64(const void* pe, const void* b, const void* cA, void* r,
                    int nz, int ny, int nx, int real, void* stream) {
    return launch_residual<double>(pe, b, cA, r, nz, ny, nx, real, stream);
}

}  // extern "C"
