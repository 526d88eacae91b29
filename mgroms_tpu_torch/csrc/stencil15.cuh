// The 15-point stencil on a full-layout level, shared by the K5 residual
// (stencil_tiled.cu) and the K6 line smoother (relax_fused.cu).
//
// Layouts (C order, z leading): interior fields (nz, ny, nx); the band
// stack cA (8, nz, ny+2, nx+2) and a halo-extended state pe
// (nz, ny+2, nx+2).  Every product and sum below rounds on its own
// (-fmad=false) and comes in the order of mgroms_tpu_torch/ops/stencil.py,
// so the kernels equal the plain torch versions to 0 ulp.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Level {
    int nz, ny, nx;
    __host__ __device__ size_t plane() const { return (size_t)ny * nx; }
    __host__ __device__ size_t eplane() const {
        return (size_t)(ny + 2) * (nx + 2);
    }
};

// Band n (0-based; reference band n+1) at plane kk, interior column
// (j + dj, i + di); planes outside [0, nz) read 0 (stencil.shift).
template <typename T>
__device__ __forceinline__ T band(const T* cA, const Level& g, int n, int kk,
                                  int j, int i, int dj = 0, int di = 0) {
    if (kk < 0 || kk >= g.nz) return T(0);
    return cA[((size_t)n * g.nz + kk) * g.eplane()
              + (size_t)(j + 1 + dj) * (g.nx + 2) + (i + 1 + di)];
}

// State read from a halo-extended pe (nz, ny+2, nx+2).
template <typename T>
struct Extended {
    const T* pe;
    Level g;
    __device__ __forceinline__ T operator()(int kk, int jj, int ii) const {
        if (kk < 0 || kk >= g.nz) return T(0);
        return pe[(size_t)kk * g.eplane() + (size_t)(jj + 1) * (g.nx + 2)
                  + (ii + 1)];
    }
};

// State read from an interior p (nz, ny, nx) through the edge-copy halo of
// bc.extend_h1: a halo index is clamped to the nearest interior one.
template <typename T>
struct Clamped {
    const T* p;
    Level g;
    __device__ __forceinline__ T operator()(int kk, int jj, int ii) const {
        if (kk < 0 || kk >= g.nz) return T(0);
        jj = jj < 0 ? 0 : (jj >= g.ny ? g.ny - 1 : jj);
        ii = ii < 0 ? 0 : (ii >= g.nx ? g.nx - 1 : ii);
        return p[(size_t)kk * g.plane() + (size_t)jj * g.nx + ii];
    }
};

// Couplings of column (j, i) to the other columns at plane k
// (stencil.offdiag_columns): the 12 terms summed left to right, then on
// plane 0 with the 'real' matrix the 4 horizontal-diagonal terms summed
// into x0 and added last.
template <typename T, typename S>
__device__ __forceinline__ T offdiag(const T* cA, const S& st, const Level& g,
                                     int real, int k, int j, int i) {
    T s = band(cA, g, 2, k, j, i) * st(k + 1, j - 1, i);
    s = s + band(cA, g, 2, k - 1, j, i, 1, 0) * st(k - 1, j + 1, i);
    s = s + band(cA, g, 3, k, j, i) * st(k, j - 1, i);
    s = s + band(cA, g, 3, k, j, i, 1, 0) * st(k, j + 1, i);
    s = s + band(cA, g, 4, k, j, i) * st(k - 1, j - 1, i);
    s = s + band(cA, g, 4, k + 1, j, i, 1, 0) * st(k + 1, j + 1, i);
    s = s + band(cA, g, 5, k, j, i) * st(k + 1, j, i - 1);
    s = s + band(cA, g, 5, k - 1, j, i, 0, 1) * st(k - 1, j, i + 1);
    s = s + band(cA, g, 6, k, j, i) * st(k, j, i - 1);
    s = s + band(cA, g, 6, k, j, i, 0, 1) * st(k, j, i + 1);
    s = s + band(cA, g, 7, k, j, i) * st(k - 1, j, i - 1);
    s = s + band(cA, g, 7, k + 1, j, i, 0, 1) * st(k + 1, j, i + 1);
    if (real && k == 0) {
        T x0 = band(cA, g, 4, 0, j, i) * st(0, j + 1, i - 1);
        x0 = x0 + band(cA, g, 4, 0, j, i, -1, 1) * st(0, j - 1, i + 1);
        x0 = x0 + band(cA, g, 7, 0, j, i) * st(0, j - 1, i - 1);
        x0 = x0 + band(cA, g, 7, 0, j, i, 1, 1) * st(0, j + 1, i + 1);
        s = s + x0;
    }
    return s;
}

}  // namespace
