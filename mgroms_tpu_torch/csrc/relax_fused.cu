// Masked z-line smoothing of a whole full-layout level (K6), in the three
// orderings of the JAX package.
//
// Replaces the Pallas TPU kernel mgroms_tpu/ops/pallas/relax_fused.py:
// fused_relax (_kernel, kinds 'RB', 'FC', 'GS'), and computes, term for
// term and in the same operation order, what ops/relax.relax(p, b, cA,
// nsweeps, kind, real, extend_fn=extend_h1) computes: nsweeps * ncolor
// colour steps (ncolor 2, 4, 1), colour 0 first; in step c every column of
// the colour gathers its couplings from the pre-step state
// (stencil15.cuh), runs the Thomas recurrence of ops/relax.tridiag with its
// divisions, and commits p + (sol - p); the other columns keep p.  The
// colours (relax_fused.py:72-80):
//   RB  (j + i + c) even;
//   FC  (i % 2 == c / 2) and (j % 2 == c % 2): (i even, j even), (i even,
//       j odd), (i odd, j even), (i odd, j odd), the reference order;
//   GS  every column: the JAX package's column-Jacobi GS, every column
//       solved from the pre-sweep state (not the reference's sequential
//       sweep), still committed as p + (sol - p), which in floating point
//       is not sol.
//
// The TPU kept the whole level in VMEM for the whole call.  Here a colour
// step reads one state buffer and writes the other (ping-pong): with the
// 'real' matrix the RB plane-0 diagonal couplings join columns of the same
// colour, and GS solves every column from the old state, so an in-place
// update would race (FC columns of one colour never couple, not even
// through the plane-0 terms; ping-pong is right for them too).  Two forms
// share the column step:
//
//   relax_fused_block  one launch per call, one block: both state buffers,
//                      b and the Thomas multipliers sit in shared memory,
//                      __syncthreads() between colour steps.  For levels
//                      whose four fields fit a block (the coarsest level
//                      of every cell: 4^3, 32x32x2).
//   relax_fused_step   one launch per colour step, one thread per column,
//                      the buffers in device memory (larger levels).
//
// Bound on this card: at the coarsest level it is neither bytes nor
// operations (the inputs are ~0.1 MB, read once) but the ncolor*nsweeps
// serial colour steps and their barriers inside one launch; the one-block
// form removes the ~100 torch launches per colour step of the plain
// version.  The per-step form is memory-bound: each step reads the state,
// b and the 8 bands (active and inactive columns alternate, so every cache
// line is fetched although a half, a quarter or, for GS, all of the
// columns solve), and writes the state and the multipliers.
//
// Rounding: built with -fmad=false and IEEE division, so every product,
// sum and quotient rounds like the plain version's separate torch ops.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "stencil15.cuh"

namespace {

constexpr int kBlockThreads = 512;

// The orderings and their colour steps per sweep (the code and ncolor of
// each entry of ops/kernels/relax_fused.py KINDS).
constexpr int kRB = 0;
constexpr int kFC = 1;
constexpr int kGS = 2;

__host__ __device__ __forceinline__ int ncolors(int kind) {
    return kind == kRB ? 2 : (kind == kFC ? 4 : 1);
}

// Whether column (j, i) is of colour c.
__device__ __forceinline__ bool active(int kind, int c, int j, int i) {
    if (kind == kRB) return ((j + i + c) & 1) == 0;
    if (kind == kFC) return (i & 1) == (c >> 1) && (j & 1) == (c & 1);
    return true;
}

// One colour step of column (j, i): the active colour is solved from
// `src` into `dst`, the other copied.  `gam` holds the Thomas multipliers
// (nz - 1 per column, laid out like the state).
template <typename T>
__device__ __forceinline__ void column_step(const T* src, T* dst, const T* b,
                                            T* gam, const T* cA,
                                            const Level& g, int real,
                                            int kind, int c, int j, int i) {
    const size_t P = g.plane();
    const size_t col = (size_t)j * g.nx + i;
    if (!active(kind, c, j, i)) {
        for (int k = 0; k < g.nz; ++k) dst[k * P + col] = src[k * P + col];
        return;
    }
    const Clamped<T> st{src, g};
    T rhs = b[col] - offdiag(cA, st, g, real, 0, j, i);
    if (g.nz == 1) {
        T sol = rhs / band(cA, g, 0, 0, j, i);
        dst[col] = src[col] + (sol - src[col]);
        return;
    }
    // ops/relax.tridiag: forward elimination, then back substitution
    T bet = T(1) / band(cA, g, 0, 0, j, i);
    T x = rhs * bet;
    dst[col] = x;
    for (int k = 1; k < g.nz; ++k) {
        const size_t o = k * P + col;
        const T dd = band(cA, g, 1, k, j, i);    // ud(k-1) = cA2(k)
        const T gm = dd * bet;
        gam[o - P] = gm;
        bet = T(1) / (band(cA, g, 0, k, j, i) - dd * gm);
        rhs = b[o] - offdiag(cA, st, g, real, k, j, i);
        x = (rhs - dd * x) * bet;
        dst[o] = x;
    }
    for (int k = g.nz - 2; k >= 0; --k) {
        const size_t o = k * P + col;
        x = dst[o] - gam[o] * x;
        dst[o] = x;
    }
    for (int k = 0; k < g.nz; ++k) {
        const size_t o = k * P + col;
        dst[o] = src[o] + (dst[o] - src[o]);
    }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
relax_fused_block(const T* __restrict__ p, const T* __restrict__ b,
                  const T* __restrict__ cA, T* __restrict__ out, Level g,
                  int real, int nsweeps, int kind) {
    extern __shared__ __align__(16) unsigned char smem[];
    const size_t n = (size_t)g.nz * g.plane();
    T* buf0 = reinterpret_cast<T*>(smem);
    T* buf1 = buf0 + n;
    T* sb = buf1 + n;
    T* sgam = sb + n;
    for (size_t o = threadIdx.x; o < n; o += blockDim.x) {
        buf0[o] = p[o];
        sb[o] = b[o];
    }
    __syncthreads();
    const int ncols = g.ny * g.nx;
    const int ncolor = ncolors(kind);
    T* src = buf0;
    T* dst = buf1;
    for (int step = 0; step < ncolor * nsweeps; ++step) {
        // every column's step reads src only and writes its own dst
        // column: the barrier below orders the steps
        for (int col = threadIdx.x; col < ncols; col += blockDim.x) {
            column_step(src, dst, sb, sgam, cA, g, real, kind, step % ncolor,
                        col / g.nx, col % g.nx);
        }
        __syncthreads();
        T* t = src;
        src = dst;
        dst = t;
    }
    for (size_t o = threadIdx.x; o < n; o += blockDim.x) out[o] = src[o];
}

template <typename T>
__global__ void relax_fused_step(const T* __restrict__ src,
                                 T* __restrict__ dst,
                                 const T* __restrict__ b,
                                 T* __restrict__ gam,
                                 const T* __restrict__ cA, Level g, int real,
                                 int kind, int c) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    if (i >= g.nx || j >= g.ny) return;
    column_step(src, dst, b, gam, cA, g, real, kind, c, j, i);
}

// one_block: relax_fused_block (out <- p after nsweeps; buf, gam unused);
// else ncolor*nsweeps relax_fused_step launches through out and buf, the
// last writing out.
template <typename T>
int launch_relax_fused(const void* p, const void* b, const void* cA,
                       void* out, void* buf, void* gam, int nz, int ny,
                       int nx, int real, int nsweeps, int kind,
                       int one_block, void* stream) {
    if (kind < kRB || kind > kGS) return (int)cudaErrorInvalidValue;
    const Level g{nz, ny, nx};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (one_block) {
        const size_t smem = 4 * (size_t)nz * g.plane() * sizeof(T);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                relax_fused_block<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        int ncols = ny * nx;
        int threads = ncols < kBlockThreads ? (ncols + 31) / 32 * 32
                                            : kBlockThreads;
        relax_fused_block<T><<<1, threads, smem, s>>>(
            (const T*)p, (const T*)b, (const T*)cA, (T*)out, g, real,
            nsweeps, kind);
        return (int)cudaGetLastError();
    }
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x,
                    (ny + block.y - 1) / block.y);
    const int ncolor = ncolors(kind);
    const int nsteps = ncolor * nsweeps;
    const T* src = (const T*)p;
    for (int step = 0; step < nsteps; ++step) {
        T* dst = ((nsteps - 1 - step) % 2 == 0) ? (T*)out : (T*)buf;
        relax_fused_step<T><<<grid, block, 0, s>>>(
            src, dst, (const T*)b, (T*)gam, (const T*)cA, g, real, kind,
            step % ncolor);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        src = dst;
    }
    return 0;
}

}  // namespace

extern "C" {

int mg_relax_fused_f32(const void* p, const void* b, const void* cA,
                       void* out, void* buf, void* gam, int nz, int ny,
                       int nx, int real, int nsweeps, int kind,
                       int one_block, void* stream) {
    return launch_relax_fused<float>(p, b, cA, out, buf, gam, nz, ny, nx,
                                     real, nsweeps, kind, one_block, stream);
}

int mg_relax_fused_f64(const void* p, const void* b, const void* cA,
                       void* out, void* buf, void* gam, int nz, int ny,
                       int nx, int real, int nsweeps, int kind,
                       int one_block, void* stream) {
    return launch_relax_fused<double>(p, b, cA, out, buf, gam, nz, ny, nx,
                                      real, nsweeps, kind, one_block,
                                      stream);
}

}  // extern "C"
