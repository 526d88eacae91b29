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
// The TPU kept the whole level in VMEM for the whole call.  Here two forms
// solve the same colour steps:
//
//   relax_fused_block  one launch per call, one block: two state buffers
//                      (ping-pong: with the 'real' matrix the RB plane-0
//                      diagonal couplings join columns of the same colour,
//                      and GS solves every column from the old state), b
//                      and the Thomas multipliers sit in shared memory,
//                      __syncthreads() between colour steps.  For levels
//                      whose four fields fit a block (the coarsest level
//                      of every cell: 4^3, 32x32x2).
//   relax_step         one launch per colour step (larger levels).
//
// Bound of the one-block form: neither bytes nor operations (the inputs
// are ~0.1 MB, read once) but the ncolor*nsweeps serial colour steps and
// their barriers inside one launch; it removes the ~100 torch launches per
// colour step of the plain version.
//
// The per-step form is memory-bound: a step reads the operator rows of
// its colour's columns (RB every sector of cA, since a sector holds both
// colours; FC half the rows; GS all), the state and b, and writes the
// solved columns.  Its design, per thing that held the first port back:
//
// - Inactive columns are left alone.  RB and FC copy p into out once per
//   call and update the active columns of out in place: an active column
//   reads only columns of the other colours (FC's never couple, not even
//   through the plane-0 terms) and, at a domain edge, itself through the
//   edge-copy halo (Clamped), which it reads before it writes.  The one
//   same-colour coupling, RB's four plane-0 'real' diagonal terms, reads
//   a snapshot of plane 0 taken before the step.  GS solves every column
//   from the old state and keeps ping-pong.
// - A thread per active column: RB's threads are its colour's columns
//   only (no warp is half idle), FC launches only the rows of its
//   colour's j-parity.
// - The Thomas recurrence stays on chip: the forward values and the
//   multipliers gam of a column live in shared memory, and out is written
//   once, already committed as p + (sol - p).  The recurrence keeps its
//   two IEEE divisions a plane (the plain version's arithmetic).
// - Latency is hidden by asynchronous staging over k: each thread keeps
//   the values plane k + 1 + kStepAhead needs in flight (cp.async,
//   LDGSTS) into its own ring in shared memory while plane k is solved —
//   its column's eight band values, the three of its j + 1 neighbour and
//   the three of its i + 1 neighbour that the gather reads, b, and its
//   four neighbours' state — so no load waits on the serial chain and no
//   block barrier is needed.
//
// Rounding: built with -fmad=false and IEEE division, so every product,
// sum and quotient rounds like the plain version's separate torch ops.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the first CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

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

// One colour step of column (j, i) in the one-block form: the active
// colour is solved from `src` into `dst`, the other copied.  `gam` holds
// the Thomas multipliers (nz - 1 per column, laid out like the state).
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

// ------------------------------------------------------- the step form

constexpr int kStepThreads = 64;     // two warps: two rows of 32 columns
constexpr int kStepAhead = 3;        // planes in flight beyond the next
// a thread's ring: planes k - 1 .. k + 1 + kStepAhead
constexpr int kStepStages = kStepAhead + 3;
// the values of one plane in a thread's ring: the column's bands 0..7,
// bands 2..4 of (j + 1, i), bands 5..7 of (j, i + 1), b, and the state of
// (j - 1, i), (j + 1, i), (j, i - 1), (j, i + 1)
constexpr int kOwn = 0, kSouth = 8, kEast = 11, kB = 14, kState = 15;
constexpr int kStepVals = 19;
// planes of a column's old values loaded together in the back substitution
constexpr int kBackChunk = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(sizeof(T))
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest kStepAhead groups landed
__device__ __forceinline__ void cp_wait_ahead() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStepAhead)
                 : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// shared memory of a block of nt threads: the rings, then the forward
// values and the multipliers of nz planes, value-major (a thread's own
// values nt apart: no bank conflicts)
template <typename T>
size_t step_smem(int nz, int nt) {
    return ((size_t)kStepStages * kStepVals + 2 * (size_t)nz) * nt
           * sizeof(T);
}

// One colour step c of ordering KIND for one column per thread.  RB and
// FC update `out` in place (`src` == out; `snap`: RB's plane-0 snapshot
// for the 'real' diagonal terms); GS reads `src` and writes `out`.
template <typename T, int KIND>
__global__ void __launch_bounds__(kStepThreads)
relax_step(const T* src, T* out, const T* __restrict__ b,
           const T* __restrict__ cA, const T* snap, Level g, int real,
           int c) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nt = blockDim.x, tid = threadIdx.x;
    const int m = blockIdx.x * 32 + tid % 32;
    const int r = blockIdx.y * (nt / 32) + tid / 32;
    // the column: RB (j + i + c) even; FC the rows of parity c % 2 and
    // the columns of parity c / 2; GS every column
    const int j = KIND == kFC ? 2 * r + (c & 1) : r;
    const int i = KIND == kRB ? 2 * m + ((j + c) & 1)
                              : (KIND == kFC ? 2 * m + (c >> 1) : m);
    if (j >= g.ny || i >= g.nx) return;
    const int nz = g.nz, nx = g.nx;
    const size_t P = g.plane(), EP = g.eplane();
    const size_t col = (size_t)j * nx + i;
    T* const ring = reinterpret_cast<T*>(smem) + tid;
    T* const xs = ring + (size_t)kStepStages * kStepVals * nt;
    T* const gs = xs + (size_t)nz * nt;
    auto slot = [&](int kk) -> T* {
        return ring + (size_t)((kk + kStepStages) % kStepStages)
                      * kStepVals * nt;
    };
    // the sources of a plane's values, plane 0 (Clamped's edge copy)
    const T* own = cA + (size_t)(j + 1) * (nx + 2) + (i + 1);
    const int jn = j > 0 ? j - 1 : 0, js = j < g.ny - 1 ? j + 1 : j;
    const int iw = i > 0 ? i - 1 : 0, ie = i < nx - 1 ? i + 1 : i;
    const size_t st[4] = {(size_t)jn * nx + i, (size_t)js * nx + i,
                          (size_t)j * nx + iw, (size_t)j * nx + ie};
    auto stage = [&](int kk) {
        T* v = slot(kk);
        if (kk < 0 || kk >= nz) {     // the zero planes of k +- 1 reads
            if (kk < nz + 2)
                for (int q = 0; q < kStepVals; ++q) v[q * nt] = T(0);
            return;
        }
        const T* o = own + (size_t)kk * EP;
#pragma unroll
        for (int n = 0; n < 8; ++n)
            cp_async(v + (kOwn + n) * nt, o + (size_t)n * nz * EP);
#pragma unroll
        for (int n = 0; n < 3; ++n) {
            cp_async(v + (kSouth + n) * nt,
                     o + (size_t)(n + 2) * nz * EP + (nx + 2));
            cp_async(v + (kEast + n) * nt, o + (size_t)(n + 5) * nz * EP + 1);
        }
        cp_async(v + kB * nt, b + (size_t)kk * P + col);
        const T* sp = src + (size_t)kk * P;
#pragma unroll
#pragma unroll
        for (int q = 0; q < 4; ++q)
            cp_async(v + (kState + q) * nt, sp + st[q]);
    };
    for (int kk = -1; kk <= kStepAhead; ++kk) {
        stage(kk);
        cp_commit();
    }
    T x = T(0), bet = T(0);
    for (int k = 0; k < nz; ++k) {
        stage(k + kStepAhead + 1);
        cp_commit();
        cp_wait_ahead();
        const T* vm = slot(k - 1);
        const T* v0 = slot(k);
        const T* vp = slot(k + 1);
        auto V = [&](const T* v, int q) -> T { return v[q * nt]; };
        // stencil15.cuh offdiag, term for term (N, S, W, E: the state of
        // (j - 1, i), (j + 1, i), (j, i - 1), (j, i + 1))
        T s = V(v0, kOwn + 2) * V(vp, kState + 0);
        s = s + V(vm, kSouth + 0) * V(vm, kState + 1);
        s = s + V(v0, kOwn + 3) * V(v0, kState + 0);
        s = s + V(v0, kSouth + 1) * V(v0, kState + 1);
        s = s + V(v0, kOwn + 4) * V(vm, kState + 0);
        s = s + V(vp, kSouth + 2) * V(vp, kState + 1);
        s = s + V(v0, kOwn + 5) * V(vp, kState + 2);
        s = s + V(vm, kEast + 0) * V(vm, kState + 3);
        s = s + V(v0, kOwn + 6) * V(v0, kState + 2);
        s = s + V(v0, kEast + 1) * V(v0, kState + 3);
        s = s + V(v0, kOwn + 7) * V(vm, kState + 2);
        s = s + V(vp, kEast + 2) * V(vp, kState + 3);
        if (real && k == 0) {
            // the plane-0 diagonal couplings: RB's join columns of its
            // own colour, read from the snapshot of plane 0
            const Clamped<T> d0{KIND == kRB ? snap : src, g};
            T x0 = V(v0, kOwn + 4) * d0(0, j + 1, i - 1);
            x0 = x0 + band(cA, g, 4, 0, j, i, -1, 1) * d0(0, j - 1, i + 1);
            x0 = x0 + V(v0, kOwn + 7) * d0(0, j - 1, i - 1);
            x0 = x0 + band(cA, g, 7, 0, j, i, 1, 1) * d0(0, j + 1, i + 1);
            s = s + x0;
        }
        const T rhs = V(v0, kB) - s;
        // ops/relax.tridiag: forward elimination
        if (nz == 1) {
            x = rhs / V(v0, kOwn + 0);
        } else if (k == 0) {
            bet = T(1) / V(v0, kOwn + 0);
            x = rhs * bet;
        } else {
            const T dd = V(v0, kOwn + 1);    // ud(k-1) = cA2(k)
            const T gm = dd * bet;
            gs[(size_t)(k - 1) * nt] = gm;
            bet = T(1) / (V(v0, kOwn + 0) - dd * gm);
            x = (rhs - dd * x) * bet;
        }
        xs[(size_t)k * nt] = x;
    }
    cp_wait_all();
    // the back substitution, each plane committed as p + (sol - p): the
    // column's old values are read here, after its last staged read, a
    // chunk of planes at a time before the chunk's stores (out may be
    // src, so a load after a store would wait for it)
    for (int k0 = nz - 1; k0 >= 0; k0 -= kBackChunk) {
        T pk[kBackChunk];
#pragma unroll
        for (int c = 0; c < kBackChunk; ++c)
            if (k0 - c >= 0) pk[c] = src[(size_t)(k0 - c) * P + col];
#pragma unroll
        for (int c = 0; c < kBackChunk; ++c) {
            const int k = k0 - c;
            if (k < 0) break;
            if (k < nz - 1) x = xs[(size_t)k * nt] - gs[(size_t)k * nt] * x;
            out[(size_t)k * P + col] = pk[c] + (x - pk[c]);
        }
    }
}

template <typename T, int KIND>
int launch_steps(const T* p, const T* b, const T* cA, T* out, T* scratch,
                 const Level& g, int real, int nsweeps, cudaStream_t s) {
    const void* kern = reinterpret_cast<const void*>(&relax_step<T, KIND>);
    int nt = kStepThreads;
    const size_t smem = step_smem<T>(g.nz, nt);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int ncolor = ncolors(KIND), nsteps = ncolor * nsweeps;
    const size_t n = (size_t)g.nz * g.plane();
    const int rows = nt / 32;
    const int cols = KIND == kGS ? g.nx : (g.nx + 1) / 2;
    const int nrows = KIND == kFC ? (g.ny + 1) / 2 : g.ny;
    const dim3 grid((cols + 31) / 32, (nrows + rows - 1) / rows);
    if (KIND == kGS) {
        // ping-pong through out and scratch, the last step writing out
        const T* src = p;
        for (int step = 0; step < nsteps; ++step) {
            T* dst = ((nsteps - 1 - step) % 2 == 0) ? out : scratch;
            relax_step<T, KIND><<<grid, nt, smem, s>>>(src, dst, b, cA,
                                                       nullptr, g, real, 0);
            e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
            src = dst;
        }
        return 0;
    }
    // RB, FC: p copied once, the active columns updated in place
    e = cudaMemcpyAsync(out, p, n * sizeof(T), cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    for (int step = 0; step < nsteps; ++step) {
        if (KIND == kRB && real) {
            e = cudaMemcpyAsync(scratch, out, g.plane() * sizeof(T),
                                cudaMemcpyDeviceToDevice, s);
            if (e != cudaSuccess) return (int)e;
        }
        relax_step<T, KIND><<<grid, nt, smem, s>>>(out, out, b, cA, scratch,
                                                   g, real, step % ncolor);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

// one_block: relax_fused_block (out <- p after nsweeps; scratch unused);
// else ncolor * nsweeps relax_step launches.  scratch: GS's second state
// buffer (nz, ny, nx), RB's plane-0 snapshot (ny, nx), unused by FC.
template <typename T>
int launch_relax_fused(const void* p, const void* b, const void* cA,
                       void* out, void* scratch, int nz, int ny, int nx,
                       int real, int nsweeps, int kind, int one_block,
                       void* stream) {
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
    const T* pt = (const T*)p;
    const T* bt = (const T*)b;
    const T* ct = (const T*)cA;
    T* ot = (T*)out;
    T* sc = (T*)scratch;
    if (kind == kRB)
        return launch_steps<T, kRB>(pt, bt, ct, ot, sc, g, real, nsweeps, s);
    if (kind == kFC)
        return launch_steps<T, kFC>(pt, bt, ct, ot, sc, g, real, nsweeps, s);
    return launch_steps<T, kGS>(pt, bt, ct, ot, sc, g, real, nsweeps, s);
}

}  // namespace

extern "C" {

int mg_relax_fused_f32(const void* p, const void* b, const void* cA,
                       void* out, void* scratch, int nz, int ny, int nx,
                       int real, int nsweeps, int kind, int one_block,
                       void* stream) {
    return launch_relax_fused<float>(p, b, cA, out, scratch, nz, ny, nx,
                                     real, nsweeps, kind, one_block, stream);
}

int mg_relax_fused_f64(const void* p, const void* b, const void* cA,
                       void* out, void* scratch, int nz, int ny, int nx,
                       int real, int nsweeps, int kind, int one_block,
                       void* stream) {
    return launch_relax_fused<double>(p, b, cA, out, scratch, nz, ny, nx,
                                      real, nsweeps, kind, one_block,
                                      stream);
}

}  // extern "C"
