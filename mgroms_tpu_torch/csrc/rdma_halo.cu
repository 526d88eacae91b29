// Residual r = b - A p on one tile of a (1, npx) mesh, the x-seam halo read
// from the neighbour tiles (K7).
//
// Replaces the Pallas TPU kernel mgroms_tpu/ops/pallas/rdma_halo.py:
// residual_overlap_x (_kernel).  That kernel starts an inter-chip RDMA of
// its edge columns, computes the interior columns while the copies fly,
// waits on the receive semaphores and finishes the two seam columns.  Here
// a tile is one launch.  A block owns kTJ x kTI columns of the tile and
// walks all nz planes; the seam is the halo column its edge blocks stage
// with every plane, read in place from the west neighbour's last column or
// the east neighbour's first (another device's memory through peer access,
// which the wrapper requires).  The blocks of the first and last tile
// columns come first in block order, so on a multi-card mesh their peer
// loads are in flight while the interior blocks run: the GPU image of
// "start the RDMA, compute the interior, wait, finish the seams".  No halo
// is built in memory.  y and the outer domain edges use the Neumann mirror
// (edge copy; rdma_halo._mirror_y and bc.extend_h1).
//
// Term order: stencil15.cuh's offdiag and the K5 expression, with
// -fmad=false, so the result equals ops/stencil.residual on the
// halo-extended tile (parallel/exchange.halo_extend) to 0 ulp.
//
// Bound on this card: memory.  Per point it reads the 8 bands, b and p once
// and writes r (44 bytes in f32) for ~30 flops; the bands are 73 % of it.
// The design, per thing that held the first port back (a thread a column
// walking a chunk of planes, each point loading its 8 bands, some twice,
// and 15 clamped state values from device memory; separate seam blocks of
// strided loads; plane chunks re-reading their edges):
//
// - A ring of kSlots = 4 planes in shared memory: planes k-1, k and k+1,
//   which the stencil reads, and k+2 in flight.  A slot holds the tile's state
//   window (kTJ+2) x (kTI+2) (j clamped at the domain's rows, i the
//   neighbouring tile columns or the seam), its b and, for each of the 8
//   bands, a (kTJ+1) x (kTI+1) window (bands 3-5 are read a row on, 6-8 a
//   column on; reference numbering).  Every value the stencil reads at
//   plane k comes from there, except the two plane-0 'real' band values
//   off the windows, loaded once into registers.  Each band value leaves
//   device memory once; the windows' halo is re-read from L2.
// - cp.async copies.  The band stack is (8, nz, ny+2, nx+2): its rows are
//   not 16-byte aligned, so a band value is one 4-byte (f64: 8-byte) copy.
//   p and b rows are staged in 16-byte copies where nx and the pointers
//   allow (the V instance: every CUC tile), else value by value.
// - Tile 16 x 32, a thread a point, 512 threads: f32 91,520 bytes of
//   shared memory a block, 2 blocks (1,024 threads, <= 64 registers) an
//   SM; a (64, 1024, 256) tile is 512 blocks, 1.94 waves of 264.  f64
//   180,736 bytes, 1 block an SM.  Measured on an H100 against the same
//   1,024 threads an SM in other shapes (scripts/micro_overlap.py): 8 x 32
//   at 4 blocks an SM moves 2.8 % more (its halo) and ran 6-10 % slower;
//   32 x 32 at 1 block an SM 15 % slower.
// - One block barrier a plane: it publishes plane k+1 and retires the
//   slot of plane k-2, which then takes plane k+1+ahead.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "stencil15.cuh"

namespace {

constexpr int kTI = 32, kTJ = 16;             // tile columns, rows
constexpr int kNT = kTI * kTJ;                // a thread a point
// ring slots: planes k-1, k, k+1 and kSlots - 3 in flight ahead of them
constexpr int kSlots = 4;
constexpr int kSmemSM = 233472;               // shared memory of an SM
constexpr int kBP = kTI + 1;                  // band window pitch
constexpr int kBW = (kTJ + 1) * kBP;          // one band's window
constexpr int kBands = 8 * kBW;
constexpr int kBandIters = (kBands + kNT - 1) / kNT;

// One ring slot: the state window (rows of kTI + 2 * e16 values, column c
// of the tile at e16 + c, so the tile's columns start 16-byte aligned and
// the halo columns -1 and kTI sit beside them), b, the 8 band windows.
template <typename T>
struct Slot {
    static constexpr int e16 = 16 / sizeof(T);
    static constexpr int ps = kTI + 2 * e16;
    static constexpr int state = (kTJ + 2) * ps;
    static constexpr int rhs = kTJ * kTI;
    static constexpr int size = state + rhs + kBands;
    static constexpr int n = kSlots;
    static constexpr size_t bytes = (size_t)n * size * sizeof(T);
    // blocks an SM: as many as its shared memory (1 KB reserved a block)
    // and its 2,048 threads allow; the launch bounds fit the registers
    static constexpr int fit = kSmemSM / (int)(bytes + 1024);
    static constexpr int per_sm = fit < 2048 / kNT ? fit : 2048 / kNT;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an N-byte copy to shared address dst (16: bypassing L1)
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(dst), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(dst), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest N groups landed
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// V: p and b rows staged in 16-byte copies (nx a multiple of 16 bytes,
// both pointers 16-byte aligned), else value by value.
template <typename T, bool V>
__global__ void __launch_bounds__(kNT, Slot<T>::per_sm)
overlap_kernel(const T* __restrict__ p, const T* __restrict__ pw,
               const T* __restrict__ pe, const T* __restrict__ b,
               const T* __restrict__ cA, T* __restrict__ r, Level g, int nxw,
               int nxe, int real, int nbx, int nby) {
    using S = Slot<T>;
    constexpr int cw = V ? S::e16 : 1;        // values a p / b copy
    constexpr int cpr = kTI / cw;             // copies a tile row
    constexpr int nsc = (kTJ + 2) * cpr;      // state rows
    constexpr int nbc = kTJ * cpr;            // b rows
    constexpr int nst = nsc + nbc + 2 * (kTJ + 2);   // + the halo columns
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);

    // block order: the tile columns at the seams (first and last) first
    const int blk = blockIdx.x;
    const int nedge = nbx > 1 ? 2 * nby : nby;
    int bj, bi;
    if (blk < nedge) {
        bj = nbx > 1 ? blk >> 1 : blk;
        bi = (nbx > 1 && (blk & 1)) ? nbx - 1 : 0;
    } else {
        bj = (blk - nedge) / (nbx - 2);
        bi = 1 + (blk - nedge) % (nbx - 2);
    }
    const int j0 = bj * kTJ, i0 = bi * kTI;
    const int rows = min(kTJ, g.ny - j0), cols = min(kTI, g.nx - i0);
    const int tid = threadIdx.y * kTI + threadIdx.x;
    const size_t P = g.plane(), EP = g.eplane();
    const int ex = g.nx + 2;

    const auto row_of = [&](int w) {          // window row -> clamped j
        const int jj = j0 - 1 + w;
        return jj < 0 ? 0 : (jj >= g.ny ? g.ny - 1 : jj);
    };
    // This thread's copies, the same every plane, worked out once (the
    // stage of a plane then costs an add and a copy each).  Bands: the
    // offset from plane k's start of band 0 (~0u: none).
    uint32_t goff[kBandIters];
#pragma unroll
    for (int m = 0; m < kBandIters; ++m) {
        const int e = tid + m * kNT;
        const int n = e / kBW, rem = e % kBW;
        const int jb = rem / kBP, cb = rem % kBP;
        const bool ok = e < kBands && jb < rows + (n >= 2 && n <= 4)
                        && cb < cols + (n >= 5);
        goff[m] = ok ? (uint32_t)((size_t)n * g.nz * EP
                                  + (size_t)(j0 + 1 + jb) * ex + i0 + 1 + cb)
                     : ~0u;
    }
    // p's window rows, b's rows and the two halo columns: the source at
    // plane 0 (nullptr: none), its plane stride, the slot offset and
    // whether the copy is 16 bytes
    constexpr int nrole = (nst + kNT - 1) / kNT;
    const T* rsrc[nrole];
    size_t rstride[nrole];
    int roff[nrole];
    bool rwide[nrole];
#pragma unroll
    for (int m = 0; m < nrole; ++m) {
        const int e = tid + m * kNT;
        rsrc[m] = nullptr;
        rstride[m] = P;
        roff[m] = 0;
        rwide[m] = V && e < nsc + nbc;
        if (e < nsc) {
            const int w = e / cpr, c = (e % cpr) * cw;
            roff[m] = w * S::ps + S::e16 + c;
            if (w < rows + 2 && c < cols)
                rsrc[m] = p + (size_t)row_of(w) * g.nx + i0 + c;
        } else if (e < nsc + nbc) {
            const int w = (e - nsc) / cpr, c = ((e - nsc) % cpr) * cw;
            roff[m] = S::state + w * kTI + c;
            if (w < rows && c < cols)
                rsrc[m] = b + (size_t)(j0 + w) * g.nx + i0 + c;
        } else if (e < nst) {
            const int h = e - nsc - nbc, w = h % (kTJ + 2);
            const size_t row = row_of(w);
            if (h < kTJ + 2) {                // west: column -1
                roff[m] = w * S::ps + S::e16 - 1;
                if (i0 > 0) {
                    rsrc[m] = p + row * g.nx + i0 - 1;
                } else if (pw) {
                    rsrc[m] = pw + row * nxw + nxw - 1;
                    rstride[m] = (size_t)g.ny * nxw;
                } else {
                    rsrc[m] = p + row * g.nx;
                }
            } else {                          // east: column cols
                roff[m] = w * S::ps + S::e16 + cols;
                if (i0 + cols < g.nx) {
                    rsrc[m] = p + row * g.nx + i0 + cols;
                } else if (pe) {
                    rsrc[m] = pe + row * nxe;
                    rstride[m] = (size_t)g.ny * nxe;
                } else {
                    rsrc[m] = p + row * g.nx + g.nx - 1;
                }
            }
            if (w >= rows + 2) rsrc[m] = nullptr;
        }
    }
    const uint32_t sbase = smem_addr(sm);

    const auto stage = [&](int k) {
        const uint32_t s =
            sbase + (uint32_t)(((unsigned)k % S::n) * S::size * sizeof(T));
        const T* ck = cA + (size_t)k * EP;
#pragma unroll
        for (int m = 0; m < kBandIters; ++m)
            if (goff[m] != ~0u)
                cp_async<sizeof(T)>(
                    s + (uint32_t)((S::state + S::rhs + tid + m * kNT)
                                   * sizeof(T)),
                    ck + goff[m]);
#pragma unroll
        for (int m = 0; m < nrole; ++m) {
            if (rsrc[m] == nullptr) continue;
            const uint32_t d = s + (uint32_t)(roff[m] * (int)sizeof(T));
            const T* src = rsrc[m] + (size_t)k * rstride[m];
            if (rwide[m])
                cp_async<16>(d, src);
            else
                cp_async<sizeof(T)>(d, src);
        }
    };

    const int c = threadIdx.x, jr = threadIdx.y;
    const bool act = jr < rows && c < cols;
    const int j = j0 + jr, i = i0 + c;
    // the two plane-0 'real' band values off the windows: band(4, 0, j, i,
    // -1, 1) and band(7, 0, j, i, 1, 1)
    T b4 = T(0), b7 = T(0);
    if (act && real) {
        b4 = cA[(size_t)4 * g.nz * EP + (size_t)j * ex + i + 2];
        b7 = cA[(size_t)7 * g.nz * EP + (size_t)(j + 2) * ex + i + 2];
    }

    constexpr int ahead = S::n - 3;           // planes in flight past k+1
#pragma unroll
    for (int q = 0; q <= ahead; ++q) {
        if (q < g.nz) stage(q);
        cp_commit();
    }
    for (int k = 0; k < g.nz; ++k) {
        cp_wait<ahead - 1>();                 // planes <= k+1 landed
        // ... for every thread, and every thread is past plane k-1, so
        // plane k-2's slot takes plane k+1+ahead
        __syncthreads();
        if (k + 1 + ahead < g.nz) stage(k + 1 + ahead);
        cp_commit();
        if (!act) continue;
        // state at (k+dk, j+dj, i+di); 0 off the planes (stencil.shift)
        const auto st = [&](int dk, int dj, int di) -> T {
            const int kk = k + dk;
            if (kk < 0 || kk >= g.nz) return T(0);
            return sm[((unsigned)kk % S::n) * S::size + (jr + 1 + dj) * S::ps
                      + S::e16 + c + di];
        };
        // band n at plane k+dk, column (j+dj, i+di)
        const auto bd = [&](int n, int dk, int dj, int di) -> T {
            const int kk = k + dk;
            if (kk < 0 || kk >= g.nz) return T(0);
            return sm[((unsigned)kk % S::n) * S::size + S::state + S::rhs
                      + n * kBW + (jr + dj) * kBP + c + di];
        };
        T s = bd(2, 0, 0, 0) * st(1, -1, 0);
        s = s + bd(2, -1, 1, 0) * st(-1, 1, 0);
        s = s + bd(3, 0, 0, 0) * st(0, -1, 0);
        s = s + bd(3, 0, 1, 0) * st(0, 1, 0);
        s = s + bd(4, 0, 0, 0) * st(-1, -1, 0);
        s = s + bd(4, 1, 1, 0) * st(1, 1, 0);
        s = s + bd(5, 0, 0, 0) * st(1, 0, -1);
        s = s + bd(5, -1, 0, 1) * st(-1, 0, 1);
        s = s + bd(6, 0, 0, 0) * st(0, 0, -1);
        s = s + bd(6, 0, 0, 1) * st(0, 0, 1);
        s = s + bd(7, 0, 0, 0) * st(-1, 0, -1);
        s = s + bd(7, 1, 0, 1) * st(1, 0, 1);
        if (real && k == 0) {
            T x0 = bd(4, 0, 0, 0) * st(0, 1, -1);
            x0 = x0 + b4 * st(0, -1, 1);
            x0 = x0 + bd(7, 0, 0, 0) * st(0, -1, -1);
            x0 = x0 + b7 * st(0, 1, 1);
            s = s + x0;
        }
        const T bv = sm[((unsigned)k % S::n) * S::size + S::state + jr * kTI
                        + c];
        r[(size_t)k * P + (size_t)j * g.nx + i] =
            bv - bd(0, 0, 0, 0) * st(0, 0, 0) - bd(1, 0, 0, 0) * st(-1, 0, 0)
            - bd(1, 1, 0, 0) * st(1, 0, 0) - s;
    }
}

// the 16-byte instance for p and b rows of nx values at these pointers
template <typename T>
bool vec_rows(const void* p, const void* b, int nx) {
    return (nx * sizeof(T)) % 16 == 0
           && (reinterpret_cast<uintptr_t>(p) % 16) == 0
           && (reinterpret_cast<uintptr_t>(b) % 16) == 0;
}

template <typename T, bool V>
int launch_instance(const void* p, const void* pw, const void* pe,
                    const void* b, const void* cA, void* r, const Level& g,
                    int nxw, int nxe, int real, cudaStream_t s) {
    const int e = kernel_attributes((const void*)overlap_kernel<T, V>,
                                    Slot<T>::bytes, false);
    if (e != 0) return e;
    const int nbx = (g.nx + kTI - 1) / kTI, nby = (g.ny + kTJ - 1) / kTJ;
    overlap_kernel<T, V><<<nbx * nby, dim3(kTI, kTJ), Slot<T>::bytes, s>>>(
        (const T*)p, (const T*)pw, (const T*)pe, (const T*)b, (const T*)cA,
        (T*)r, g, nxw, nxe, real, nbx, nby);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* p, const void* pw, const void* pe, const void* b,
           const void* cA, void* r, int nz, int ny, int nx, int nxw, int nxe,
           int real, void* stream) {
    const Level g{nz, ny, nx};
    // the band copies' offsets are 32-bit
    if ((size_t)8 * nz * g.eplane() >= ((size_t)1 << 32))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return vec_rows<T>(p, b, nx)
               ? launch_instance<T, true>(p, pw, pe, b, cA, r, g, nxw, nxe,
                                          real, s)
               : launch_instance<T, false>(p, pw, pe, b, cA, r, g, nxw, nxe,
                                           real, s);
}

template <typename T, bool V>
int plan(int ny, int nx, int* out) {
    const int e = kernel_attributes((const void*)overlap_kernel<T, V>,
                                    Slot<T>::bytes, false);
    if (e != 0) return e;
    int per_sm = 0;
    const cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, overlap_kernel<T, V>, kNT, Slot<T>::bytes);
    if (q != cudaSuccess) return (int)q;
    out[0] = kTJ;
    out[1] = kTI;
    out[2] = Slot<T>::n;
    out[3] = (int)Slot<T>::bytes;
    out[4] = ((nx + kTI - 1) / kTI) * ((ny + kTJ - 1) / kTJ);
    out[5] = per_sm;
    return 0;
}

template <typename T>
int plan(int ny, int nx, int* out) {
    return vec_rows<T>(nullptr, nullptr, nx) ? plan<T, true>(ny, nx, out)
                                             : plan<T, false>(ny, nx, out);
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

// K7's launch plan for a (ny, nx) tile of itemsize elem (4 or 8) at
// aligned pointers: out = tile rows, tile columns, ring slots, shared
// memory bytes a block, blocks, blocks resident an SM
int mg_residual_overlap_x_plan(int elem, int ny, int nx, int* out) {
    if (elem == 4) return plan<float>(ny, nx, out);
    if (elem == 8) return plan<double>(ny, nx, out);
    return (int)cudaErrorInvalidValue;
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
