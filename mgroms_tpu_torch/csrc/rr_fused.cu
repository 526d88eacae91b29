// K3 for Hopper (sm_90a): the fresh residual of a quad-parity level, all
// four target quads in one launch, as the down-leg's coarse RHS
// restrict(b - A p), as chosen targets' z-pair sums, or as the residual
// quads themselves.
//
// Replaces mgroms_tpu/ops/pallas/relax_tiled.py:_rr_one, which
// residual_restrict_tiled_quads (:426) launches once per target quad, and
// gives the level-0 residual of relax_compact.residual_quads (:615, XLA
// glue in the JAX package) a kernel.  It computes, term for term and in
// the same operation order, what its plain version (ops/kernels/
// relax_tiled.residual_restrict_plain) computes: per target quad,
// r = bq - d p - lo p_- - hi p_+ - g with the 12-term gather g (14 with
// 'real', the plane-0 terms summed into x0 and added last,
// relax_compact.gather_blocks), then the z-pair sums r_2K + r_2K+1, and
// for the coarse RHS the four targets' sums added as
// (zs00 + zs10) + (zs01 + zs11) (transfer.restrict_3d's tree).
//
// What bounds it: memory.  Per column and plane it reads the operator (12
// values a target), the state and the column's RHS, d and ud, and does
// ~2 flops per value read.  The design:
//
// - One launch for the four targets.  A block owns a tile of kRows x
//   kCols quad columns of all four target quads, one thread per (J, I),
//   and computes the four targets' residuals there, so the coarse RHS is
//   summed in registers and written once (no per-target outputs, no adds
//   after).  K3 has no colour dependence, so nothing stops one launch
//   from reading each operator value once from device memory, which K4
//   cannot across its grid barrier.
// - The operator in the layout the level holds it (compile-time BANDS):
//   the 24 halo-extended band quads (relax_compact.band_quads, the levels
//   K4 smooths), or the 48 gather blocks (the K1-K2 route's levels and the
//   tiles of a distributed level).  Either is read in place, coalesced
//   along I.  A band-quad value serves two terms, of two targets at two
//   planes (bk); its second read comes a plane after the first, from the
//   same tile, and is served by L1/L2, so device memory sees it once.
//   Staging the band tiles in a shared-memory ring instead (16-byte
//   cp.async spans of the stack's rows, each value staged once) measured
//   slower on the H100 at every ring depth and tile tried (PERF.md).
// - The four state windows are staged over k (cp.async, LDGSTS, 4-byte
//   copies through L1): while plane k is computed, plane k + 1 + kAhead is
//   in flight into a ring of kStages planes of (kRows + 2) x (kCols + 2)
//   values of each extended quad; each staged value serves up to 12 terms
//   of four targets at three planes.  One block barrier a plane.  The
//   column's RHS, d and ud are loaded a plane ahead into registers.
// - The plane-0 'real' couplings (4 terms a target, one plane) read their
//   operator values in place and their state from the window.
//
// Rounding: built with -fmad=false (0 ulp from the plain version).
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the launch's CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_terms.cuh"

// Pointers of one launch, per quad in _TKEYS order (0,0), (0,1), (1,0),
// (1,1): the extended state quads (nz, H+2, W+2), the RHS, d, ud, the
// outputs (the coarse RHS in out[0]; a masked-out target's is unused),
// the gather blocks and the 'real' pairs (gather-block layout), and the
// start of the band stack's storage (band layout: 24 band quads x
// (nz + 2) planes x (H + 2) rows of `pitch` values, extended column C at
// storage column C + 16 / sizeof(value) - 1, relax_compact.band_layout).
struct RRArgs {
    const void* e[4];
    const void* bq[4];
    const void* d[4];
    const void* ud[4];
    void* out[4];
    const void* blocks[4];
    const void* rb[4];
    const void* band;
};

namespace {

constexpr int kCoarse = 0;     // the coarse RHS of all four targets
constexpr int kZsum = 1;       // per chosen target: its z-pair sums
constexpr int kResidual = 2;   // per chosen target: its residual

constexpr int kCols = kBandTile;   // the band stack's column tile
constexpr int kRows = 4;
constexpr int kThreads = kCols * kRows;
constexpr int kWW = kCols + 2;     // window row: the tile's columns + halo
constexpr int kWR = kRows + 2;     // window rows a quad
constexpr int kAhead = 2;          // planes staged ahead of the last read
// ring planes live at once: k - 2 .. k + 1 + kAhead (a block barrier a
// plane, and a slot is refilled before the barrier that retires its
// last reader)
constexpr int kStages = kAhead + 4;
constexpr int kWinVals = 4 * kWR * kWW;
// the 'real' pair's gather_keys(True) index per 'real' term (12..15)
__host__ __device__ constexpr int real_block(int m) {
    return m == 12 ? 4 : (m == 13 ? 12 : (m == 14 ? 10 : 13));
}

// values of one ring plane: the four state windows, a 16-byte multiple
template <typename T>
__host__ __device__ constexpr int stage_vals() {
    return (kWinVals * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest kAhead groups landed
__device__ __forceinline__ void cp_wait_ahead() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
struct Params {
    const T* e[4];
    const T* bq[4];
    const T* d[4];
    const T* ud[4];
    T* out[4];
    const T* blocks[4];
    const T* rb[4];
    const T* band;
    int nz, H, W, real, mask;
};

// x[i] for a runtime i without indexing a parameter array (which would be
// copied to local memory)
template <typename P>
__device__ __forceinline__ P pick(P const (&x)[4], int i) {
    return i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
}

// What a thread carries from plane to plane for one target: the column's
// RHS, d and ud of this plane and the next, ud of the plane before, and
// the even plane's residual of a z-pair.
template <typename T>
struct Column {
    T bq, d, ud, nbq, nd, nud, udlo, reven;
};

// The residual of target quad TG at plane k for the thread's column
// (jj, ii) of the tile: `ring(kk)` is the window ring's plane kk.
template <typename T, bool BANDS, int TG, typename Ring>
__device__ __forceinline__ T residual(const Params<T>& p, const Ring& ring,
                                      const Column<T>& c, int k, int jj,
                                      int ii, int J, int I) {
    using L = BandLayout<T>;
    const T* w0 = ring(k - 1);
    const T* w1 = ring(k);
    const T* w2 = ring(k + 1);
    const T* win[3] = {w0, w1, w2};
    const int wt = jj * kWW + ii;
    const int own = (TG * kWR + 1) * kWW + 1 + wt;
    const T pv = w1[own], pm = w0[own], pp = w2[own];
    const T lo = c.udlo;
    const T hi = k < p.nz - 1 ? c.ud : T(0);
    const size_t wrow = (size_t)kBaseKeys * p.W;
    const int pitch = L::pitch(p.W);
    const uint32_t PB = (uint32_t)(p.H + 2) * pitch;
    // a band value at plane k + bk, extended row J + bj, column I + bi
    auto band = [&](const Term& tm) -> T {
        return __ldg(p.band + ((uint32_t)tm.band * (p.nz + 2) + k + tm.bk
                               + 1) * PB
                     + (uint32_t)(J + tm.bj) * pitch + L::lpad + I + tm.bi);
    };
    const T* brow = BANDS ? nullptr
        : p.blocks[TG] + ((size_t)k * p.H + J) * wrow + I;
    auto value = [&](auto mi) -> T {
        constexpr int m = decltype(mi)::value;
        constexpr Term tm = term_of(TG, m);
        const T bv = BANDS ? band(tm) : __ldg(brow + (size_t)m * p.W);
        return bv * win[tm.dk + 1][(tm.src * kWR + tm.oj) * kWW + tm.oi
                                   + wt];
    };
    T g = value(Int<0>{});
    g = g + value(Int<1>{});
    g = g + value(Int<2>{});
    g = g + value(Int<3>{});
    g = g + value(Int<4>{});
    g = g + value(Int<5>{});
    g = g + value(Int<6>{});
    g = g + value(Int<7>{});
    g = g + value(Int<8>{});
    g = g + value(Int<9>{});
    g = g + value(Int<10>{});
    g = g + value(Int<11>{});
    if (p.real && k == 0) {
        // the plane-0 'real' couplings
        T x0 = T(0);
#pragma unroll
        for (int m = kBaseKeys; m < kTerms; ++m) {
            const Term tm = term_of(TG, m);
            T bv;
            if (BANDS) {
                bv = band(tm);
            } else {
                const int b = real_block(m);
                bv = b < kBaseKeys
                    ? p.blocks[TG][(size_t)J * wrow + (size_t)b * p.W + I]
                    : p.rb[TG][(size_t)J * 2 * p.W
                               + (size_t)(b - kBaseKeys) * p.W + I];
            }
            const T tv = bv * w1[(tm.src * kWR + tm.oj) * kWW + tm.oi + wt];
            x0 = (m == kBaseKeys) ? tv : x0 + tv;
        }
        g = g + x0;
    }
    return c.bq - c.d * pv - lo * pm - hi * pp - g;
}

// The output of target TG at plane k: its residual, or at an odd plane its
// z-pair sum; the coarse RHS is written by the caller.
template <typename T, int MODE, int TG>
__device__ __forceinline__ void emit(const Params<T>& p, Column<T>& c, T r,
                                     int k, size_t col, T* zs) {
    const size_t P = (size_t)p.H * p.W;
    if (MODE == kResidual) {
        p.out[TG][(size_t)k * P + col] = r;
    } else if (k & 1) {
        const T z = c.reven + r;
        if (MODE == kZsum)
            p.out[TG][(size_t)(k / 2) * P + col] = z;
        else
            zs[TG] = z;
    } else {
        c.reven = r;
    }
}

template <typename T, bool BANDS, int MODE>
__global__ void __launch_bounds__(kThreads) rr_kernel(const Params<T> p) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int svals = stage_vals<T>();
    const int nz = p.nz, H = p.H, W = p.W;
    const int tid = threadIdx.x, jj = tid / kCols, ii = tid % kCols;
    const int tiles_i = (W + kCols - 1) / kCols;
    const int J0 = (blockIdx.x / tiles_i) * kRows;
    const int I0 = (blockIdx.x % tiles_i) * kCols;
    const int J = J0 + jj, I = I0 + ii;
    const bool active = J < H && I < W;
    const size_t P = (size_t)H * W;
    const size_t EP = (size_t)(H + 2) * (W + 2);
    const size_t col = active ? (size_t)J * W + I : 0;
    T* const base = reinterpret_cast<T*>(smem);
    auto ring = [&](int kk) -> T* {
        return base + (size_t)((kk + kStages) % kStages) * svals;
    };

    // this thread's share of a plane's four state windows (-1: outside
    // the extended quad, never read)
    constexpr int kWinSlots = (kWinVals + kThreads - 1) / kThreads;
    const T* wsrc[kWinSlots];
#pragma unroll
    for (int i = 0; i < kWinSlots; ++i) {
        const int e = tid + i * kThreads;
        wsrc[i] = nullptr;
        if (e < kWinVals) {
            const int w = e / (kWR * kWW), r = (e / kWW) % kWR;
            const int cc = e % kWW;
            const int R = J0 + r, C = I0 + cc;
            if (R <= H + 1 && C <= W + 1)
                wsrc[i] = pick(p.e, w) + (size_t)R * (W + 2) + C;
        }
    }
    // window plane kk (-1 and nz: zeros, as _kshift pads)
    auto stage = [&](int kk) {
        if (kk > nz) return;
        T* wdst = ring(kk) + tid;
        if (kk < 0 || kk == nz) {
#pragma unroll
            for (int i = 0; i < kWinSlots; ++i)
                if (wsrc[i]) wdst[i * kThreads] = T(0);
            return;
        }
        const size_t kp = (size_t)kk * EP;
#pragma unroll
        for (int i = 0; i < kWinSlots; ++i)
            if (wsrc[i]) cp_async<sizeof(T)>(wdst + i * kThreads,
                                             wsrc[i] + kp);
    };
    Column<T> cs[4] = {};
    auto load = [&](Column<T>& c, int t, int kk) {
        if (kk >= nz) return;
        const size_t o = (size_t)kk * P + col;
        c.nbq = pick(p.bq, t)[o];
        c.nd = pick(p.d, t)[o];
        c.nud = kk < nz - 1 ? pick(p.ud, t)[o] : T(0);
    };
    auto shift = [&](Column<T>& c) {
        c.udlo = c.ud;
        c.bq = c.nbq;
        c.d = c.nd;
        c.ud = c.nud;
    };

    for (int kk = -1; kk <= kAhead; ++kk) {
        stage(kk);
        cp_commit();
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        cs[t].ud = T(0);
        cs[t].reven = T(0);
        if (active && ((p.mask >> t) & 1)) load(cs[t], t, 0);
        shift(cs[t]);       // udlo = 0: plane 0 has no lower coupling
    }
    for (int k = 0; k < nz; ++k) {
        stage(k + kAhead + 1);
        cp_commit();
        if (active) {
#pragma unroll
            for (int t = 0; t < 4; ++t)
                if ((p.mask >> t) & 1) load(cs[t], t, k + 1);
        }
        cp_wait_ahead();
        __syncthreads();
        if (!active) continue;
        T zs[4];
        if (p.mask & 1) {
            const T r = residual<T, BANDS, 0>(p, ring, cs[0], k, jj, ii, J, I);
            emit<T, MODE, 0>(p, cs[0], r, k, col, zs);
        }
        if (p.mask & 2) {
            const T r = residual<T, BANDS, 1>(p, ring, cs[1], k, jj, ii, J, I);
            emit<T, MODE, 1>(p, cs[1], r, k, col, zs);
        }
        if (p.mask & 4) {
            const T r = residual<T, BANDS, 2>(p, ring, cs[2], k, jj, ii, J, I);
            emit<T, MODE, 2>(p, cs[2], r, k, col, zs);
        }
        if (p.mask & 8) {
            const T r = residual<T, BANDS, 3>(p, ring, cs[3], k, jj, ii, J, I);
            emit<T, MODE, 3>(p, cs[3], r, k, col, zs);
        }
        if (MODE == kCoarse && (k & 1))
            p.out[0][(size_t)(k / 2) * P + col] = (zs[0] + zs[2])
                                                  + (zs[1] + zs[3]);
#pragma unroll
        for (int t = 0; t < 4; ++t) shift(cs[t]);
    }
    cp_wait_all();
}

template <typename T, bool BANDS, int MODE>
int launch_mode(const Params<T>& p, cudaStream_t s) {
    const void* kern = reinterpret_cast<const void*>(
        &rr_kernel<T, BANDS, MODE>);
    const size_t smem = (size_t)kStages * stage_vals<T>() * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (long long)((p.H + kRows - 1) / kRows)
                            * ((p.W + kCols - 1) / kCols);
    rr_kernel<T, BANDS, MODE><<<(unsigned)tiles, kThreads, smem, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_rr(const RRArgs* a, int nz, int H, int W, int real, int mask,
              int mode, int bands, void* stream) {
    if (mode < kCoarse || mode > kResidual || mask <= 0 || mask > 15
        || (mode == kCoarse && mask != 15) || nz < 2
        || (mode != kResidual && nz % 2))
        return (int)cudaErrorInvalidValue;
    Params<T> p;
    for (int i = 0; i < 4; ++i) {
        p.e[i] = static_cast<const T*>(a->e[i]);
        p.bq[i] = static_cast<const T*>(a->bq[i]);
        p.d[i] = static_cast<const T*>(a->d[i]);
        p.ud[i] = static_cast<const T*>(a->ud[i]);
        p.out[i] = static_cast<T*>(a->out[i]);
        p.blocks[i] = static_cast<const T*>(a->blocks[i]);
        p.rb[i] = static_cast<const T*>(a->rb[i]);
    }
    p.band = static_cast<const T*>(a->band);
    p.nz = nz;
    p.H = H;
    p.W = W;
    p.real = real;
    p.mask = mask;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bands) {
        if (mode == kCoarse) return launch_mode<T, true, kCoarse>(p, s);
        if (mode == kZsum) return launch_mode<T, true, kZsum>(p, s);
        return launch_mode<T, true, kResidual>(p, s);
    }
    if (mode == kCoarse) return launch_mode<T, false, kCoarse>(p, s);
    if (mode == kZsum) return launch_mode<T, false, kZsum>(p, s);
    return launch_mode<T, false, kResidual>(p, s);
}

}  // namespace

extern "C" {

int mg_rr_f32(const RRArgs* a, int nz, int H, int W, int real, int mask,
              int mode, int bands, void* stream) {
    return launch_rr<float>(a, nz, H, W, real, mask, mode, bands, stream);
}

int mg_rr_f64(const RRArgs* a, int nz, int H, int W, int real, int mask,
              int mode, int bands, void* stream) {
    return launch_rr<double>(a, nz, H, W, real, mask, mode, bands, stream);
}

}  // extern "C"
