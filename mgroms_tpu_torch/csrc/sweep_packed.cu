// The packed-stream colour-fused red-black sweep (K8) and its stream packer
// (K9) for Hopper (sm_90a).
//
//   sweep_packed  <- mgroms_tpu/ops/pallas/sweep_packed.py:_sweep_chunk
//                    (body _kernel)
//   pack_streams  <- sweep_packed.py:_pack_streams (body _pack_kernel)
//
// Each computes, term for term and in the same operation order, what its
// plain version in mgroms_tpu_torch/ops/kernels/sweep_packed.py computes
// (sweep_chunk_plain, pack_streams_plain).
//
// K9 is a copy: every element of the C per-chunk tile-major streams
// (ntiles, nslabs*nz, rows, width) is read once from the full-width padded
// arrays and written once.  One block per output row, threads along the
// row (coalesced reads and writes); bound: memory.
//
// K8 computes one whole RB sweep of one lane chunk from the six packed
// streams (bands, pivots, seam pivots, RHS, seam RHS, state) into the four
// interior chunk quads, colour 0 then colour 1, in ONE ordinary launch.
// Design: a block owns the columns [c0, c0+32) of one row tile [J0, J0+TJ)
// (grid: column groups x tiles).  Phase 0 recomputes the colour-0 quads on
// the tile's rows plus one row each side (the TPU kernel's overhang) and
// on one column more: (0,0) on columns [c0, c0+32], (1,1) on [c0-1,
// c0+32), the only neighbours colour 1 reads.  A neighbouring block
// recomputes the same columns, bitwise identically, so no grid barrier is
// needed (K4 uses a cooperative launch instead).  The overhang's Thomas
// solve runs in place, so it cannot go to the shared outputs (two blocks
// would race): each block has a PRIVATE colour-0 store in device memory
// (2 x nz x (TJ+2) x 34 values, written and read back by the same block),
// chosen over shared memory, which at nz = 64 would hold it only for
// TJ <= 8 in float32 and TJ <= 4 in float64.  At nz = 64, TJ 8, float32 a
// store is 174 KB, a (512, 512) launch fills 178 MB, and at three resident
// blocks per SM about 69 MB is live, more than the 50 MB L2 cache: how
// much of the store's traffic reaches device memory is not measured.
// Phase 1 (after __syncthreads) updates (0,1) and (1,0) on the block's
// columns, reading the colour-0 values from that store.  Which values the
// halo reads take follows the TPU kernel's patches (e1 below): the
// physical edges and the first/last tile rows read the pre-sweep mirror
// values of the packed state; the 'real' sibling's ring reads colour-0
// values.  Lane-chunk seams (columns I0-1 / I0+WC) are recomputed from the
// seam pivot/RHS streams.
//
// Bound: memory.  The packed streams duplicate the tile overhang rows
// ((TJ+4)/TJ on the bands) and the colour-0 overhang adds 2/TJ + 1/32 of
// colour-0 work.  One thread per column, looping over z; 16 terms per
// plane, ~2 flops per value read.
//
// Instances: (float, float), (double, double) and (float, bfloat16 bands,
// upcast at read).  Rounding: built with -fmad=false (0 ulp from the plain
// version).
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the launch's CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "quad_terms.cuh"

// The streams of one chunk (sweep_packed.SweepOperator, pack_rhs,
// pack_state), the four output quads in _TKEYS order and the blocks'
// colour-0 store.
struct SweepPackedArgs {
    const void* pst;
    const void* pband;
    const void* ppiv;
    const void* pseam;
    const void* pbq;
    const void* pqs;
    void* out[4];
    void* scratch;
};

// K9's arrays and the per-chunk output streams.
struct PackArgs {
    const void* src[8];
    void* dst[64];
};

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;         // chunk columns per block (BLOCK_COLS)

// One gather term of one target (sweep_packed.term_rows): band slab bs at
// plane k+bk, row y+rjb, column x+rib; state quad q at plane k+pk, row
// y+rj, column x+ri.
struct PTerm {
    int bs, bk, rjb, rib, q, pk, rj, ri;
};

template <typename T, typename B>
struct Chunk {
    const T* st;      // this tile's packed state (4*nz, TJ+4, WC+4)
    const B* band;    // (24*nz, TJ+4, WC+3)
    const T* piv;     // (12*nz, TJ+2, WC)
    const T* seam;    // (6*nz, TJ+2, 2)
    const T* rhs;     // (4*nz, TJ+2, WC)
    const T* rseam;   // (2*nz, TJ+2, 2)
    T* out[4];        // (nz, H, WC)
    T* scr;           // this block's colour-0 store (2, nz, TJ+2, kCols+2)
    int nz, tj, wc, H, J0, c0, ce, real, first_chunk, last_chunk;

    // quad rows y and chunk columns x below are absolute (row J0 is the
    // tile's first row, column 0 the chunk's first column)
    __device__ T state(int q, int k, int y, int x) const {
        return st[((size_t)(q * nz + k) * (tj + 4) + (y - J0 + 2)) * (wc + 4)
                  + (x + 2)];
    }
    __device__ T bandv(int s, int k, int y, int x) const {
        return up(band[((size_t)(s * nz + k) * (tj + 4) + (y - J0 + 2))
                       * (wc + 3) + (x + 1)]);
    }
    // field 0 bet, 1 gam, 2 ud of pivot target pt (_PTARGETS order), at
    // column x, or at seam column ci (0: I0-1, 1: I0+WC) of colour-0
    // target pt when ci >= 0
    __device__ T pivv(int pt, int f, int k, int y, int x, int ci) const {
        const size_t r = (size_t)((pt * 3 + f) * nz + k) * (tj + 2)
                         + (y - J0 + 1);
        return ci < 0 ? piv[r * wc + x] : seam[r * 2 + ci];
    }
    __device__ T rhsv(int m, int k, int y, int x, int ci) const {
        const size_t r = (size_t)(m * nz + k) * (tj + 2) + (y - J0 + 1);
        return ci < 0 ? rhs[r * wc + x] : rseam[r * 2 + ci];
    }
    __device__ T* scrp(int qi, int k, int y, int x) const {
        return scr + ((size_t)(qi * nz + k) * (tj + 2) + (y - J0 + 1))
                         * (kCols + 2) + (x - c0 + 1);
    }
    // Colour 1's view of quad q (_TKEYS index) at (k, y, x): the e1 tiles
    // of sweep_packed.py:448-498 by index.  Colour-0 quads: the block's
    // store, except the pre-sweep mirror values on the physical edges
    // ((1,1) at row -1 and, in the first chunk, column -1; (0,0) at row H
    // and, in the last chunk, column WC).  The colour-1 'real' siblings:
    // the pre-sweep state, except their mirror ring, which reads colour-0
    // values ((1,0) at row -1 and, in the last chunk, column WC; (0,1) at
    // row H and, in the first chunk, column -1).
    __device__ T e1(int q, int k, int y, int x) const {
        if (q == 2) {
            if (y == -1) {
                q = 0;
                y = 0;
            } else if (last_chunk && x == wc) {
                q = 3;
                x = wc - 1;
            } else {
                return state(2, k, y, x);
            }
        } else if (q == 1) {
            if (y == H) {
                q = 3;
                y = H - 1;
            } else if (first_chunk && x == -1) {
                q = 0;
                x = 0;
            } else {
                return state(1, k, y, x);
            }
        }
        if (q == 0) {
            if (y == H || (last_chunk && x == wc)) return state(0, k, y, x);
            return *scrp(0, k, y, x);
        }
        if (y == -1 || (first_chunk && x == -1)) return state(3, k, y, x);
        return *scrp(1, k, y, x);
    }
};

// The off-column coupling sum of target tt at (k, y, x): the 12 base terms
// in order, then on plane 0 the 4 'real' terms summed apart and added.
// Phase 0 reads the packed state, phase 1 the e1 view.
template <bool P1, typename T, typename B>
__device__ __forceinline__ T gather(const Chunk<T, B>& c, const PTerm* tt,
                                    int k, int y, int x) {
    auto term = [&](int m) -> T {
        const PTerm& p = tt[m];
        const int kb = k + p.bk, kp = k + p.pk;
        const T b = (kb < 0 || kb >= c.nz)
                        ? T(0) : c.bandv(p.bs, kb, y + p.rjb, x + p.rib);
        const T v = (kp < 0 || kp >= c.nz)
                        ? T(0)
                        : (P1 ? c.e1(p.q, kp, y + p.rj, x + p.ri)
                              : c.state(p.q, kp, y + p.rj, x + p.ri));
        return b * v;
    };
    T s = term(0);
#pragma unroll
    for (int m = 1; m < kBaseKeys; ++m) s = s + term(m);
    if (c.real && k == 0) {
        T x0 = term(kBaseKeys);
#pragma unroll
        for (int m = kBaseKeys + 1; m < kTerms; ++m) x0 = x0 + term(m);
        s = s + x0;
    }
    return s;
}

// One column solve of target t (_TKEYS index) at (y, x): gather, then the
// factored Thomas substitution with the packed bet/gam/ud into `col`
// (stride `cs` per plane), forward values first, back substitution in
// place.  ci >= 0: a seam column (pivots and RHS from the seam streams).
template <bool P1, typename T, typename B>
__device__ __forceinline__ void solve(const Chunk<T, B>& c, const PTerm* tt,
                                      int t, int y, int x, int ci, T* col,
                                      size_t cs) {
    // pivot target index in _PTARGETS = (0,0), (1,1), (0,1), (1,0); the
    // RHS stream holds the same order; the seam streams only colour 0
    const int pt = t == 0 ? 0 : t == 3 ? 1 : t == 1 ? 2 : 3;
    T xk = T(0);
    for (int k = 0; k < c.nz; ++k) {
        const T r = c.rhsv(pt, k, y, x, ci) - gather<P1>(c, tt, k, y, x);
        const T bet = c.pivv(pt, 0, k, y, x, ci);
        xk = k == 0 ? r * bet
                    : (r - c.pivv(pt, 2, k - 1, y, x, ci) * xk) * bet;
        col[k * cs] = xk;
    }
    for (int k = c.nz - 2; k >= 0; --k) {
        xk = col[k * cs] - c.pivv(pt, 1, k, y, x, ci) * xk;
        col[k * cs] = xk;
    }
}

template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
sweep_packed_kernel(const SweepPackedArgs a, int nz, int ntiles, int tj,
                    int wc, int real, int first_chunk, int last_chunk,
                    const PTerm* __restrict__ terms) {
    __shared__ PTerm s_tt[4 * kTerms];
    for (int i = threadIdx.x; i < (int)(4 * kTerms * sizeof(PTerm) / 4);
         i += blockDim.x) {
        reinterpret_cast<int*>(s_tt)[i] =
            reinterpret_cast<const int*>(terms)[i];
    }
    const int tile = blockIdx.y;
    Chunk<T, B> c;
    c.st = static_cast<const T*>(a.pst)
           + (size_t)tile * 4 * nz * (tj + 4) * (wc + 4);
    c.band = static_cast<const B*>(a.pband)
             + (size_t)tile * 24 * nz * (tj + 4) * (wc + 3);
    c.piv = static_cast<const T*>(a.ppiv)
            + (size_t)tile * 12 * nz * (tj + 2) * wc;
    c.seam = static_cast<const T*>(a.pseam)
             + (size_t)tile * 6 * nz * (tj + 2) * 2;
    c.rhs = static_cast<const T*>(a.pbq)
            + (size_t)tile * 4 * nz * (tj + 2) * wc;
    c.rseam = static_cast<const T*>(a.pqs)
              + (size_t)tile * 2 * nz * (tj + 2) * 2;
    for (int i = 0; i < 4; ++i) c.out[i] = static_cast<T*>(a.out[i]);
    c.scr = static_cast<T*>(a.scratch)
            + ((size_t)tile * gridDim.x + blockIdx.x) * 2 * nz * (tj + 2)
                  * (kCols + 2);
    c.nz = nz;
    c.tj = tj;
    c.wc = wc;
    c.H = ntiles * tj;
    c.J0 = tile * tj;
    c.c0 = blockIdx.x * kCols;
    c.ce = min(c.c0 + kCols, wc);
    c.real = real;
    c.first_chunk = first_chunk;
    c.last_chunk = last_chunk;
    __syncthreads();

    const size_t P = (size_t)c.H * wc;          // output plane
    const size_t SP = (size_t)(tj + 2) * (kCols + 2);   // store plane
    // phase 0: (0,0) on columns [c0, ce], (1,1) on [c0-1, ce), rows
    // [J0-1, J0+TJ]; the physical mirror cells are not computed (e1 reads
    // them from the state)
    const int ncol = c.ce - c.c0 + 1;
    const int n0 = 2 * (tj + 2) * ncol;
    for (int i = threadIdx.x; i < n0; i += blockDim.x) {
        const int qi = i / ((tj + 2) * ncol);
        const int rem = i % ((tj + 2) * ncol);
        const int y = c.J0 - 1 + rem / ncol;
        const int x = (qi == 0 ? c.c0 : c.c0 - 1) + rem % ncol;
        if (qi == 0 ? (y == c.H || (last_chunk && x == wc))
                    : (y == -1 || (first_chunk && x == -1))) {
            continue;
        }
        const int t = qi == 0 ? 0 : 3;
        const int ci = x == -1 ? 0 : x == wc ? 1 : -1;
        T* col = c.scrp(qi, 0, y, x);
        solve<false>(c, s_tt + t * kTerms, t, y, x, ci, col, SP);
        if (y >= c.J0 && y < c.J0 + tj && x >= c.c0 && x < c.ce) {
            T* o = c.out[t] + (size_t)y * wc + x;
            for (int k = 0; k < nz; ++k) o[k * P] = col[k * SP];
        }
    }
    // every colour-0 value of the store is written and visible block-wide
    __syncthreads();
    // phase 1: (0,1) and (1,0) on rows [J0, J0+TJ) x columns [c0, ce)
    const int w = c.ce - c.c0;
    const int n1 = 2 * tj * w;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) {
        const int t = i < tj * w ? 1 : 2;
        const int rem = i % (tj * w);
        const int y = c.J0 + rem / w;
        const int x = c.c0 + rem % w;
        solve<true>(c, s_tt + t * kTerms, t, y, x, -1,
                    c.out[t] + (size_t)y * wc + x, P);
    }
}

template <typename T, typename B>
int launch_sweep_packed(const SweepPackedArgs* a, int nz, int ntiles, int tj,
                        int wc, int real, int first_chunk, int last_chunk,
                        const void* terms, void* stream) {
    if (nz < 2 || ntiles < 1 || ntiles > 65535 || tj < 1 || wc < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((wc + kCols - 1) / kCols, ntiles);
    sweep_packed_kernel<T, B><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        *a, nz, ntiles, tj, wc, real, first_chunk, last_chunk,
        static_cast<const PTerm*>(terms));
    return (int)cudaGetLastError();
}

// K9: output row R of the C streams (chunk, tile, slab plane, row) per
// block iteration, its `width` elements over the threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const PackArgs a, int S, int C, int nz, int Hp, int Wp, int tj,
            int rows, int wc, int wpad, int ntiles) {
    const int width = wpad < 0 ? 2 : wc + wpad;
    const long long per = (long long)ntiles * S * nz * rows;
    for (long long R = blockIdx.x; R < per * C; R += gridDim.x) {
        const int ch = (int)(R / per);
        long long o = R % per;
        const int r = (int)(o % rows);
        const int sk = (int)((o / rows) % (S * nz));
        const int tile = (int)(o / ((long long)rows * S * nz));
        const int s = sk / nz, k = sk % nz;
        const T* src = static_cast<const T*>(a.src[s])
                       + ((size_t)k * Hp + (size_t)tile * tj + r) * Wp;
        T* dst = static_cast<T*>(a.dst[ch]) + (size_t)o * width;
        for (int w = threadIdx.x; w < width; w += blockDim.x) {
            const int col = wpad < 0 ? (w == 0 ? ch * wc : ch * wc + wc + 1)
                                     : ch * wc + w;
            dst[w] = src[col];
        }
    }
}

template <typename T>
int launch_pack(const PackArgs* a, int S, int C, int nz, int Hp, int Wp,
                int tj, int rows, int wc, int wpad, int ntiles,
                void* stream) {
    if (S < 1 || S > 8 || C < 1 || C > 64 || ntiles < 1)
        return (int)cudaErrorInvalidValue;
    const long long nrows = (long long)C * ntiles * S * nz * rows;
    const int grid = (int)(nrows < 132LL * 64 ? nrows : 132LL * 64);
    pack_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *a, S, C, nz, Hp, Wp, tj, rows, wc, wpad, ntiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_sweep_packed_f32(const SweepPackedArgs* a, int nz, int ntiles, int tj,
                        int wc, int real, int first_chunk, int last_chunk,
                        const void* terms, void* stream) {
    return launch_sweep_packed<float, float>(a, nz, ntiles, tj, wc, real,
                                             first_chunk, last_chunk, terms,
                                             stream);
}

int mg_sweep_packed_f64(const SweepPackedArgs* a, int nz, int ntiles, int tj,
                        int wc, int real, int first_chunk, int last_chunk,
                        const void* terms, void* stream) {
    return launch_sweep_packed<double, double>(a, nz, ntiles, tj, wc, real,
                                               first_chunk, last_chunk,
                                               terms, stream);
}

int mg_sweep_packed_bf16(const SweepPackedArgs* a, int nz, int ntiles,
                         int tj, int wc, int real, int first_chunk,
                         int last_chunk, const void* terms, void* stream) {
    return launch_sweep_packed<float, __nv_bfloat16>(
        a, nz, ntiles, tj, wc, real, first_chunk, last_chunk, terms, stream);
}

int mg_pack_streams_f32(const PackArgs* a, int S, int C, int nz, int Hp,
                        int Wp, int tj, int rows, int wc, int wpad,
                        int ntiles, void* stream) {
    return launch_pack<float>(a, S, C, nz, Hp, Wp, tj, rows, wc, wpad,
                              ntiles, stream);
}

int mg_pack_streams_f64(const PackArgs* a, int S, int C, int nz, int Hp,
                        int Wp, int tj, int rows, int wc, int wpad,
                        int ntiles, void* stream) {
    return launch_pack<double>(a, S, C, nz, Hp, Wp, tj, rows, wc, wpad,
                               ntiles, stream);
}

}  // extern "C"
