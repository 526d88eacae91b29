// Masked z-line smoothing of a whole full-layout level (K6), in the three
// orderings of the JAX package.
//
// Replaces the Pallas TPU kernel mgroms_tpu/ops/pallas/relax_fused.py:
// fused_relax (_kernel, kinds 'RB', 'FC', 'GS'), and computes, term for
// term and in the same operation order, what ops/relax.relax(p, b, cA,
// nsweeps, kind, real, extend_fn=extend_h1) computes: nsweeps * ncolor
// colour steps (ncolor 2, 4, 1), colour 0 first; in step c every column of
// the colour gathers its couplings from the pre-step state
// (stencil15.cuh), runs the Thomas recurrence of ops/relax.tridiag, and
// commits p + (sol - p); the other columns keep p.  The colours
// (relax_fused.py:72-80):
//   RB  (j + i + c) even;
//   FC  (i % 2 == c / 2) and (j % 2 == c % 2): (i even, j even), (i even,
//       j odd), (i odd, j even), (i odd, j odd), the reference order;
//   GS  every column: the JAX package's column-Jacobi GS, every column
//       solved from the pre-sweep state (not the reference's sequential
//       sweep), still committed as p + (sol - p), which in floating point
//       is not sol.
//
// The TPU kept the whole level in VMEM for the whole call.  Three forms
// solve the same colour steps here; ops/kernels/relax_fused.py `form`
// (the gate) names one per shape, type and ordering, its thresholds from
// the card's timings of each form at every level of both cells (PERF.md):
//
//   one block   one launch per call, one block: levels up to 2x32x32
//               points (the coarsest level of every cell: 32x32x2, 4^3;
//               and 8^3 in RB and FC; GS only at nz 2 or 4).
//   cluster     one launch per call, a thread block cluster of up to 16
//               blocks (8 where 16 cannot be resident), each owning a band
//               of rows, the records in registers: float32 at nz 2 or 4
//               only (launch_resident refuses any other cluster plan;
//               with the records in shared or device memory, or in
//               float64, it lost to the step form at every level timed).
//               The gate sends RB and FC up to 4x64x64 points to it (CUC
//               level 4); GS loses there and takes the step form.
//   step        one launch per colour step: every other level.
//
// The one-launch forms (relax_resident).  Their time is not bytes or
// operations (the inputs are read once) but the ncolor * nsweeps serial
// colour steps, each a barrier and an nz-deep dependent chain (K10's
// step_floor, roofline.cu, is that floor); the design keeps everything
// that is not on that chain off it:
//
// - What is constant across the steps is computed once a call: each
//   thread owns two columns (slots) for the whole call and holds, per
//   plane, their 12 coupling coefficients, ud, the Thomas factors bet and
//   gam (ops/relax.thomas_factor, the plain version's divisions) and b,
//   and the two plane-0 'real' coefficients not among them: in registers
//   (nz 2 or 4, where they fit; always in a cluster), or in one block in
//   shared memory, or where neither holds them in device memory (L2).  A
//   step has no division (nz 1 keeps the plain version's b / d).  In one
//   block with the records in registers the columns' neighbour and
//   diagonal offsets are computed once too.
// - The state lives in shared memory, a band of rows a block; a cluster
//   block reads the rows next to its band from its neighbours' shared
//   memory (distributed shared memory), and a cluster barrier separates
//   the steps (one block: __syncthreads()).  With the records in
//   registers the state is column-major, a column's planes one vector
//   load.
// - In place, a thread per active column: RB and FC update the state in
//   place and touch only the columns of the step's colour (an active
//   column reads only columns of the other colours, and itself through
//   the edge copy before it writes).  RB's four plane-0 'real' diagonal
//   couplings join columns of its own colour: they read a snapshot of
//   plane 0, to which each thread writes its column's new value one step
//   later (no step reads a column's snapshot until its colour's next
//   turn; a diagonal clamped onto a column of the other colour reads the
//   state).  GS solves every column from the old state: two buffers (one
//   buffer and a second barrier a step measured no faster).
// - One pass over nz: the 4 neighbours' state in a 3-plane window, the
//   forward values in registers (nz 2, 4) or shared memory, then the back
//   substitution commits each plane; all of a step's loads come before
//   its stores.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "stencil15.cuh"

namespace {

// The orderings and their colour steps per sweep (the code and ncolor of
// each entry of ops/kernels/relax_fused.py KINDS).
constexpr int kRB = 0;
constexpr int kFC = 1;
constexpr int kGS = 2;

__host__ __device__ __forceinline__ int ncolors(int kind) {
    return kind == kRB ? 2 : (kind == kFC ? 4 : 1);
}

// ---------------------------------------------- the one-launch forms

// A plane record: the 16 values that are constant across the steps of one
// column at plane k, in the order the step reads them (stencil15.cuh
// offdiag's twelve coefficients, ud, bet, gam, b):
//   0 band 2 (k)          1 band 2 (k-1, j+1)   2 band 3 (k)
//   3 band 3 (k, j+1)     4 band 4 (k)          5 band 4 (k+1, j+1)
//   6 band 5 (k)          7 band 5 (k-1, i+1)   8 band 6 (k)
//   9 band 6 (k, i+1)    10 band 7 (k)         11 band 7 (k+1, i+1)
//  12 ud(k-1) = band 1 (k)   13 bet(k) (nz 1: the diagonal itself, the
//  plain version divides by it)   14 gam(k)   15 b(k)
// and one 16-byte vector of the two plane-0 'real' coefficients that are
// not in plane 0's record: band 4 (0, j-1, i+1), band 7 (0, j+1, i+1).
constexpr int kRec = 16;
constexpr int kMaxSmem = 232448;       // a block's shared memory, H100
constexpr int kMaxClusterBlocks = 16;  // non-portable cluster size
constexpr int kSlots = 2;              // columns a thread owns

template <typename T> struct Vec;
template <> struct Vec<float> {
    using type = float4;
    static constexpr int n = 4;
};
template <> struct Vec<double> {
    using type = double2;
    static constexpr int n = 2;
};

// 32-bit registers of a thread's records when they are held in registers
// (NZ planes, both slots), and the threads a block of that kernel may have
template <typename T, int NZ>
__host__ __device__ constexpr int record_regs() {
    return kSlots * (kRec * NZ + 2) * (int)sizeof(T) / 4;
}
constexpr int kMaxRecordRegs = 160;
__host__ __device__ constexpr int pow2_at_least(int x) {
    return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}
// the records and ~48 more registers a thread, rounded up to a power of
// two: 512 threads at NZ 2 (f32), 256 at NZ 4 or in f64
template <typename T, int NZ>
__host__ __device__ constexpr int max_threads() {
    return NZ == 0 ? 1024
                   : 65536 / pow2_at_least(record_regs<T, NZ>() + 48);
}

__host__ __device__ constexpr size_t up16(size_t x) {
    return (x + 15) / 16 * 16;
}

// One block's share of a level and the block's shared memory.  A block
// owns the rows [j0, j1) of a band (the whole level in the one-block
// form); each thread owns two columns (slots) for the whole call: RB slot
// s the column of colour s, GS the same two (both solved every step);
// FC's threads are two groups, group g owning colours 2g and 2g + 1.
// Thread t of group g (tl = t - g * nt0): lr = tl / hx, m = tl % hx; RB
// and GS column (j0 + lr, 2m + ((j + s) & 1)); FC colour c's column (the
// first row of parity c & 1 in the band + 2 lr, 2m + (c >> 1)).
struct ResPlan {
    int nz, ny, nx, hx, nb, rows_max, nt0, nt;
    bool reg;          // records in registers (NZ-templated kernel)
    bool resident;     // else records in shared memory (or device memory)
    size_t a, b, s0, fwd, rec, total;   // byte offsets, and the size

    __host__ __device__ ResPlan(int kind, int elem, int nz_, int ny_,
                                int nx_, int nb_, bool reg_, bool res_)
        : nz(nz_), ny(ny_), nx(nx_), nb(nb_), reg(reg_), resident(res_) {
        hx = (nx + 1) / 2;
        rows_max = (ny + nb - 1) / nb;
        nt0 = (kind == kFC ? (rows_max + 1) / 2 : rows_max) * hx;
        nt = (kind == kFC ? 2 : 1) * nt0;
        const size_t plane = (size_t)rows_max * nx * elem;
        a = 0;
        b = up16(a + (size_t)nz * plane);
        s0 = up16(b + (kind == kGS ? (size_t)nz * plane : 0));
        fwd = up16(s0 + (kind == kRB ? plane : 0));
        rec = up16(fwd + (reg ? 0 : (size_t)(kind == kGS ? 2 : 1) * nz * nt
                                  * elem));
        total = rec + (reg || !resident ? 0
                       : (size_t)kSlots * (nz * kRec * elem / 16 + 1) * nt
                             * 16);
    }
};

template <typename T>
struct ResArgs {
    const T* p;
    const T* b;
    const T* cA;
    T* out;
    T* grec;           // the records in device memory (unless resident)
    ResPlan pl;
    int real, nsweeps;
};

// The N planes of one column, contiguous in shared memory (local or of a
// neighbour block), in the fewest vector loads / stores (8 or 16 bytes)
template <typename T, int N>
__device__ __forceinline__ void load_col(const T* p, T* out) {
    if constexpr (N * sizeof(T) == 8 && sizeof(T) == 4) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        out[0] = v.x;
        out[1] = v.y;
    } else if constexpr (N * sizeof(T) % 16 == 0) {
        using V = typename Vec<T>::type;
#pragma unroll
        for (int q = 0; q < N * (int)sizeof(T) / 16; ++q) {
            const V v = reinterpret_cast<const V*>(p)[q];
#pragma unroll
            for (int e = 0; e < Vec<T>::n; ++e)
                out[q * Vec<T>::n + e] = reinterpret_cast<const T*>(&v)[e];
        }
    } else {
#pragma unroll
        for (int q = 0; q < N; ++q) out[q] = p[q];
    }
}

template <typename T, int N>
__device__ __forceinline__ void store_col(T* p, const T* in) {
    if constexpr (N * sizeof(T) == 8 && sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
    } else if constexpr (N * sizeof(T) % 16 == 0) {
        using V = typename Vec<T>::type;
#pragma unroll
        for (int q = 0; q < N * (int)sizeof(T) / 16; ++q) {
            V v;
#pragma unroll
            for (int e = 0; e < Vec<T>::n; ++e)
                reinterpret_cast<T*>(&v)[e] = in[q * Vec<T>::n + e];
            reinterpret_cast<V*>(p)[q] = v;
        }
    } else {
#pragma unroll
        for (int q = 0; q < N; ++q) p[q] = in[q];
    }
}

// nsweeps * ncolor colour steps of ordering KIND on the rows of one block
// (CLUSTER: one block of a thread block cluster that holds the level, the
// rows next to its band read from the neighbour blocks' shared memory).
// NZ > 0: nz == NZ and the records live in registers; NZ == 0: any nz, the
// records in shared memory (resident) or in device memory (grec, L2).
template <typename T, int KIND, int NZ, bool CLUSTER>
struct Resident {
    using V = typename Vec<T>::type;
    static constexpr bool REG = NZ > 0;
    static constexpr int NCOLOR = KIND == kRB ? 2 : (KIND == kFC ? 4 : 1);
    static constexpr int VPR = kRec / Vec<T>::n;   // vectors a plane record
    // the state buffers' layout: REG column-major (a column's NZ planes
    // contiguous, one vector load a column), else plane-major; CS the
    // stride of a column, KS (runtime) the stride of a plane
    static constexpr int CS = REG ? NZ : 1;

    const ResArgs<T> a;
    const ResPlan pl;
    int nz_, ny, nx, hx, nb, j0, j1, j0u, t, NT, gr, lr, m;
    size_t PS, KS, P, G, NV;
    T *bufA, *bufB, *S0, *fw;
    V* srec;
    T *upA = nullptr, *dnA = nullptr, *upB = nullptr, *dnB = nullptr,
      *upS = nullptr, *dnS = nullptr;
    T rec[REG ? kSlots : 1][REG ? NZ : 1][kRec];
    T rre[REG ? kSlots : 1][2];
    // one block with the records in registers: each slot's neighbour,
    // own and diagonal columns as offsets, computed once (the step's
    // address arithmetic off its instruction stream); dsel bit q:
    // diagonal q reads RB's snapshot (an offset into S0), else the state
    static constexpr bool FAST = REG && !CLUSTER;
    int nof[FAST ? kSlots : 1][5];
    int dof[FAST ? kSlots : 1][4];
    int dsel[FAST ? kSlots : 1];

    __device__ __forceinline__ Resident(const ResArgs<T>& a_,
                                        unsigned char* smem)
        : a(a_), pl(a_.pl) {
        nz_ = REG ? NZ : pl.nz;
        ny = pl.ny;
        nx = pl.nx;
        hx = pl.hx;
        nb = pl.nb;
        int r = 0;
        if constexpr (CLUSTER)
            r = (int)cooperative_groups::this_cluster().block_rank();
        j0 = (int)((long long)r * ny / nb);
        j1 = (int)((long long)(r + 1) * ny / nb);
        j0u = (int)((long long)(r - 1) * ny / nb);   // the block above
        t = threadIdx.x;
        NT = blockDim.x;
        gr = t / pl.nt0;
        const int tl = t - gr * pl.nt0;
        lr = tl / hx;
        m = tl % hx;
        PS = (size_t)pl.rows_max * nx;     // a plane of the band buffers
        KS = REG ? 1 : PS;
        P = (size_t)ny * nx;
        G = (size_t)ny * hx;               // global slots of one class
        NV = (size_t)nz_ * VPR + 1;         // vectors of a slot's records
        bufA = reinterpret_cast<T*>(smem + pl.a);
        bufB = reinterpret_cast<T*>(smem + pl.b);
        S0 = reinterpret_cast<T*>(smem + pl.s0);
        fw = reinterpret_cast<T*>(smem + pl.fwd);
        srec = reinterpret_cast<V*>(smem + pl.rec);
        if constexpr (CLUSTER) {
            auto cl = cooperative_groups::this_cluster();
            if (r > 0) {
                upA = cl.map_shared_rank(bufA, r - 1);
                upB = cl.map_shared_rank(bufB, r - 1);
                upS = cl.map_shared_rank(S0, r - 1);
            }
            if (r < nb - 1) {
                dnA = cl.map_shared_rank(bufA, r + 1);
                dnB = cl.map_shared_rank(bufB, r + 1);
                dnS = cl.map_shared_rank(S0, r + 1);
            }
        }
    }

    __device__ __forceinline__ void barrier() const {
        if constexpr (CLUSTER) {
            cooperative_groups::this_cluster().sync();
        } else {
            __syncthreads();
        }
    }

    // the slot (0..3) of local slot ls of this thread
    __device__ __forceinline__ int slot(int ls) const {
        return KIND == kFC ? 2 * gr + ls : ls;
    }

    // the column of slot s; false where this thread has none
    __device__ __forceinline__ bool column(int s, int& j, int& i) const {
        if (KIND == kFC) {
            j = j0 + ((j0 + (s & 1)) & 1) + 2 * lr;
            i = 2 * m + (s >> 1);
        } else {
            j = j0 + lr;
            i = 2 * m + ((j + s) & 1);
        }
        return j < j1 && i < nx;
    }

    // plane 0 of row jj (of this band or next to it), column ii, of a
    // buffer given here and at the neighbour blocks: a state buffer
    // (column stride cs = CS) or RB's plane-0 snapshot (cs = 1)
    __device__ __forceinline__ T* at(T* loc, T* up, T* dn, int jj, int ii,
                                     int cs = CS) const {
        if (CLUSTER && jj < j0)
            return up + ((size_t)(jj - j0u) * nx + ii) * cs;
        if (CLUSTER && jj >= j1)
            return dn + ((size_t)(jj - j1) * nx + ii) * cs;
        return loc + ((size_t)(jj - j0) * nx + ii) * cs;
    }

    // vector q of the records of local slot ls (slot s, row j) in memory
    __device__ __forceinline__ V* recv(int ls, int s, int j, size_t q) const {
        if (pl.resident) return srec + ((size_t)ls * NV + q) * NT + t;
        return reinterpret_cast<V*>(a.grec)
               + ((size_t)s * NV + q) * G + (size_t)j * hx + m;
    }

    template <int LS>
    __device__ __forceinline__ void put(int s, int j, int k, const T* v) {
        if constexpr (REG) {
#pragma unroll
            for (int q = 0; q < kRec; ++q) rec[LS][k][q] = v[q];
        } else {
            const V* src = reinterpret_cast<const V*>(v);
#pragma unroll
            for (int q = 0; q < VPR; ++q)
                *recv(LS, s, j, (size_t)k * VPR + q) = src[q];
        }
    }

    // the records of local slot LS: the coefficients, and the Thomas
    // factors with ops/relax.tridiag's divisions, once a call
    template <int LS>
    __device__ __forceinline__ void records() {
        const int nz = REG ? NZ : nz_;     // a constant where REG
        const int s = slot(LS);
        int j, i;
        if (!column(s, j, i)) return;
        if constexpr (FAST) {
            auto off = [&](int jj, int ii) { return (jj - j0) * nx + ii; };
            const int jn = j > 0 ? j - 1 : 0, js = j < ny - 1 ? j + 1 : j;
            const int iw = i > 0 ? i - 1 : 0, ie = i < nx - 1 ? i + 1 : i;
            nof[LS][0] = off(jn, i) * CS;
            nof[LS][1] = off(js, i) * CS;
            nof[LS][2] = off(j, iw) * CS;
            nof[LS][3] = off(j, ie) * CS;
            nof[LS][4] = off(j, i) * CS;
            const int dj[4] = {1, -1, -1, 1}, di[4] = {-1, 1, -1, 1};
            dsel[LS] = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                int jj = j + dj[q], ii = i + di[q];
                jj = jj < 0 ? 0 : (jj >= ny ? ny - 1 : jj);
                ii = ii < 0 ? 0 : (ii >= nx ? nx - 1 : ii);
                const bool snap = KIND == kRB && ((jj + ii + j + i) & 1) == 0;
                dof[LS][q] = off(jj, ii) * (snap ? 1 : CS);
                dsel[LS] |= (snap ? 1 : 0) << q;
            }
        }
        const Level g{nz, ny, nx};
        auto bandv = [&](int n, int kk, int dj, int di) -> T {
            return band(a.cA, g, n, kk, j, i, dj, di);
        };
        __align__(16) T cur[kRec];
        T bet = T(0);
#pragma unroll (REG ? NZ : 1)
        for (int k = 0; k < nz; ++k) {
            __align__(16) T v[kRec];
            v[0] = bandv(2, k, 0, 0);
            v[1] = bandv(2, k - 1, 1, 0);
            v[2] = bandv(3, k, 0, 0);
            v[3] = bandv(3, k, 1, 0);
            v[4] = bandv(4, k, 0, 0);
            v[5] = bandv(4, k + 1, 1, 0);
            v[6] = bandv(5, k, 0, 0);
            v[7] = bandv(5, k - 1, 0, 1);
            v[8] = bandv(6, k, 0, 0);
            v[9] = bandv(6, k, 0, 1);
            v[10] = bandv(7, k, 0, 0);
            v[11] = bandv(7, k + 1, 0, 1);
            const T dd = k > 0 ? bandv(1, k, 0, 0) : T(0);
            v[12] = dd;
            if (nz == 1) {
                bet = bandv(0, 0, 0, 0);
            } else if (k == 0) {
                bet = T(1) / bandv(0, 0, 0, 0);
            } else {
                const T gm = dd * bet;
                cur[14] = gm;                 // gam(k - 1)
                put<LS>(s, j, k - 1, cur);
                bet = T(1) / (bandv(0, k, 0, 0) - dd * gm);
            }
            v[13] = bet;
            v[14] = T(0);
            v[15] = a.b[(size_t)k * P + (size_t)j * nx + i];
#pragma unroll
            for (int q = 0; q < kRec; ++q) cur[q] = v[q];
        }
        put<LS>(s, j, nz - 1, cur);
        __align__(16) T rr[Vec<T>::n];
#pragma unroll
        for (int q = 0; q < Vec<T>::n; ++q) rr[q] = T(0);
        rr[0] = bandv(4, 0, -1, 1);
        rr[1] = bandv(7, 0, 1, 1);
        if constexpr (REG) {
            rre[LS][0] = rr[0];
            rre[LS][1] = rr[1];
        } else {
            *recv(LS, s, j, NV - 1) = *reinterpret_cast<const V*>(rr);
        }
    }

    template <int LS>
    __device__ __forceinline__ void load_plane(int s, int j, int k,
                                               T* v) const {
        if constexpr (REG) {
#pragma unroll
            for (int q = 0; q < kRec; ++q) v[q] = rec[LS][k][q];
        } else {
            V* dst = reinterpret_cast<V*>(v);
#pragma unroll
            for (int q = 0; q < VPR; ++q)
                dst[q] = *recv(LS, s, j, (size_t)k * VPR + q);
        }
    }

    // The forward pass of the column of local slot LS on buffer (rl, ru,
    // rd): its gather and the factored Thomas forward step, the values
    // into xf (REG) or the shared forward values at place sa (GS solves
    // two columns a step).  Loads only: GS's two columns' chains overlap.
    template <int LS>
    __device__ __forceinline__ void forward(int sa, T* rl, T* ru, T* rd,
                                            T* xf, T* po) const {
        const int nz = REG ? NZ : nz_;
        const int s = slot(LS);
        int j, i;
        if (!column(s, j, i)) return;
        // N, S, W, E (stencil15.cuh: (j-1, i), (j+1, i), (j, i-1),
        // (j, i+1), the edge copy clamped to the column itself)
        const T* nbr[4];
        const T* ownp;
        if constexpr (FAST) {
#pragma unroll
            for (int d = 0; d < 4; ++d) nbr[d] = rl + nof[LS][d];
            ownp = rl + nof[LS][4];
        } else {
            const int jn = j > 0 ? j - 1 : 0, js = j < ny - 1 ? j + 1 : j;
            const int iw = i > 0 ? i - 1 : 0, ie = i < nx - 1 ? i + 1 : i;
            nbr[0] = at(rl, ru, rd, jn, i);
            nbr[1] = at(rl, ru, rd, js, i);
            nbr[2] = at(rl, ru, rd, j, iw);
            nbr[3] = at(rl, ru, rd, j, ie);
            ownp = at(rl, ru, rd, j, i);
        }
        // the neighbours' planes k - 1, k, k + 1 (0 outside the column);
        // REG: each neighbour's and the column's own planes in registers
        T nb[4][REG ? NZ : 1];
        if constexpr (REG) {
#pragma unroll
            for (int d = 0; d < 4; ++d) load_col<T, NZ>(nbr[d], nb[d]);
            load_col<T, NZ>(ownp, po);
        }
        auto plane = [&](int d, int kk) -> T {
            if (kk >= nz) return T(0);
            if constexpr (REG) return nb[d][kk < NZ ? kk : 0];
            else return nbr[d][(size_t)kk * KS];
        };
        T wm[4], w0[4], wp[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
            wm[d] = T(0);
            w0[d] = plane(d, 0);
            wp[d] = plane(d, 1);
        }
        T x = T(0);
        __align__(16) T nv[kRec];          // the next plane's record
        load_plane<LS>(s, j, 0, nv);
#pragma unroll (REG ? NZ : 1)
        for (int k = 0; k < nz; ++k) {
            __align__(16) T v[kRec];
#pragma unroll
            for (int q = 0; q < kRec; ++q) v[q] = nv[q];
            if (k + 1 < nz) load_plane<LS>(s, j, k + 1, nv);
            // stencil15.cuh offdiag, term for term
            T sum = v[0] * wp[0];
            sum = sum + v[1] * wm[1];
            sum = sum + v[2] * w0[0];
            sum = sum + v[3] * w0[1];
            sum = sum + v[4] * wm[0];
            sum = sum + v[5] * wp[1];
            sum = sum + v[6] * wp[2];
            sum = sum + v[7] * wm[3];
            sum = sum + v[8] * w0[2];
            sum = sum + v[9] * w0[3];
            sum = sum + v[10] * wm[2];
            sum = sum + v[11] * wp[3];
            if (a.real && k == 0) {
                T r0, r1;
                if constexpr (REG) {
                    r0 = rre[LS][0];
                    r1 = rre[LS][1];
                } else {
                    const V rv = *recv(LS, s, j, NV - 1);
                    r0 = reinterpret_cast<const T*>(&rv)[0];
                    r1 = reinterpret_cast<const T*>(&rv)[1];
                }
                auto dg = [&](int q, int jj, int ii) -> T {
                    if constexpr (FAST)
                        return ((dsel[LS] >> q) & 1) ? S0[dof[LS][q]]
                                                     : rl[dof[LS][q]];
                    else return diag(rl, ru, rd, j, i, jj, ii);
                };
                T x0 = v[4] * dg(0, j + 1, i - 1);
                x0 = x0 + r0 * dg(1, j - 1, i + 1);
                x0 = x0 + v[10] * dg(2, j - 1, i - 1);
                x0 = x0 + r1 * dg(3, j + 1, i + 1);
                sum = sum + x0;
            }
            const T rhs = v[15] - sum;
            // the factored Thomas forward step (ops/relax.tridiag_factored)
            if (nz == 1) x = rhs / v[13];
            else if (k == 0) x = rhs * v[13];
            else x = (rhs - v[12] * x) * v[13];
            if constexpr (REG) xf[k] = x;
            else fw[((size_t)sa * nz + k) * NT + t] = x;
#pragma unroll
            for (int d = 0; d < 4; ++d) {
                wm[d] = w0[d];
                w0[d] = wp[d];
                wp[d] = plane(d, k + 2);
            }
        }
    }

    // The back substitution of the same column, each plane committed as
    // p + (sol - p) from rl into wl (RB and FC: in place, wl == rl; GS:
    // the other buffer).  Returns the new plane-0 value's index in the
    // band (RB's snapshot is written a step later), -1 where this thread
    // has no column.
    template <int LS>
    __device__ __forceinline__ int back(int sa, const T* rl, T* wl,
                                        const T* xf, const T* po,
                                        T& p0) const {
        const int nz = REG ? NZ : nz_;
        const int s = slot(LS);
        int j, i;
        if (!column(s, j, i)) return -1;
        const int own = (j - j0) * nx + i;
        T x = T(0);
        T nws[REG ? NZ : 1];
#pragma unroll (REG ? NZ : 1)
        for (int kk = 0; kk < nz; ++kk) {
            const int k = nz - 1 - kk;
            const T xk = REG ? xf[k] : fw[((size_t)sa * nz + k) * NT + t];
            if (k < nz - 1) {
                T gk;
                if constexpr (REG) {
                    gk = rec[LS][k][14];
                } else {
                    const V gv = *recv(LS, s, j,
                                       (size_t)k * VPR + 14 / Vec<T>::n);
                    gk = reinterpret_cast<const T*>(&gv)[14 % Vec<T>::n];
                }
                x = xk - gk * x;
            } else {
                x = xk;
            }
            const T pk = REG ? po[k] : rl[(size_t)k * PS + own];
            const T nw = pk + (x - pk);
            if constexpr (REG) nws[k] = nw;
            else wl[(size_t)k * PS + own] = nw;
            p0 = nw;
        }
        if constexpr (REG) store_col<T, NZ>(wl + (size_t)own * CS, nws);
        return own;
    }

    // a plane-0 diagonal coupling of column (j, i): RB reads the columns
    // of its own colour from the snapshot taken before the step
    __device__ __forceinline__ T diag(T* rl, T* ru, T* rd, int j, int i,
                                      int jj, int ii) const {
        jj = jj < 0 ? 0 : (jj >= ny ? ny - 1 : jj);
        ii = ii < 0 ? 0 : (ii >= nx ? nx - 1 : ii);
        if (KIND == kRB && ((jj + ii + j + i) & 1) == 0)
            return *at(S0, upS, dnS, jj, ii, 1);
        return *at(rl, ru, rd, jj, ii);
    }

    // colour step C of every sweep, then the ones after it
    template <int C>
    __device__ __forceinline__ void steps(T*& rA, T*& rU, T*& rD, T*& wA,
                                          T*& wU, T*& wD, T& pend,
                                          int& pend_i) {
        if constexpr (C < NCOLOR) {
            if (KIND == kRB && a.real && pend_i >= 0) {
                S0[pend_i] = pend;      // no step reads it until its
                pend_i = -1;            // colour's next turn
            }
            T p0 = T(0);
            // the forward values and (REG) the old state of the step's
            // columns, loaded before any store
            T xf0[REG ? NZ : 1], xf1[REG ? NZ : 1];
            T po0[REG ? NZ : 1], po1[REG ? NZ : 1];
            if constexpr (KIND == kGS) {
                forward<0>(0, rA, rU, rD, xf0, po0);
                forward<1>(1, rA, rU, rD, xf1, po1);
                back<0>(0, rA, wA, xf0, po0, p0);
                back<1>(1, rA, wA, xf1, po1, p0);
                T* x = rA; rA = wA; wA = x;
                x = rU; rU = wU; wU = x;
                x = rD; rD = wD; wD = x;
            } else if (KIND == kRB || gr == (C >> 1)) {
                constexpr int LS = KIND == kRB ? C : (C & 1);
                forward<LS>(0, rA, rU, rD, xf0, po0);
                const int own = back<LS>(0, rA, rA, xf0, po0, p0);
                if (KIND == kRB && own >= 0) {
                    pend = p0;
                    pend_i = own;
                }
            }
            barrier();
            steps<C + 1>(rA, rU, rD, wA, wU, wD, pend, pend_i);
        }
    }

    template <int LS>
    __device__ __forceinline__ void all_records() {
        if constexpr (LS < kSlots) {
            records<LS>();
            all_records<LS + 1>();
        }
    }

    __device__ __forceinline__ void run() {
        const int nz = REG ? NZ : nz_;
        // the state and RB's plane-0 snapshot of this band, the records
        const size_t nband = (size_t)(j1 - j0) * nx;
        for (size_t o = t; o < (size_t)nz * nband; o += NT) {
            const size_t k = o / nband, rest = o % nband;
            const T v = a.p[k * P + (size_t)j0 * nx + rest];
            bufA[REG ? rest * CS + k : k * PS + rest] = v;
            if (KIND == kRB && a.real && k == 0) S0[rest] = v;
        }
        all_records<0>();
        barrier();
        T* rA = bufA;          // the buffer steps read (GS: ping-pong)
        T* rU = upA;
        T* rD = dnA;
        T* wA = KIND == kGS ? bufB : bufA;
        T* wU = KIND == kGS ? upB : upA;
        T* wD = KIND == kGS ? dnB : dnA;
        T pend = T(0);         // RB 'real': this thread's last plane-0
        int pend_i = -1;       // value, for the snapshot
        for (int sw = 0; sw < a.nsweeps; ++sw)
            steps<0>(rA, rU, rD, wA, wU, wD, pend, pend_i);
        // the result: this band of the last state
        for (size_t o = t; o < (size_t)nz * nband; o += NT) {
            const size_t k = o / nband, rest = o % nband;
            a.out[k * P + (size_t)j0 * nx + rest] =
                rA[REG ? rest * CS + k : k * PS + rest];
        }
    }
};

template <typename T, int KIND, int NZ, bool CLUSTER>
__global__ void __launch_bounds__(max_threads<T, NZ>())
relax_resident(ResArgs<T> a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Resident<T, KIND, NZ, CLUSTER> res(a, smem);
    res.run();
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

// ------------------------------------------------ the one-launch launch

template <typename T, int KIND, int NZ, bool CLUSTER>
int run_resident(const ResArgs<T>& a, cudaStream_t s) {
    if constexpr (NZ > 0 && record_regs<T, NZ>() > kMaxRecordRegs) {
        return (int)cudaErrorInvalidValue;     // never planned
    } else {
        auto kern = relax_resident<T, KIND, NZ, CLUSTER>;
        const ResPlan& pl = a.pl;
        if constexpr (CLUSTER) {
            return launch_cluster(kern, pl.nb, pl.nt, pl.total, s, a);
        } else {
            const int e =
                kernel_attributes((const void*)kern, pl.total, false);
            if (e != 0) return e;
            kern<<<1, pl.nt, pl.total, s>>>(a);
            return (int)cudaGetLastError();
        }
    }
}

// The plan of a block of nb: records in registers where nz is 2 or 4 and
// they fit (kMaxRecordRegs, the kernel's thread bound), else in shared
// memory where they fit beside the state, else in device memory
template <typename T>
ResPlan plan_resident(int kind, int nz, int ny, int nx, int nb) {
    const int e = (int)sizeof(T);
    ResPlan pl(kind, e, nz, ny, nx, nb, false, true);
    const bool reg =
        (nz == 2 && record_regs<T, 2>() <= kMaxRecordRegs
         && pl.nt <= max_threads<T, 2>())
        || (nz == 4 && record_regs<T, 4>() <= kMaxRecordRegs
            && pl.nt <= max_threads<T, 4>());
    if (reg) return ResPlan(kind, e, nz, ny, nx, nb, true, true);
    if (pl.total > (size_t)kMaxSmem)
        pl = ResPlan(kind, e, nz, ny, nx, nb, false, false);
    return pl;
}

// The bytes of device memory the one-block form's records take at this
// shape: 0 where registers or shared memory hold them (the cluster form
// holds them in registers); else, per slot (FC 4, else 2) and global slot
// (ny * ((nx + 1) / 2)), nz plane records of 16 values and one 16-byte
// vector of the two 'real' coefficients.
template <typename T>
long long record_bytes(int kind, int nz, int ny, int nx) {
    const ResPlan pl = plan_resident<T>(kind, nz, ny, nx, 1);
    if (pl.reg || pl.resident) return 0;
    return (long long)(kind == kFC ? 4 : 2)
           * ((long long)nz * kRec * sizeof(T) + 16) * ny * ((nx + 1) / 2);
}

// The cluster form: the records in registers, float32 only
template <typename T, int KIND>
int run_cluster(const ResArgs<T>& a, cudaStream_t s) {
    if constexpr (sizeof(T) != 4) {
        return (int)cudaErrorInvalidValue;
    } else {
        return a.pl.nz == 2 ? run_resident<T, KIND, 2, true>(a, s)
                            : run_resident<T, KIND, 4, true>(a, s);
    }
}

// One launch for the whole call: one block (cluster == 0), or a cluster
// of min(16, ny) blocks, of min(8, ny) where 16 cannot be resident; a
// cluster plan that does not hold the records in registers in float32 is
// refused (cudaErrorInvalidValue).  recs: device memory for the records
// where the one-block plan puts them there (record_bytes), else unused.
// info (may be null): blocks, threads a block, where the records live (0
// registers, 1 shared memory, 2 device memory), shared memory bytes a
// block.
template <typename T, int KIND>
int launch_resident(const T* p, const T* b, const T* cA, T* out, T* recs,
                    int nz, int ny, int nx, int real, int nsweeps,
                    int cluster, int* info, cudaStream_t s) {
    const int cands[2] = {cluster ? (ny < kMaxClusterBlocks
                                     ? ny : kMaxClusterBlocks) : 1,
                          ny < 8 ? ny : 8};
    int rc = (int)cudaErrorInvalidConfiguration;
    for (int c = 0; c < (cluster ? 2 : 1); ++c) {
        const ResPlan pl = plan_resident<T>(KIND, nz, ny, nx, cands[c]);
        if (pl.total > (size_t)kMaxSmem || pl.nt > 1024 || pl.nt < 1
            || (!pl.reg && !pl.resident && recs == nullptr)
            || (cluster && (!pl.reg || sizeof(T) != 4)))
            return (int)cudaErrorInvalidValue;
        const ResArgs<T> a{p, b, cA, out, recs, pl, real, nsweeps};
        if (cluster)
            rc = run_cluster<T, KIND>(a, s);
        else if (pl.reg)
            rc = nz == 2 ? run_resident<T, KIND, 2, false>(a, s)
                         : run_resident<T, KIND, 4, false>(a, s);
        else
            rc = run_resident<T, KIND, 0, false>(a, s);
        if (rc == kNoCluster) continue;
        if (info) {
            info[0] = pl.nb;
            info[1] = pl.nt;
            info[2] = pl.reg ? 0 : (pl.resident ? 1 : 2);
            info[3] = (int)pl.total;
        }
        return rc;
    }
    return rc == kNoCluster ? (int)cudaErrorLaunchOutOfResources : rc;
}

// form 0: a launch per colour step (scratch: GS's second state buffer,
// RB's plane-0 snapshot, unused by FC); 1: one launch, one block (scratch:
// the records, where record_bytes is not 0); 2: one launch, a thread
// block cluster (no scratch).  Out <- p after
// nsweeps sweeps of ordering kind.
template <typename T>
int launch_relax_fused(const void* p, const void* b, const void* cA,
                       void* out, void* scratch, int nz, int ny, int nx,
                       int real, int nsweeps, int kind, int form, int* info,
                       void* stream) {
    if (kind < kRB || kind > kGS || form < 0 || form > 2 || nz < 1
        || ny < 1 || nx < 1)
        return (int)cudaErrorInvalidValue;
    const Level g{nz, ny, nx};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* pt = (const T*)p;
    const T* bt = (const T*)b;
    const T* ct = (const T*)cA;
    T* ot = (T*)out;
    T* sc = (T*)scratch;
    if (form > 0) {
        const int cl = form == 2;
        if (kind == kRB)
            return launch_resident<T, kRB>(pt, bt, ct, ot, sc, nz, ny, nx,
                                           real, nsweeps, cl, info, s);
        if (kind == kFC)
            return launch_resident<T, kFC>(pt, bt, ct, ot, sc, nz, ny, nx,
                                           real, nsweeps, cl, info, s);
        return launch_resident<T, kGS>(pt, bt, ct, ot, sc, nz, ny, nx, real,
                                       nsweeps, cl, info, s);
    }
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
                       int real, int nsweeps, int kind, int form, int* info,
                       void* stream) {
    return launch_relax_fused<float>(p, b, cA, out, scratch, nz, ny, nx,
                                     real, nsweeps, kind, form, info,
                                     stream);
}

int mg_relax_fused_f64(const void* p, const void* b, const void* cA,
                       void* out, void* scratch, int nz, int ny, int nx,
                       int real, int nsweeps, int kind, int form, int* info,
                       void* stream) {
    return launch_relax_fused<double>(p, b, cA, out, scratch, nz, ny, nx,
                                      real, nsweeps, kind, form, info,
                                      stream);
}

// The scratch bytes the one-block form's records need (elem: 4 or 8)
long long mg_relax_fused_record_bytes(int elem, int nz, int ny, int nx,
                                      int kind) {
    if (kind < kRB || kind > kGS || nz < 1 || ny < 1 || nx < 1) return -1;
    return elem == 4 ? record_bytes<float>(kind, nz, ny, nx)
                     : record_bytes<double>(kind, nz, ny, nx);
}

}  // extern "C"
