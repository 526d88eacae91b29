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
// K8 computes one whole RB sweep of one lane chunk from the six packed
// streams (bands, pivots, seam pivots, RHS, seam RHS, state) into the four
// interior chunk quads, colour 0 then colour 1, in ONE ordinary launch.
// What bounds it: memory.  Per column and plane a colour reads 12 band
// values (14 with 'real' on plane 0), 12 state values, the RHS, bet, ud and
// gam, and writes the solution (~2 flops per value read).  Both colours
// read every one of the 24 band slabs (a target reads its own quad's six
// bands and a neighbour quad's six shifted ones), so each band byte is
// read twice a sweep; a tile's slabs over all planes are megabytes, more
// than a block holds, so the bound (sweep_packed.needed_bytes: every
// element the outputs depend on, read once) is out of reach; what the
// design does about the rest (sweep_packed.design_bytes counts what it
// moves):
//
// - A block owns one row tile [J0, J0+TJ) x a window [c0, c0+WN) of the
//   chunk's columns and walks z in lock step, one block barrier a plane.
//   For each plane it stages in shared memory, by cp.async (LDGSTS), the
//   window's slice of every band slab (rows [J0-1, J0+TJ], columns
//   [c0-1, c0+WN]; each slab is read at one plane offset bk per colour,
//   so a stage holds slab s at plane k+bk(s)), for colour 0 the state
//   plane k+1 of the two colour-1 quads, and each thread's own bet, ud
//   and RHS, into a ring of kNS stages: planes k+1 .. k+kAhead are in
//   flight while plane k is solved.  Every gather term then reads shared
//   memory, at an offset compiled in (term_of: the recipe of the band
//   stack, which is the packed streams' too).  The band rows' pitch is
//   WC+3 values (2,060 B in float32 at WC = 512), not a multiple of 16 B,
//   so float32 and float64 bands are copied a value at a time (4-, 8-byte
//   copies) and bfloat16 bands, staged as bfloat16, in 16-byte copies
//   aligned as device memory has them: each staged row starts at its own
//   misalignment, which the reader adds, and values are widened when
//   read.
// - Colour 0 stays on chip.  Phase 0 solves (0,0) on rows [J0, J0+TJ] x
//   columns [c0, c0+WN] and (1,1) on rows [J0-1, J0+TJ) x columns
//   [c0-1, c0+WN): the tile plus the one-row, one-column overhang whose
//   values colour 1 reads (the TPU kernel's overhang; a neighbouring block
//   recomputes the same columns bitwise identically, so no grid barrier).
//   The forward values of all nz planes of those 2 (TJ+1)(WN+1) columns
//   live in shared memory, the back substitution runs there in place, and
//   the physical mirror cells are filled with the pre-sweep state.  Phase 1
//   reads its colour-0 neighbours at planes k-1..k+1 from there; the 'real'
//   terms' colour-1 siblings on plane 0 come from a staged plane-0 window
//   patched with the e1 halo rules (sweep_packed.py:448-498).  Phase 1's
//   forward values go to its outputs (read back from L2 by the same
//   thread).
// - A thread owns one column of the current colour: 2 (TJ+1)(WN+1) in
//   phase 0, 2 TJ WN in phase 1 (320 threads at TJ 8, WN 16: 96 % and
//   80 % busy).
// - The window is chosen from (nz, TJ, types) by sweep_packed.window_plan:
//   the widest of 16, 8, 4, 2, 1 columns whose colour-0 columns and rings
//   fit 227 KB of shared memory with at most kMaxThreads threads.  The
//   launcher takes that window and the shared memory reckoned for it, and
//   refuses a window that does not fit or whose Layout here differs.
//
// On the H100 it moves its own traffic at 50-55 % (float32), 38-40 %
// (bfloat16 bands) and 59-63 % (float64) of the memory's rate: 27-30 %,
// 24-25 % and 30-32 % of its bound (PERF.md section 6).  Builds with
// parts taken out showed the band copies take about a third of its time,
// the gather an eighth, the barriers nothing measurable.  The back
// substitutions load kBack planes at a time (one at a time cost
// 6-11 %).  Two resident blocks an SM (an 8-column window), float32
// bands in 16-byte copies and a deeper ring (more shared memory, less
// L1) all measured slower.
//
// Instances: (float, float), (double, double) and (float, bfloat16 bands,
// upcast at read).  Rounding: built with -fmad=false (0 ulp from the plain
// version).
//
// K9 is a copy: every element of the C per-chunk tile-major streams
// (ntiles, nslabs*nz, rows, width) is read from the full-width padded
// arrays and written once.  Main mode: a block takes one (tile, slab
// plane) window, its rows x WP source rows, and writes every chunk's
// slice, a warp per output row, in 16-byte vector copies where the source
// and destination rows share their alignment (value copies on the
// misaligned edges, or the whole row where they do not); offsets are
// 32-bit within a block.  Seam mode: one thread per output row (its two
// values).  Bound: memory.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the launch's CUDA error code (cudaErrorInvalidValue
// for a window that does not fit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_terms.cuh"

// The streams of one chunk (sweep_packed.SweepOperator, pack_rhs,
// pack_state) and the four output quads in _TKEYS order.
struct SweepPackedArgs {
    const void* pst;
    const void* pband;
    const void* ppiv;
    const void* pseam;
    const void* pbq;
    const void* pqs;
    void* out[4];
};

// K9's arrays and the per-chunk output streams.
struct PackArgs {
    const void* src[8];
    void* dst[64];
};

namespace {

// ------------------------------------------------------------ K8's plan

constexpr int kSlabs = 24;          // band slabs: bands 3..8 x four quads
constexpr int kNS = 4;              // band / column ring stages
constexpr int kAhead = kNS - 1;     // planes in flight ahead of the solved one
// state ring: planes k-1 .. k+kAhead+1, indexed by (plane + 1) % kNSS
constexpr int kNSS = kAhead + 3;
constexpr int kMaxC = 16;           // band copies a thread issues a plane
constexpr int kMaxS = 4;            // state copies a thread issues a plane
constexpr int kMaxThreads = 384;
constexpr size_t kMaxDynSmem = 227 * 1024;

__host__ __device__ constexpr size_t align16(size_t b) {
    return (b + 15) / 16 * 16;
}

// The shared-memory layout of one block at window WN
// (sweep_packed.window_layout reckons it alike; the launcher checks that
// the two agree).  R staged rows [J0-1, J0+TJ],
// NC staged columns [c0-1, c0+WN]; band rows are staged in aligned copies
// of kE values with kE - 1 values of slack for their misalignment (BP
// values, CPR copies a row): bfloat16 in 16-byte copies, float32 and
// float64 a value a copy (16-byte copies measured slower there: the
// reader's per-term misalignment arithmetic cost more than the fewer
// copies saved; PERF.md section 6).
template <typename T, typename B>
struct Layout {
    static constexpr int kE = sizeof(B) == 2 ? 8 : 1;
    int nz, tj, wn, nt, R, NC, BP, CPR, SW, SQ;
    size_t store, s0, sring, bring, cring, bytes;

    __host__ __device__ Layout(int nz_, int tj_, int wn_)
        : nz(nz_), tj(tj_), wn(wn_) {
        R = tj + 2;
        NC = wn + 2;
        BP = (NC + 2 * kE - 2) / kE * kE;
        CPR = BP / kE;
        SW = wn + 1;
        SQ = (tj + 1) * SW;
        // one column of the current colour a thread; enough threads that
        // a plane's band and state copies fit kMaxC / kMaxS a thread
        int need = 2 * (tj + 1) * (wn + 1);
        need = need > 2 * tj * wn ? need : 2 * tj * wn;
        const int nb = (kSlabs * R * CPR + kMaxC - 1) / kMaxC;
        const int ns = (2 * R * NC + kMaxS - 1) / kMaxS;
        need = need > nb ? need : nb;
        need = need > ns ? need : ns;
        nt = (need + 31) / 32 * 32;
        store = align16((size_t)2 * (nz + 2) * SQ * sizeof(T));
        s0 = align16((size_t)4 * R * NC * sizeof(T));
        sring = align16((size_t)kNSS * 2 * R * NC * sizeof(T));
        bring = align16((size_t)kNS * kSlabs * R * BP * sizeof(B));
        cring = align16((size_t)kNS * 3 * nt * sizeof(T));
        bytes = store + s0 + sring + bring + cring;
    }
    __host__ __device__ bool fits() const {
        return nt <= kMaxThreads && bytes <= kMaxDynSmem;
    }
};

// the plane offset of band slab s in colour c's terms (each slab is read
// at one offset a colour: sweep_packed's tests check it), as two masks
__host__ __device__ constexpr unsigned bk_mask(int colour, int sign) {
    unsigned m = 0;
    for (int i = 0; i < 2; ++i) {
        const int t = colour == 0 ? (i == 0 ? 0 : 3) : (i == 0 ? 1 : 2);
        for (int j = 0; j < kTerms; ++j) {
            const Term tm = term_of(t, j);
            if (tm.bk == sign) m |= 1u << tm.band;
        }
    }
    return m;
}
constexpr unsigned kBkPlus0 = bk_mask(0, 1), kBkMinus0 = bk_mask(0, -1);
constexpr unsigned kBkPlus1 = bk_mask(1, 1), kBkMinus1 = bk_mask(1, -1);

// ------------------------------------------------------ async copies

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

// this thread's copies of all but the newest kAhead - 1 groups landed
__device__ __forceinline__ void cp_wait_stage() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --------------------------------------------------------- one block

template <typename T, typename B>
struct Block {
    using L = Layout<T, B>;
    static constexpr int kE = L::kE;
    static constexpr int kCopy = kE * (int)sizeof(B);    // bytes a copy

    L lay;
    int nz, tj, wc, H, J0, c0, ce, nc, real, first, last, tid;
    int PSb, PSs;               // band / state plane strides
    unsigned emis;              // the band stream's misalignment, values
    const T* st;                // this tile's packed state (4nz, TJ+4, WC+4)
    const B* band;              // (24nz, TJ+4, WC+3)
    const T* piv;               // (12nz, TJ+2, WC)
    const T* seam;              // (6nz, TJ+2, 2)
    const T* rhs;               // (4nz, TJ+2, WC)
    const T* rseam;             // (2nz, TJ+2, 2)
    T* store;                   // colour 0: [2][nz+2][TJ+1][WN+1]
    T* s0;                      // plane 0 of the 4 quads: [4][R][NC]
    T* sring;                   // quads 1, 2: [kNSS][2][R][NC]
    B* bring;                   // [kNS][24][R][BP]
    T* cring;                   // [kNS][bet, ud, rhs][nt]
    // this thread's band and state copies of a plane (-1: none)
    int bsrc[kMaxC], bdst[kMaxC], ssrc[kMaxS], sdst[kMaxS];
    // this thread's column: its streams, their plane stride, its cell
    const T *cbet, *cud, *cgam, *crhs;
    int cps, yr, xr;

    __device__ Block(const L& l) : lay(l) {}

    __device__ int stage_size() const { return kSlabs * lay.R * lay.BP; }

    // the band copies of colour `colour`: slab, row and copy of the
    // flattened index tid + i nt; bdst packs the stage offset, whether the
    // copy is a row's last (needed only where the row's misalignment
    // reaches into it), the row's misalignment at plane 0 and bk + 1
    __device__ __forceinline__ void band_copies(int colour) {
        const unsigned plus = colour ? kBkPlus1 : kBkPlus0;
        const unsigned minus = colour ? kBkMinus1 : kBkMinus0;
        const int per = lay.R * lay.CPR;
        const int ncopy = (nc + 2 * kE) / kE;
#pragma unroll
        for (int i = 0; i < kMaxC; ++i) {
            const int e = tid + i * lay.nt;
            bdst[i] = -1;
            bsrc[i] = 0;
            if (e < kSlabs * per) {
                const int s = e / per, r = (e - s * per) / lay.CPR;
                const int u = e - s * per - r * lay.CPR;
                if (u < ncopy) {
                    const int bk = (int)((plus >> s) & 1u)
                                   - (int)((minus >> s) & 1u);
                    const int rs = ((s * nz) * (tj + 4) + 1 + r) * (wc + 3)
                                   + c0;
                    bsrc[i] = rs + kE * u;
                    bdst[i] = (((s * lay.R + r) * lay.BP + kE * u) << 6)
                              | (kE > 1 && u == ncopy - 1 ? 32 : 0)
                              | (int)(((emis + (unsigned)rs)
                                       & (unsigned)(kE - 1)) << 2)
                              | (bk + 1);
                }
            }
        }
    }

    // colour 0's state copies: quads 1, 2, rows [J0-1, J0+TJ], columns
    // [c0-1, ce]
    __device__ __forceinline__ void state_copies() {
        const int per = lay.R * lay.NC;
#pragma unroll
        for (int i = 0; i < kMaxS; ++i) {
            const int e = tid + i * lay.nt;
            sdst[i] = -1;
            ssrc[i] = 0;
            if (e < 2 * per) {
                const int qq = e / per, r = (e - qq * per) / lay.NC;
                const int u = e - qq * per - r * lay.NC;
                if (u < nc + 2) {
                    ssrc[i] = (((1 + qq) * nz) * (tj + 4) + 1 + r) * (wc + 4)
                              + c0 + 1 + u;
                    sdst[i] = (qq * lay.R + r) * lay.NC + u;
                }
            }
        }
    }

    // this thread's column streams: target pt (_PTARGETS order) at row y,
    // column x (seam column ci >= 0: the seam streams)
    __device__ __forceinline__ void column(int pt, int y, int x, int ci) {
        const int row = y - J0 + 1;
        if (ci < 0) {
            cps = (tj + 2) * wc;
            const T* p = piv + (size_t)(pt * 3 * nz) * cps + row * wc + x;
            cbet = p;
            cgam = p + (size_t)nz * cps;
            cud = p + (size_t)2 * nz * cps;
            crhs = rhs + (size_t)(pt * nz) * cps + row * wc + x;
        } else {
            cps = (tj + 2) * 2;
            const T* p = seam + (size_t)(pt * 3 * nz) * cps + row * 2 + ci;
            cbet = p;
            cgam = p + (size_t)nz * cps;
            cud = p + (size_t)2 * nz * cps;
            crhs = rseam + (size_t)(pt * nz) * cps + row * 2 + ci;
        }
    }

    // the copies of plane j into its stage: bands (slab s at plane j+bk),
    // colour 0's state plane j+1, this thread's bet_j, ud_{j-1}, rhs_j
    __device__ __forceinline__ void issue(int j, bool state, bool col) {
        B* stage = bring + (j % kNS) * stage_size();
        // a row's last copy holds needed values only where the row's
        // misalignment exceeds this
        const int tail = kE * ((nc + 2 * kE) / kE - 1) - nc - 2;
#pragma unroll
        for (int i = 0; i < kMaxC; ++i) {
            const int d = bdst[i];
            if (d < 0) continue;
            const int p = j + (d & 3) - 1;
            B* dst = stage + (d >> 6);
            if ((unsigned)p < (unsigned)nz) {
                int src = bsrc[i] + p * PSb;
                if constexpr (kE > 1) {
                    const int mis = (int)(((unsigned)(d >> 2)
                                           + (unsigned)(p * PSb))
                                          & (unsigned)(kE - 1));
                    if ((d & 32) && mis <= tail) continue;
                    src -= mis;
                }
                cp_async<kCopy>(dst, band + src);
            } else if constexpr (kCopy == 16) {
                *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
            } else if constexpr (kCopy == 8) {
                *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
            } else {
                *reinterpret_cast<uint32_t*>(dst) = 0u;
            }
        }
        if (state) {
            const int p = j + 1;
            T* slot = sring + ((p + 1) % kNSS) * 2 * lay.R * lay.NC;
#pragma unroll
            for (int i = 0; i < kMaxS; ++i) {
                if (sdst[i] < 0) continue;
                if (p < nz)
                    cp_async<sizeof(T)>(slot + sdst[i],
                                        st + ssrc[i] + p * PSs);
                else
                    slot[sdst[i]] = T(0);
            }
        }
        if (col) {
            T* cs = cring + (j % kNS) * 3 * lay.nt + tid;
            cp_async<sizeof(T)>(cs, cbet + (size_t)j * cps);
            if (j > 0)
                cp_async<sizeof(T)>(cs + lay.nt, cud + (size_t)(j - 1) * cps);
            cp_async<sizeof(T)>(cs + 2 * lay.nt, crhs + (size_t)j * cps);
        }
    }

    // band value of term tm at plane k for the cell (yr, xr) from stage bs
    __device__ __forceinline__ T bandv(const B* bs, const Term& tm,
                                       int k) const {
        int off = (tm.band * lay.R + yr + tm.bj - 1) * lay.BP + xr + tm.bi
                  - 1;
        if constexpr (kE > 1) {
            // the staged row's misalignment: of its first value's index
            const unsigned rs =
                ((unsigned)(tm.band * nz + k + tm.bk) * (unsigned)(tj + 4)
                 + (unsigned)(yr + tm.bj)) * (unsigned)(wc + 3)
                + (unsigned)c0 + emis;
            off += (int)(rs & (unsigned)(kE - 1));
        }
        return up(bs[off]);
    }

    // phase 0, target TGT ((0,0) or (1,1)): the off-column coupling sum at
    // plane k, the state from the ring (planes k-1..k+1) and, for the
    // plane-0 'real' terms, the staged plane 0
    template <int TGT>
    __device__ __forceinline__ T gather0(int k) const {
        const B* bs = bring + (k % kNS) * stage_size();
        const int slot = 2 * lay.R * lay.NC;
        const T* sl[3] = {sring + (k % kNSS) * slot,
                          sring + ((k + 1) % kNSS) * slot,
                          sring + ((k + 2) % kNSS) * slot};
        auto term = [&](auto mi) -> T {
            constexpr int m = decltype(mi)::value;
            constexpr Term tm = term_of(TGT, m);
            const T* src = m < kBaseKeys
                               ? sl[tm.dk + 1] + (tm.src - 1) * lay.R * lay.NC
                               : s0 + tm.src * lay.R * lay.NC;
            return bandv(bs, tm, k)
                   * src[(yr + tm.oj - 1) * lay.NC + xr + tm.oi - 1];
        };
        return sum_terms(term, k);
    }

    // phase 1, target TGT ((0,1) or (1,0)): colour 0 from the store, the
    // 'real' colour-1 siblings from the patched plane 0
    template <int TGT>
    __device__ __forceinline__ T gather1(int k) const {
        const B* bs = bring + (k % kNS) * stage_size();
        auto term = [&](auto mi) -> T {
            constexpr int m = decltype(mi)::value;
            constexpr Term tm = term_of(TGT, m);
            T v;
            if constexpr (m >= kBaseKeys)
                v = s0[(tm.src * lay.R + yr + tm.oj - 1) * lay.NC + xr
                       + tm.oi - 1];
            else if constexpr (tm.src == 0)
                v = store[(k + tm.dk + 1) * lay.SQ
                          + (yr + tm.oj - 2) * lay.SW + xr + tm.oi - 2];
            else
                v = store[(nz + 2 + k + tm.dk + 1) * lay.SQ
                          + (yr + tm.oj - 1) * lay.SW + xr + tm.oi - 1];
            return bandv(bs, tm, k) * v;
        };
        return sum_terms(term, k);
    }

    // the 12 base terms in order, then on plane 0 the 4 'real' terms
    // summed apart and added
    template <typename F>
    __device__ __forceinline__ T sum_terms(F& term, int k) const {
        T s = term(Int<0>{});
        s = s + term(Int<1>{});
        s = s + term(Int<2>{});
        s = s + term(Int<3>{});
        s = s + term(Int<4>{});
        s = s + term(Int<5>{});
        s = s + term(Int<6>{});
        s = s + term(Int<7>{});
        s = s + term(Int<8>{});
        s = s + term(Int<9>{});
        s = s + term(Int<10>{});
        s = s + term(Int<11>{});
        if (real && k == 0) {
            T x0 = term(Int<12>{});
            x0 = x0 + term(Int<13>{});
            x0 = x0 + term(Int<14>{});
            x0 = x0 + term(Int<15>{});
            s = s + x0;
        }
        return s;
    }

    // one forward Thomas step from the staged column values
    __device__ __forceinline__ T forward(T s, int k, T xk) const {
        const T* cs = cring + (k % kNS) * 3 * lay.nt + tid;
        const T r = cs[2 * lay.nt] - s;
        const T bet = cs[0];
        return k == 0 ? r * bet : (r - cs[lay.nt] * xk) * bet;
    }
};

// The back substitution x_k = col[k] - gam_k x_{k+1}, k = nz-2 .. 0, of
// a column at col[k cs] (shared memory or the outputs) with gam_k at
// gam[k gs]: its values are loaded kBack planes at a time, so a batch's
// loads are in flight together and not one round trip a plane.
constexpr int kBack = 8;

template <typename T>
__device__ __forceinline__ void back_substitute(T* __restrict__ col,
                                                size_t cs,
                                                const T* __restrict__ gam,
                                                size_t gs, int nz, T xk) {
    int k = nz - 2;
    for (; k >= kBack - 1; k -= kBack) {
        T g[kBack], c[kBack];
#pragma unroll
        for (int i = 0; i < kBack; ++i) {
            g[i] = __ldg(gam + (size_t)(k - i) * gs);
            c[i] = col[(size_t)(k - i) * cs];
        }
#pragma unroll
        for (int i = 0; i < kBack; ++i) {
            xk = c[i] - g[i] * xk;
            col[(size_t)(k - i) * cs] = xk;
        }
    }
    for (; k >= 0; --k) {
        xk = col[(size_t)k * cs] - __ldg(gam + (size_t)k * gs) * xk;
        col[(size_t)k * cs] = xk;
    }
}

template <typename T, typename B>
__global__ void __launch_bounds__(kMaxThreads)
sweep_packed_kernel(const SweepPackedArgs a, int nz, int ntiles, int tj,
                    int wc, int wn, int real, int first_chunk,
                    int last_chunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    using L = Layout<T, B>;
    Block<T, B> b(L(nz, tj, wn));
    const L lay = b.lay;
    const int tile = blockIdx.y;
    b.tid = threadIdx.x;
    b.nz = nz;
    b.tj = tj;
    b.wc = wc;
    b.H = ntiles * tj;
    b.J0 = tile * tj;
    b.c0 = blockIdx.x * wn;
    b.ce = min(b.c0 + wn, wc);
    b.nc = b.ce - b.c0;
    b.real = real;
    b.first = first_chunk;
    b.last = last_chunk;
    b.PSb = (tj + 4) * (wc + 3);
    b.PSs = (tj + 4) * (wc + 4);
    b.st = static_cast<const T*>(a.pst) + (size_t)tile * 4 * nz * b.PSs;
    b.band = static_cast<const B*>(a.pband) + (size_t)tile * 24 * nz * b.PSb;
    b.emis = (unsigned)((reinterpret_cast<uintptr_t>(b.band) / sizeof(B))
                        & (uintptr_t)(Layout<T, B>::kE - 1));
    b.piv = static_cast<const T*>(a.ppiv)
            + (size_t)tile * 12 * nz * (tj + 2) * wc;
    b.seam = static_cast<const T*>(a.pseam)
             + (size_t)tile * 6 * nz * (tj + 2) * 2;
    b.rhs = static_cast<const T*>(a.pbq)
            + (size_t)tile * 4 * nz * (tj + 2) * wc;
    b.rseam = static_cast<const T*>(a.pqs)
              + (size_t)tile * 2 * nz * (tj + 2) * 2;
    b.store = reinterpret_cast<T*>(smem);
    b.s0 = reinterpret_cast<T*>(smem + lay.store);
    b.sring = reinterpret_cast<T*>(smem + lay.store + lay.s0);
    b.bring = reinterpret_cast<B*>(smem + lay.store + lay.s0 + lay.sring);
    b.cring = reinterpret_cast<T*>(smem + lay.store + lay.s0 + lay.sring
                                   + lay.bring);
    const int tid = b.tid, J0 = b.J0, c0 = b.c0, ce = b.ce, nc = b.nc;
    const int H = b.H;
    const size_t P = (size_t)H * wc;              // output plane

    // ---- phase 0: (0,0) on rows [J0, J0+TJ] x columns [c0, ce], (1,1) on
    // rows [J0-1, J0+TJ) x columns [c0-1, ce); qi 0 / 1, store row r0 and
    // column s0c; mirror cells hold the pre-sweep state
    const int n0 = (tj + 1) * (nc + 1);
    const int qi = tid < n0 ? 0 : tid < 2 * n0 ? 1 : -1;
    const int rem = tid - (qi > 0 ? n0 : 0);
    const int r0 = qi >= 0 ? rem / (nc + 1) : 0;
    const int s0c = qi >= 0 ? rem - r0 * (nc + 1) : 0;
    const int y0 = qi == 0 ? J0 + r0 : J0 - 1 + r0;
    const int x0 = qi == 0 ? c0 + s0c : c0 - 1 + s0c;
    const bool mirror =
        qi == 0 ? (y0 == H || (b.last && x0 == wc))
                : qi == 1 && (y0 == -1 || (b.first && x0 == -1));
    const bool solve0 = qi >= 0 && !mirror;
    T* col0 = b.store + qi * (nz + 2) * lay.SQ + r0 * lay.SW + s0c;
    b.yr = y0 - (J0 - 1);
    b.xr = x0 - (c0 - 1);
    if (solve0)
        b.column(qi, y0, x0, x0 == -1 ? 0 : x0 == wc ? 1 : -1);
    // phase 1 resets the column streams before phase 0 substitutes back
    const T* gam0 = b.cgam;
    const int gps0 = b.cps;
    b.band_copies(0);
    b.state_copies();

    // the zero planes -1 and nz of the store and of the state ring, the
    // mirror cells, plane 0 of the four quads and of the ring
    if (qi >= 0) {
        col0[0] = T(0);
        col0[(nz + 1) * lay.SQ] = T(0);
        if (mirror) {
            const T* __restrict__ src =
                b.st + (size_t)((qi ? 3 : 0) * nz) * b.PSs
                + (y0 - J0 + 2) * (wc + 4) + x0 + 2;
            for (int k0 = 0; k0 < nz; k0 += kBack) {
                T v[kBack];
#pragma unroll
                for (int i = 0; i < kBack; ++i)
                    if (k0 + i < nz)
                        v[i] = __ldg(src + (size_t)(k0 + i) * b.PSs);
#pragma unroll
                for (int i = 0; i < kBack; ++i)
                    if (k0 + i < nz) col0[(k0 + i + 1) * lay.SQ] = v[i];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kMaxS; ++i) {
        if (b.sdst[i] < 0) continue;
        b.sring[b.sdst[i]] = T(0);
        cp_async<sizeof(T)>(b.sring + 2 * lay.R * lay.NC + b.sdst[i],
                            b.st + b.ssrc[i]);
    }
    for (int e = tid; e < 4 * lay.R * lay.NC; e += lay.nt) {
        const int q = e / (lay.R * lay.NC);
        const int r = (e - q * lay.R * lay.NC) / lay.NC;
        const int u = e - q * lay.R * lay.NC - r * lay.NC;
        if (u < nc + 2)
            cp_async<sizeof(T)>(b.s0 + e, b.st + (size_t)(q * nz) * b.PSs
                                              + (1 + r) * (wc + 4) + c0 + 1
                                              + u);
    }
    for (int j = 0; j < kAhead; ++j) {
        if (j < nz) b.issue(j, true, solve0);
        cp_commit();
    }
    T xk = T(0);
    for (int k = 0; k < nz; ++k) {
        cp_wait_stage();
        __syncthreads();
        if (k + kAhead < nz) b.issue(k + kAhead, true, solve0);
        cp_commit();
        if (solve0) {
            const T s = qi == 0 ? b.template gather0<0>(k)
                                : b.template gather0<3>(k);
            xk = b.forward(s, k, xk);
            col0[(k + 1) * lay.SQ] = xk;
        }
    }
    cp_wait_all();
    // every stage read: phase 1's first planes go in flight while phase 0
    // substitutes back
    __syncthreads();
    const int w1 = nc;
    const int t1 = tid < tj * w1 ? 1 : tid < 2 * tj * w1 ? 2 : 0;
    const int rem1 = tid - (t1 == 2 ? tj * w1 : 0);
    const int y1 = t1 ? J0 + rem1 / max(w1, 1) : 0;
    const int x1 = t1 ? c0 + rem1 - (y1 - J0) * w1 : 0;
    b.band_copies(1);
    if (t1) b.column(t1 == 1 ? 2 : 3, y1, x1, -1);
    for (int j = 0; j < kAhead; ++j) {
        if (j < nz) b.issue(j, false, t1 != 0);
        cp_commit();
    }
    if (solve0) {
        back_substitute(col0 + lay.SQ, (size_t)lay.SQ, gam0, (size_t)gps0, nz,
                        xk);
        if (y0 >= J0 && y0 < J0 + tj && x0 >= c0 && x0 < ce) {
            T* __restrict__ o = static_cast<T*>(a.out[qi ? 3 : 0])
                                + (size_t)y0 * wc + x0;
            const T* __restrict__ c = col0 + lay.SQ;
            for (int k = 0; k < nz; ++k) o[k * P] = c[k * lay.SQ];
        }
    }
    // every colour-0 value of the store is written
    __syncthreads();
    // the e1 halo rules on the plane-0 window of the colour-1 siblings
    // ((0,1) quad 1, (1,0) quad 2) where the 'real' terms read them
    for (int e = tid; e < 2 * lay.R * lay.NC; e += lay.nt) {
        const int qq = e / (lay.R * lay.NC);
        const int rr = (e - qq * lay.R * lay.NC) / lay.NC;
        const int u = e - qq * lay.R * lay.NC - rr * lay.NC;
        const int Y = J0 - 1 + rr, X = c0 - 1 + u;
        if (u >= nc + 2) continue;
        T* cell = b.s0 + (1 + qq) * lay.R * lay.NC + rr * lay.NC + u;
        const T* p0 = b.store + lay.SQ;                     // (0,0), plane 0
        const T* p1 = b.store + (nz + 3) * lay.SQ;          // (1,1), plane 0
        if (qq == 1) {                                       // (1,0)
            if (Y == -1) {
                if (X >= c0 && X <= ce) *cell = p0[0 * lay.SW + X - c0];
            } else if (b.last && X == wc) {
                if (Y <= J0 + tj - 1)
                    *cell = p1[(Y - J0 + 1) * lay.SW + wc - c0];
            }
        } else {                                             // (0,1)
            if (Y == H) {
                if (X <= ce - 1)
                    *cell = p1[(H - J0) * lay.SW + X - c0 + 1];
            } else if (b.first && X == -1) {
                if (Y >= J0) *cell = p0[(Y - J0) * lay.SW];
            }
        }
    }

    // ---- phase 1: (0,1) and (1,0) on rows [J0, J0+TJ) x columns [c0, ce)
    b.yr = y1 - J0 + 1;
    b.xr = x1 - c0 + 1;
    T* o1 = static_cast<T*>(a.out[t1]) + (size_t)y1 * wc + x1;
    for (int k = 0; k < nz; ++k) {
        cp_wait_stage();
        __syncthreads();
        if (k + kAhead < nz) b.issue(k + kAhead, false, t1 != 0);
        cp_commit();
        if (t1) {
            const T s = t1 == 1 ? b.template gather1<1>(k)
                                : b.template gather1<2>(k);
            xk = b.forward(s, k, xk);
            o1[k * P] = xk;
        }
    }
    cp_wait_all();
    if (t1) back_substitute(o1, P, b.cgam, (size_t)b.cps, nz, xk);
}

// The launch plan of one chunk sweep at the window WN the caller chose
// (sweep_packed.window_plan) and the shared memory it reckoned for it:
// threads per block, dynamic shared memory, resident blocks per SM.  A
// window wider than the chunk, one that does not fit, or a shared-memory
// size other than this layout's is refused.
struct PackedPlan {
    int nt, per_sm;
    size_t smem;
};

template <typename T, typename B>
cudaError_t plan_packed(int nz, int tj, int wc, int wn, int smem,
                        PackedPlan& pl) {
    if (nz < 2 || tj < 1 || wn < 1 || wn > wc) return cudaErrorInvalidValue;
    const Layout<T, B> lay(nz, tj, wn);
    if (!lay.fits() || lay.bytes != (size_t)smem)
        return cudaErrorInvalidValue;
    const void* kern =
        reinterpret_cast<const void*>(&sweep_packed_kernel<T, B>);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            lay.nt,
                                                            lay.bytes);
    if (err != cudaSuccess) return err;
    pl.nt = lay.nt;
    pl.per_sm = per_sm;
    pl.smem = lay.bytes;
    return cudaSuccess;
}

template <typename T, typename B>
int launch_sweep_packed(const SweepPackedArgs* a, int nz, int ntiles, int tj,
                        int wc, int wn, int smem, int real, int first_chunk,
                        int last_chunk, void* stream) {
    if (ntiles < 1 || ntiles > 65535) return (int)cudaErrorInvalidValue;
    PackedPlan pl;
    cudaError_t err = plan_packed<T, B>(nz, tj, wc, wn, smem, pl);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((wc + wn - 1) / wn, ntiles);
    sweep_packed_kernel<T, B><<<grid, pl.nt, pl.smem,
                                static_cast<cudaStream_t>(stream)>>>(
        *a, nz, ntiles, tj, wc, wn, real, first_chunk, last_chunk);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K9

constexpr int kPackThreads = 128;

// one output row of `width` values by one warp: 16-byte copies where the
// source and destination share their alignment (four loads in flight a
// thread), element copies elsewhere
template <typename T>
__device__ __forceinline__ void copy_row(T* __restrict__ dp,
                                         const T* __restrict__ sp, int width,
                                         int lane) {
    constexpr int V = 16 / sizeof(T);
    const uintptr_t sa = reinterpret_cast<uintptr_t>(sp);
    const uintptr_t da = reinterpret_cast<uintptr_t>(dp);
    if (((sa ^ da) & 15u) == 0) {
        int head = (int)(((16u - (da & 15u)) & 15u) / sizeof(T));
        head = head < width ? head : width;
        if (lane < head) dp[lane] = sp[lane];
        const int nv = (width - head) / V;
        const int4* __restrict__ s4 = reinterpret_cast<const int4*>(sp + head);
        int4* __restrict__ d4 = reinterpret_cast<int4*>(dp + head);
        int i = lane;
        for (; i + 96 < nv; i += 128) {
            const int4 v0 = s4[i], v1 = s4[i + 32], v2 = s4[i + 64],
                       v3 = s4[i + 96];
            d4[i] = v0;
            d4[i + 32] = v1;
            d4[i + 64] = v2;
            d4[i + 96] = v3;
        }
        for (; i < nv; i += 32) d4[i] = s4[i];
        for (int i = head + nv * V + lane; i < width; i += 32) dp[i] = sp[i];
    } else {
        for (int i = lane; i < width; i += 32) dp[i] = sp[i];
    }
}

// main mode: block (slab plane sk, tile); warps over (chunk, row)
template <typename T>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const PackArgs a, int C, int nz, int Hp, int Wp, int tj,
            int rows, int wc, int width) {
    const int sk = blockIdx.x, tile = blockIdx.y;
    const int s = sk / nz, k = sk - s * nz;
    const T* src = static_cast<const T*>(a.src[s])
                   + ((size_t)k * Hp + (size_t)tile * tj) * Wp;
    const size_t ob = ((size_t)tile * gridDim.x + sk) * rows * width;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int pr = warp; pr < C * rows; pr += kPackThreads / 32) {
        const int ch = pr / rows, r = pr - ch * rows;
        copy_row<T>(static_cast<T*>(a.dst[ch]) + ob + r * width,
                    src + r * Wp + ch * wc, width, lane);
    }
}

// seam mode: one thread per output row o of chunk blockIdx.y, its values
// at columns c WC and c WC + WC + 1
template <typename T>
__global__ void __launch_bounds__(kPackThreads)
pack_seam_kernel(const PackArgs a, int S, int nz, int Hp, int Wp, int tj,
                 int rows, int wc, int per) {
    const int o = blockIdx.x * kPackThreads + threadIdx.x;
    if (o >= per) return;
    const int ch = blockIdx.y;
    const int q = o / rows, r = o - q * rows;
    const int sk = q % (S * nz), tile = q / (S * nz);
    const int s = sk / nz, k = sk - s * nz;
    const T* sp = static_cast<const T*>(a.src[s])
                  + ((size_t)k * Hp + tile * tj + r) * Wp + ch * wc;
    T* dp = static_cast<T*>(a.dst[ch]) + (size_t)o * 2;
    const T v0 = sp[0], v1 = sp[wc + 1];
    dp[0] = v0;
    dp[1] = v1;
}

template <typename T>
int launch_pack(const PackArgs* a, int S, int C, int nz, int Hp, int Wp,
                int tj, int rows, int wc, int wpad, int ntiles,
                void* stream) {
    if (S < 1 || S > 8 || C < 1 || C > 64 || ntiles < 1 || ntiles > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wpad < 0) {
        const long long per = (long long)ntiles * S * nz * rows;
        if (per > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        const dim3 grid((unsigned)((per + kPackThreads - 1) / kPackThreads),
                        C);
        pack_seam_kernel<T><<<grid, kPackThreads, 0, st>>>(
            *a, S, nz, Hp, Wp, tj, rows, wc, (int)per);
    } else {
        const dim3 grid(S * nz, ntiles);
        pack_kernel<T><<<grid, kPackThreads, 0, st>>>(
            *a, C, nz, Hp, Wp, tj, rows, wc, wc + wpad);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_sweep_packed_f32(const SweepPackedArgs* a, int nz, int ntiles, int tj,
                        int wc, int wn, int smem, int real, int first_chunk,
                        int last_chunk, void* stream) {
    return launch_sweep_packed<float, float>(a, nz, ntiles, tj, wc, wn, smem,
                                             real, first_chunk, last_chunk,
                                             stream);
}

int mg_sweep_packed_f64(const SweepPackedArgs* a, int nz, int ntiles, int tj,
                        int wc, int wn, int smem, int real, int first_chunk,
                        int last_chunk, void* stream) {
    return launch_sweep_packed<double, double>(a, nz, ntiles, tj, wc, wn,
                                               smem, real, first_chunk,
                                               last_chunk, stream);
}

int mg_sweep_packed_bf16(const SweepPackedArgs* a, int nz, int ntiles,
                         int tj, int wc, int wn, int smem, int real,
                         int first_chunk, int last_chunk, void* stream) {
    return launch_sweep_packed<float, __nv_bfloat16>(
        a, nz, ntiles, tj, wc, wn, smem, real, first_chunk, last_chunk,
        stream);
}

// The plan a launch of instance `inst` (0: f32, 1: f64, 2: bf16, the
// entries above in order) takes at (nz, TJ, WC) with window WN and SMEM
// bytes of shared memory: out = {threads, dynamic shared memory bytes,
// resident blocks per SM}.
int mg_sweep_packed_plan(int inst, int nz, int tj, int wc, int wn, int smem,
                         int* out) {
    PackedPlan pl;
    cudaError_t err;
    switch (inst) {
        case 0:
            err = plan_packed<float, float>(nz, tj, wc, wn, smem, pl);
            break;
        case 1:
            err = plan_packed<double, double>(nz, tj, wc, wn, smem, pl);
            break;
        case 2:
            err = plan_packed<float, __nv_bfloat16>(nz, tj, wc, wn, smem,
                                                    pl);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    out[0] = pl.nt;
    out[1] = (int)pl.smem;
    out[2] = pl.per_sm;
    return 0;
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
