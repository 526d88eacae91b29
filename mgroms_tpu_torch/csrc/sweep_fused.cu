// The colour-fused red-black sweep for Hopper (sm_90a): one launch per
// smoother sweep of a quad-parity level, colour 0 then colour 1.
//
// Replaces mgroms_tpu/ops/pallas/sweep_fused.py:_sweep_chunk (called by
// relax_fused_sweep) and computes, term for term and in the same operation
// order, what its plain version (ops/kernels/sweep_fused.
// relax_fused_sweep_plain, i.e. relax_compact_quads) computes: per colour,
// the 12-term gather (14 with 'real') through the quad halo extension of
// the state that colour reads (relax_compact.extend_quads), then the
// factored Thomas solve with gam = ud * bet recomputed.
//
// What bounds it: memory.  Per column and plane a colour reads 12 operator
// values, 12 state values, the RHS, ud and bet, and writes the solution
// (~2 flops per value read).  The design, per thing that held the first
// port back:
//
// - The operator is read as the TPU kernel reads it: the 24 halo-extended
//   band quads of bands 3..8 (relax_compact.band_quads), stacked in one
//   array with a zero plane before and after each band quad (_kshift's
//   padding, so no plane test is made) and rows padded to a 16-byte pitch
//   (relax_compact.band_layout), so that a tile row of a band quad is one
//   aligned span.  In one colour each band quad is read once (its other
//   term belongs to the other colour's target), so a sweep reads each
//   twice: the colour barrier below keeps the colours apart, and a tile's
//   bands over all planes would need ~13x a block's shared memory to carry
//   over it.
// - The Thomas recurrence stays on chip: the forward values and the
//   back-substitution multipliers c = ud * bet of each column live in
//   shared memory, so `out` is written once and ud and bet read once.
// - Latency is hidden by asynchronous staging over k.  A block owns a tile
//   of kCols columns x (threads / kCols) rows of one target, one thread
//   per column.  While plane k is solved, planes k+1 .. k+A are in flight
//   (cp.async, LDGSTS), A the ring depth: the block's 12 band tiles of a
//   plane, each tile row (kCols + one 16-byte column of values) in
//   16-byte copies that bypass L1, into a ring of band_stages(A) stages;
//   each thread's RHS, bet and ud into its own ring of col_stages(A); and
//   the state window of planes .. k+A+1 into a ring of win_planes(A)
//   planes: the two quads of the other colour that the 12 terms read,
//   (rows + 2) x (kCols + 2) each, each value staged once and read by up
//   to six terms of three planes.  The window and column values are
//   4-byte copies through L1 (staging them as 16-byte chunks that bypass
//   it measured slower on the H100).  One block barrier per plane
//   publishes a plane's stages and frees the oldest.
// - The ring depth is part of the launch plan (plan_sweep): the block size
//   and the resident blocks are those of the shallow ring (kMinAhead, 2
//   planes), and the deep ring (kMaxAhead, 7) is taken where a block's
//   shared memory still fits it and the SM still holds as many blocks:
//   never a block for depth.  Where a column's Thomas arrays take most of
//   a block (float32 at nz 128: 131,072 B of 174,464, one block an SM)
//   the room they leave holds 5 more stages; where two or more blocks
//   share an SM the deep ring would mostly cost one.  The two depths are
//   two walks.  With the shallow ring a block takes its tiles one at a
//   time.  With the deep ring it walks its tiles of a target as one run: the next tile's first
//   planes are staged before this tile's back substitution, which reads
//   only the column's own Thomas arrays, so they land while it runs; and
//   its kernel may take the registers of one block an SM, which shorten a
//   plane.  (The run walk at the shallow depth measured as fast as the
//   deep ring at nz 128, but 20 % slower in float64 on bfloat16 bands at
//   nz 64.)  Only when a plane's copies are issued changes with the
//   depth, not what is computed.  Each depth is a kernel of its own, in a
//   namespace of its own, so that each keeps the name sweep_kernel<T, B>
//   that the profiler's kernel table and the graph census read.
// - Few instructions a value: the term recipe is compiled in (the kernel
//   is instantiated per target quad), and the stages are laid out so that
//   a term's band and state values sit at a compile-time offset from one
//   per-thread address each: two shared loads, a multiply and an add a
//   term.  Per column only 32-bit offsets are live.
//
// The domain-edge halo is the index rule of extend_quads (halo_map),
// applied where a window value is staged: its source quad, row and column
// come from the rule, so the staged window is the extended quad.  Colour
// dependency: a cooperative launch.  Colour 0 updates (0,0), (1,1) from
// the pre-sweep quads into their outputs; a grid barrier; colour 1 updates
// (0,1), (1,0), reading colour 0's new values from those outputs and the
// colour-1 quads' pre-sweep values from the inputs.  The plane-0 'real'
// couplings (4 terms, one plane) are read in place.  Instances, by
// (state, bands): (float, float), (double, double), (float, bfloat16)
// and (double, bfloat16); bfloat16 bands are the low-precision smoother
// operator, widened to the state type at read (exactly, as the plain
// version's .to(dtype)).  In double a column's Thomas arrays take
// 2 * nz * 8 bytes of shared memory: at nz 64 the launcher's halving
// loop lands on 128 threads and one block per SM with either band type,
// a ring 2 deep with either (mg_sweep_fused_plan reports the plan it
// picks).
//
// Rounding: built with -fmad=false (0 ulp from the plain version).
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the launch's CUDA error code (cudaErrorInvalidValue
// when one column's planes do not fit a block's shared memory).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "quad_terms.cuh"

namespace cg = cooperative_groups;

// Pointers of one sweep, per quad in _TKEYS order (0,0), (0,1), (1,0),
// (1,1): the pre-sweep state, the RHS, ud, bet and the output; and the
// start of the band stack's storage (relax_compact.band_quads: 24 band
// quads x (nz + 2) planes x (H + 2) rows of `pitch` values, extended
// column C at storage column C + 16 / sizeof(value) - 1).
struct SweepArgs {
    const void* q[4];
    const void* bq[4];
    const void* band;
    const void* ud[4];
    const void* bet[4];
    void* out[4];
};

namespace {

// ------------------------------------------------------------ the staging

// The depths of the ring (planes staged ahead of the solved one): the
// shallow one, which sizes the block, and the deep one the plan takes
// where it keeps the blocks; kDeepAhead, the deepest ring a 64-plane
// float32 column fits one block, is taken only when a caller asks for it
// (a timing), in float32 only
constexpr int kMinAhead = 2;
constexpr int kMaxAhead = 7;
constexpr int kDeepAhead = 13;

// the rings of a depth: a column's own RHS, bet and ud, planes k .. k + A
__host__ __device__ constexpr int col_stages(int ahead) { return ahead + 1; }
// the block's band tiles: planes k .. k + A, and one more so a stage is
// refilled only a block barrier after its last read
__host__ __device__ constexpr int band_stages(int ahead) { return ahead + 2; }
// window planes live at once: k - 1 .. k + A + 1, and one more
__host__ __device__ constexpr int win_planes(int ahead) { return ahead + 4; }
// tile width (the band stack's tile): two warps walk one tile row
constexpr int kCols = kBandTile;
constexpr int kWW = kCols + 2;         // window row: the tile's columns + halo
constexpr int kMaxThreads = 128;
constexpr int kMaxWinSlots = 7;        // window values a thread stages a plane
// shared memory a block may take, less the static tables
constexpr size_t kMaxDynSmem = 227 * 1024 - 4096;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

// 16 bytes into shared memory, bypassing L1 (whose few lines are left to
// the 4-byte copies)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest A groups landed
template <int A>
__device__ __forceinline__ void cp_wait_ahead() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(A) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void stage(T* slot, const T* src) {
    cp_async<sizeof(T)>(slot, src);
}

// extend_quads along one axis: extended index X (0..n+1) of a quad of
// parity a with n interior points reads quad parity sa at index x.  Index 0
// is the -1 mirror (parity 0, index 0), n+1 the n mirror (parity 1, index
// n-1).
__device__ __forceinline__ void halo_map(int a, int X, int n, int& sa,
                                         int& x) {
    if (X == 0) {
        sa = 0;
        x = 0;
    } else if (X == n + 1) {
        sa = 1;
        x = n - 1;
    } else {
        sa = a;
        x = X - 1;
    }
}

template <typename T, typename B>
struct Params {
    const T* q[4];
    const T* bq[4];
    const B* band;
    const T* ud[4];
    const T* bet[4];
    T* out[4];
    int nz, H, W, real;
};

// The pointers a thread picks by a runtime index, in shared memory (a
// kernel parameter array indexed so would be copied to local memory).
template <typename T>
struct Tables {
    const T* src[2][4];    // the quads each colour reads
};

// The block's dynamic shared memory for nt threads (rows = nt / kCols tile
// rows) and a ring `ahead` planes deep: per thread the column ring (RHS,
// bet, ud of col_stages planes) and the column's forward values and
// back-substitution multipliers over nz planes; per block the window ring
// (win_planes planes of [rows + 2][2 quads][kWW]) and the band ring
// (band_stages stages of [rows][12 terms][span], tile rows of 16-byte
// multiples).
template <typename T, typename B>
struct Smem {
    T* cv;     // [col_stages][3][nt]: RHS, bet, ud
    T* xs;     // [nz][nt]
    T* cs;     // [nz][nt]
    T* win;    // [win_planes][rows + 2][2][kWW]
    B* bs;     // [band_stages][rows][kBaseKeys][span]

    __host__ __device__ static int win_plane(int rows) {
        return (rows + 2) * 2 * kWW;
    }
    __host__ __device__ static int band_stage(int rows) {
        return rows * kBaseKeys * BandLayout<B>::span;
    }
    __host__ __device__ static size_t tail(int nz, int nt, int ahead) {
        const size_t t =
            (size_t)nt * (col_stages(ahead) * 3 + 2 * (size_t)nz)
            + win_planes(ahead) * (size_t)win_plane(nt / kCols);
        return (t * sizeof(T) + 15) / 16 * 16;
    }
    static size_t bytes(int nz, int nt, int ahead) {
        return tail(nz, nt, ahead)
               + band_stages(ahead) * (size_t)band_stage(nt / kCols)
                     * sizeof(B);
    }
    __device__ Smem(unsigned char* base, int nz, int nt, int ahead) {
        cv = reinterpret_cast<T*>(base);
        xs = cv + (size_t)col_stages(ahead) * 3 * nt;
        cs = xs + (size_t)nz * nt;
        win = cs + (size_t)nz * nt;
        bs = reinterpret_cast<B*>(base + tail(nz, nt, ahead));
    }
};

// One RB colour update of target quad TG, with the shallow ring, for the
// tile whose first column is (J0, I0); every thread of the block takes
// part (it stages and meets the barriers), the threads of columns inside
// the quad solve.
template <typename T, typename B, int TG>
__device__ __forceinline__ void update_tile(
        const Params<T, B>& p, const Tables<T>& tb, const Smem<T, B>& sm,
        int colour, int J0, int I0) {
    using L = BandLayout<B>;
    constexpr int kAhead = kMinAhead;
    constexpr int kColStages = col_stages(kAhead);
    constexpr int kBandStages = band_stages(kAhead);
    constexpr int kWinPlanes = win_planes(kAhead);
    const T* const* src = tb.src[colour];
    const int nz = p.nz, H = p.H, W = p.W;
    const int nt = blockDim.x, tid = threadIdx.x, rows = nt / kCols;
    const int jj = tid / kCols, ii = tid % kCols;
    const int J = J0 + jj, I = I0 + ii;
    const bool active = J < H && I < W;
    const uint32_t P = (uint32_t)H * W;
    const int pitch = L::pitch(W);
    const uint32_t PB = (uint32_t)(H + 2) * pitch;     // a band plane
    const uint32_t col = active ? (uint32_t)J * W + I : 0;
    const int wplane = Smem<T, B>::win_plane(rows);
    const int bstage = Smem<T, B>::band_stage(rows);
    // the window quads: the target's row sibling (1-a, b) and column
    // sibling (a, 1-b), the quads of the other colour the 12 terms read
    constexpr int a = TG >> 1, b = TG & 1;
    constexpr int wq0 = 2 * (1 - a) + b, wq1 = 2 * a + (1 - b);

    // this thread's share of a band stage: 16-byte chunks of the tile
    // rows of the 12 terms; rows past the extended quad are never read
    // and not copied.  A block of nt threads has nt / kCols tile rows, so
    // the share is the same for every block size.
    constexpr int kBandSlots = (kBaseKeys * L::chunks + kCols - 1) / kCols;
    constexpr uint32_t kNone = ~0u;
    const int nchunks = rows * kBaseKeys * L::chunks;
    uint32_t bsrc[kBandSlots];
#pragma unroll
    for (int i = 0; i < kBandSlots; ++i) {
        const int c = tid + i * nt;
        bsrc[i] = kNone;
        if (c < nchunks) {
            const int q = c % L::chunks, rm = c / L::chunks;
            const int jc = rm / kBaseKeys, mc = rm % kBaseKeys;
            const Term tm = term_of(TG, mc);
            const int R = J0 + jc + tm.bj;
            if (R <= H + 1)
                bsrc[i] = ((uint32_t)tm.band * (nz + 2) + tm.bk + 1) * PB
                          + (uint32_t)R * pitch + I0 + (q + 1) * L::e16;
        }
    }
    auto stage_bands = [&](int kc) {
        if (kc >= nz) return;
        B* dst = sm.bs + (kc % kBandStages) * bstage;
        const uint32_t kp = (uint32_t)kc * PB;
#pragma unroll
        for (int i = 0; i < kBandSlots; ++i) {
            if (bsrc[i] != kNone)
                cp_async16(dst + (size_t)(tid + i * nt) * L::e16,
                           p.band + (bsrc[i] + kp));
        }
    };
    // this thread's share of a window plane: source quad and offset, by
    // the halo rule (-1: outside the extended quad, never read)
    int wsrc[kMaxWinSlots], woff[kMaxWinSlots];
#pragma unroll
    for (int i = 0; i < kMaxWinSlots; ++i) {
        const int e = tid + i * nt;
        wsrc[i] = -1;
        woff[i] = 0;
        if (e < wplane) {
            const int wr = e / (2 * kWW), w = (e / kWW) % 2, wc = e % kWW;
            const int R = J0 + wr, C = I0 + wc;
            if (R <= H + 1 && C <= W + 1) {
                const int qd = w ? wq1 : wq0;
                int sa, r, sb, c;
                halo_map(qd >> 1, R, H, sa, r);
                halo_map(qd & 1, C, W, sb, c);
                wsrc[i] = 2 * sa + sb;
                woff[i] = r * W + c;
            }
        }
    }
    auto wslot = [&](int kk) -> T* {
        return sm.win + (size_t)((kk + kWinPlanes) % kWinPlanes) * wplane;
    };
    // window plane kk (-1 and nz: zeros, as _kshift pads)
    auto stage_window = [&](int kk) {
        if (kk > nz) return;
        T* dst = wslot(kk) + tid;
        if (kk < 0 || kk == nz) {
#pragma unroll
            for (int i = 0; i < kMaxWinSlots; ++i)
                if (wsrc[i] >= 0) dst[i * nt] = T(0);
            return;
        }
        const size_t kp = (size_t)kk * P;
#pragma unroll
        for (int i = 0; i < kMaxWinSlots; ++i)
            if (wsrc[i] >= 0) stage(dst + i * nt, src[wsrc[i]] + kp + woff[i]);
    };
    // the column's RHS, bet and ud of plane kc
    auto stage_column = [&](int kc) {
        if (!active || kc >= nz) return;
        const size_t o = (size_t)kc * P + col;
        T* cv = sm.cv + (size_t)(kc % kColStages) * 3 * nt + tid;
        stage(cv, p.bq[TG] + o);
        stage(cv + nt, p.bet[TG] + o);
        if (kc < nz - 1) stage(cv + 2 * nt, p.ud[TG] + o);
    };
    // group g: window plane g + kAhead + 1, band and column plane g + kAhead
    stage_window(-1);
    stage_window(0);
    for (int g = -kAhead; g < 0; ++g) {
        stage_window(g + kAhead + 1);
        stage_bands(g + kAhead);
        stage_column(g + kAhead);
        cp_commit();
    }
    // a term's values sit at compile-time offsets from the thread's own
    // places in a band stage and in the window planes k - 1, k, k + 1
    const int bthread = jj * kBaseKeys * L::span + ii - 1;
    const int wthread = jj * 2 * kWW + ii;
    T x = T(0), udp = T(0);
    for (int k = 0; k < nz; ++k) {
        stage_window(k + kAhead + 1);
        stage_bands(k + kAhead);
        stage_column(k + kAhead);
        cp_commit();
        cp_wait_ahead<kAhead>();
        __syncthreads();
        if (!active) continue;
        const B* bst = sm.bs + (k % kBandStages) * bstage + bthread;
        const T* wk[3] = {wslot(k - 1) + wthread, wslot(k) + wthread,
                          wslot(k + 1) + wthread};
        auto value = [&](auto mi) -> T {
            constexpr Term tm = term_of(TG, decltype(mi)::value);
            constexpr int w = tm.src == wq0 ? 0 : 1;
            return up(bst[decltype(mi)::value * L::span + tm.bi])
                   * wk[tm.dk + 1][tm.oj * 2 * kWW + w * kWW + tm.oi];
        };
        T s = value(Int<0>{});
        s = s + value(Int<1>{});
        s = s + value(Int<2>{});
        s = s + value(Int<3>{});
        s = s + value(Int<4>{});
        s = s + value(Int<5>{});
        s = s + value(Int<6>{});
        s = s + value(Int<7>{});
        s = s + value(Int<8>{});
        s = s + value(Int<9>{});
        s = s + value(Int<10>{});
        s = s + value(Int<11>{});
        if (p.real && k == 0) {
            // the plane-0 'real' couplings, read in place (one plane)
            T x0 = T(0);
#pragma unroll
            for (int m = kBaseKeys; m < kTerms; ++m) {
                const Term tm = term_of(TG, m);
                int sa, r, sb, c;
                halo_map(tm.src >> 1, J + tm.oj, H, sa, r);
                halo_map(tm.src & 1, I + tm.oi, W, sb, c);
                const T sv = (tm.dk < 0 || tm.dk >= nz)
                    ? T(0) : src[2 * sa + sb][(size_t)tm.dk * P + r * W + c];
                const uint32_t bo =
                    ((uint32_t)tm.band * (nz + 2) + tm.bk + 1) * PB
                    + (uint32_t)(J + tm.bj) * pitch + L::lpad + I + tm.bi;
                const T tv = up(p.band[bo]) * sv;
                x0 = (m == kBaseKeys) ? tv : x0 + tv;
            }
            s = s + x0;
        }
        const T* cv = sm.cv + (size_t)(k % kColStages) * 3 * nt + tid;
        const T rhs = cv[0] - s;
        const T bet = cv[nt];
        x = (k == 0) ? rhs * bet : (rhs - udp * x) * bet;
        sm.xs[(size_t)k * nt + tid] = x;
        if (k < nz - 1) {
            udp = cv[2 * nt];
            sm.cs[(size_t)k * nt + tid] = udp * bet;
        }
    }
    cp_wait_all();
    if (!active) return;
    T* out = p.out[TG];
    out[(size_t)(nz - 1) * P + col] = x;
    for (int k = nz - 2; k >= 0; --k) {
        x = sm.xs[(size_t)k * nt + tid] - sm.cs[(size_t)k * nt + tid] * x;
        out[(size_t)k * P + col] = x;
    }
}


// One RB colour update of target quad TG, with a ring A planes deep, on
// this block's run of the target's tiles: first, first + gridDim.x, ...
// below `count` (tiles_i a tile row of blockDim.x / kCols rows).  Every
// thread of the block takes part (it stages and meets the barriers), the
// threads of columns inside the quad solve.  The next tile's first planes
// are staged before this tile's back substitution, which reads only the
// column's own Thomas arrays, so they land while it runs.
template <typename T, typename B, int A, int TG>
__device__ __forceinline__ void update_run(
        const Params<T, B>& p, const Tables<T>& tb, const Smem<T, B>& sm,
        int colour, int first, int count, int tiles_i) {
    using L = BandLayout<B>;
    constexpr int kColStages = col_stages(A);
    constexpr int kBandStages = band_stages(A);
    constexpr int kWinPlanes = win_planes(A);
    static_assert(A > kMinAhead, "the shallow ring walks a tile at a time");
    const T* const* src = tb.src[colour];
    const int nz = p.nz, H = p.H, W = p.W;
    const int nt = blockDim.x, tid = threadIdx.x, rows = nt / kCols;
    const int jj = tid / kCols, ii = tid % kCols;
    const uint32_t P = (uint32_t)H * W;
    const int pitch = L::pitch(W);
    const uint32_t PB = (uint32_t)(H + 2) * pitch;     // a band plane
    const int wplane = Smem<T, B>::win_plane(rows);
    const int bstage = Smem<T, B>::band_stage(rows);
    // the window quads: the target's row sibling (1-a, b) and column
    // sibling (a, 1-b), the quads of the other colour the 12 terms read
    constexpr int a = TG >> 1, b = TG & 1;
    constexpr int wq0 = 2 * (1 - a) + b, wq1 = 2 * a + (1 - b);
    // this thread's share of a band stage: 16-byte chunks of the tile
    // rows of the 12 terms; rows past the extended quad are never read
    // and not copied.  A block of nt threads has nt / kCols tile rows, so
    // the share is the same for every block size.
    constexpr int kBandSlots = (kBaseKeys * L::chunks + kCols - 1) / kCols;
    constexpr uint32_t kNone = ~0u;
    const int nchunks = rows * kBaseKeys * L::chunks;

    // the tile's first column (J0, I0), this thread's column, its band
    // chunks' sources and its window values' source quads and offsets (by
    // the halo rule; -1: outside the extended quad, never read)
    int J0, I0, J, I;
    bool active;
    uint32_t col;
    uint32_t bsrc[kBandSlots];
    int wsrc[kMaxWinSlots], woff[kMaxWinSlots];
    auto set_tile = [&](int rt) {
        J0 = (rt / tiles_i) * rows;
        I0 = (rt % tiles_i) * kCols;
        J = J0 + jj;
        I = I0 + ii;
        active = J < H && I < W;
        col = active ? (uint32_t)J * W + I : 0;
#pragma unroll
        for (int i = 0; i < kBandSlots; ++i) {
            const int c = tid + i * nt;
            bsrc[i] = kNone;
            if (c < nchunks) {
                const int q = c % L::chunks, rm = c / L::chunks;
                const int jc = rm / kBaseKeys, mc = rm % kBaseKeys;
                const Term tm = term_of(TG, mc);
                const int R = J0 + jc + tm.bj;
                if (R <= H + 1)
                    bsrc[i] = ((uint32_t)tm.band * (nz + 2) + tm.bk + 1) * PB
                              + (uint32_t)R * pitch + I0 + (q + 1) * L::e16;
            }
        }
#pragma unroll
        for (int i = 0; i < kMaxWinSlots; ++i) {
            const int e = tid + i * nt;
            wsrc[i] = -1;
            woff[i] = 0;
            if (e < wplane) {
                const int wr = e / (2 * kWW), w = (e / kWW) % 2;
                const int wc = e % kWW;
                const int R = J0 + wr, C = I0 + wc;
                if (R <= H + 1 && C <= W + 1) {
                    const int qd = w ? wq1 : wq0;
                    int sa, r, sb, c;
                    halo_map(qd >> 1, R, H, sa, r);
                    halo_map(qd & 1, C, W, sb, c);
                    wsrc[i] = 2 * sa + sb;
                    woff[i] = r * W + c;
                }
            }
        }
    };
    auto stage_bands = [&](int kc) {
        if (kc >= nz) return;
        B* dst = sm.bs + (kc % kBandStages) * bstage;
        const uint32_t kp = (uint32_t)kc * PB;
#pragma unroll
        for (int i = 0; i < kBandSlots; ++i) {
            if (bsrc[i] != kNone)
                cp_async16(dst + (size_t)(tid + i * nt) * L::e16,
                           p.band + (bsrc[i] + kp));
        }
    };
    auto wslot = [&](int kk) -> T* {
        return sm.win + (size_t)((kk + kWinPlanes) % kWinPlanes) * wplane;
    };
    // window plane kk (-1 and nz: zeros, as _kshift pads)
    auto stage_window = [&](int kk) {
        if (kk > nz) return;
        T* dst = wslot(kk) + tid;
        if (kk < 0 || kk == nz) {
#pragma unroll
            for (int i = 0; i < kMaxWinSlots; ++i)
                if (wsrc[i] >= 0) dst[i * nt] = T(0);
            return;
        }
        const size_t kp = (size_t)kk * P;
#pragma unroll
        for (int i = 0; i < kMaxWinSlots; ++i)
            if (wsrc[i] >= 0) stage(dst + i * nt, src[wsrc[i]] + kp + woff[i]);
    };
    // the column's RHS, bet and ud of plane kc
    auto stage_column = [&](int kc) {
        if (!active || kc >= nz) return;
        const size_t o = (size_t)kc * P + col;
        T* cv = sm.cv + (size_t)(kc % kColStages) * 3 * nt + tid;
        stage(cv, p.bq[TG] + o);
        stage(cv + nt, p.bet[TG] + o);
        if (kc < nz - 1) stage(cv + 2 * nt, p.ud[TG] + o);
    };
    // a tile's first planes: group g, window plane g + A + 1, band and
    // column plane g + A, for g = -A .. -1
    auto stage_first = [&]() {
        stage_window(-1);
        stage_window(0);
        for (int g = -A; g < 0; ++g) {
            stage_window(g + A + 1);
            stage_bands(g + A);
            stage_column(g + A);
            cp_commit();
        }
    };
    // a term's values sit at compile-time offsets from the thread's own
    // places in a band stage and in the window planes k - 1, k, k + 1
    const int bthread = jj * kBaseKeys * L::span + ii - 1;
    const int wthread = jj * 2 * kWW + ii;
    T* out = p.out[TG];
    int rt = first;
    if (rt >= count) return;
    set_tile(rt);
    stage_first();
    for (;;) {
        T x = T(0), udp = T(0);
        for (int k = 0; k < nz; ++k) {
            stage_window(k + A + 1);
            stage_bands(k + A);
            stage_column(k + A);
            cp_commit();
            cp_wait_ahead<A>();
            __syncthreads();
            if (!active) continue;
            const B* bst = sm.bs + (k % kBandStages) * bstage + bthread;
            const T* wk[3] = {wslot(k - 1) + wthread, wslot(k) + wthread,
                              wslot(k + 1) + wthread};
            auto value = [&](auto mi) -> T {
                constexpr Term tm = term_of(TG, decltype(mi)::value);
                constexpr int w = tm.src == wq0 ? 0 : 1;
                return up(bst[decltype(mi)::value * L::span + tm.bi])
                       * wk[tm.dk + 1][tm.oj * 2 * kWW + w * kWW + tm.oi];
            };
            T s = value(Int<0>{});
            s = s + value(Int<1>{});
            s = s + value(Int<2>{});
            s = s + value(Int<3>{});
            s = s + value(Int<4>{});
            s = s + value(Int<5>{});
            s = s + value(Int<6>{});
            s = s + value(Int<7>{});
            s = s + value(Int<8>{});
            s = s + value(Int<9>{});
            s = s + value(Int<10>{});
            s = s + value(Int<11>{});
            if (p.real && k == 0) {
                // the plane-0 'real' couplings, read in place (one plane)
                T x0 = T(0);
#pragma unroll
                for (int m = kBaseKeys; m < kTerms; ++m) {
                    const Term tm = term_of(TG, m);
                    int sa, r, sb, c;
                    halo_map(tm.src >> 1, J + tm.oj, H, sa, r);
                    halo_map(tm.src & 1, I + tm.oi, W, sb, c);
                    const T sv = (tm.dk < 0 || tm.dk >= nz)
                        ? T(0)
                        : src[2 * sa + sb][(size_t)tm.dk * P + r * W + c];
                    const uint32_t bo =
                        ((uint32_t)tm.band * (nz + 2) + tm.bk + 1) * PB
                        + (uint32_t)(J + tm.bj) * pitch + L::lpad + I
                        + tm.bi;
                    const T tv = up(p.band[bo]) * sv;
                    x0 = (m == kBaseKeys) ? tv : x0 + tv;
                }
                s = s + x0;
            }
            const T* cv = sm.cv + (size_t)(k % kColStages) * 3 * nt + tid;
            const T rhs = cv[0] - s;
            const T bet = cv[nt];
            x = (k == 0) ? rhs * bet : (rhs - udp * x) * bet;
            sm.xs[(size_t)k * nt + tid] = x;
            if (k < nz - 1) {
                udp = cv[2 * nt];
                sm.cs[(size_t)k * nt + tid] = udp * bet;
            }
        }
        // every thread's last reads of the tile's rings are done: the
        // next tile's first planes may take their slots
        __syncthreads();
        const bool solved = active;
        const uint32_t c = col;
        rt += (int)gridDim.x;
        const bool more = rt < count;
        if (more) {
            set_tile(rt);
            stage_first();
        }
        if (solved) {
            out[(size_t)(nz - 1) * P + c] = x;
            for (int k = nz - 2; k >= 0; --k) {
                x = sm.xs[(size_t)k * nt + tid]
                    - sm.cs[(size_t)k * nt + tid] * x;
                out[(size_t)k * P + c] = x;
            }
        }
        if (!more) break;
    }
    cp_wait_all();
}

// One whole RB sweep with the shallow ring, a tile at a time: a block
// takes every grid-th tile of a colour's two targets, from its index on.
template <typename T, typename B>
__device__ __forceinline__ void sweep_tiles(const Params<T, B>& p) {
    __shared__ Tables<T> tb;
    extern __shared__ __align__(16) unsigned char smem[];
    if (threadIdx.x == 0) {
        for (int i = 0; i < 4; ++i) tb.src[0][i] = p.q[i];
        // colour 1 reads colour 0's new quads and its own pre-sweep ones
        tb.src[1][0] = p.out[0];
        tb.src[1][1] = p.q[1];
        tb.src[1][2] = p.q[2];
        tb.src[1][3] = p.out[3];
    }
    __syncthreads();
    const Smem<T, B> sm(smem, p.nz, blockDim.x, kMinAhead);
    const int rows = blockDim.x / kCols;
    const int tiles_j = (p.H + rows - 1) / rows;
    const int tiles_i = (p.W + kCols - 1) / kCols;
    const int per_target = tiles_j * tiles_i;
    for (int colour = 0; colour < 2; ++colour) {
        // every colour-0 value is written and visible grid-wide after this
        if (colour) cg::this_grid().sync();
        for (int tile = blockIdx.x; tile < 2 * per_target;
             tile += gridDim.x) {
            const int second = tile >= per_target;
            const int rt = second ? tile - per_target : tile;
            const int J0 = (rt / tiles_i) * rows, I0 = (rt % tiles_i) * kCols;
            // the previous tile's last reads of every ring are done
            __syncthreads();
            // colour 0: (0,0) and (1,1); colour 1: (0,1) and (1,0)
            if (colour == 0 && !second)
                update_tile<T, B, 0>(p, tb, sm, colour, J0, I0);
            else if (colour == 0)
                update_tile<T, B, 3>(p, tb, sm, colour, J0, I0);
            else if (!second)
                update_tile<T, B, 1>(p, tb, sm, colour, J0, I0);
            else
                update_tile<T, B, 2>(p, tb, sm, colour, J0, I0);
        }
    }
}

// One whole RB sweep with a deep ring, A planes: a block walks its tiles of
// each target as one run.
template <typename T, typename B, int A>
__device__ __forceinline__ void sweep_runs(const Params<T, B>& p) {
    __shared__ Tables<T> tb;
    extern __shared__ __align__(16) unsigned char smem[];
    if (threadIdx.x == 0) {
        for (int i = 0; i < 4; ++i) tb.src[0][i] = p.q[i];
        // colour 1 reads colour 0's new quads and its own pre-sweep ones
        tb.src[1][0] = p.out[0];
        tb.src[1][1] = p.q[1];
        tb.src[1][2] = p.q[2];
        tb.src[1][3] = p.out[3];
    }
    __syncthreads();
    const Smem<T, B> sm(smem, p.nz, blockDim.x, A);
    const int rows = blockDim.x / kCols;
    const int tiles_j = (p.H + rows - 1) / rows;
    const int tiles_i = (p.W + kCols - 1) / kCols;
    const int per_target = tiles_j * tiles_i;
    // a colour's tiles are the first target's per_target, then the
    // second's; a block takes every grid-th, from its index on: in the
    // second target from `second`
    const int bx = blockIdx.x, grid = gridDim.x;
    const int second = bx >= per_target
        ? bx - per_target
        : bx + (per_target - bx + grid - 1) / grid * grid - per_target;
    for (int colour = 0; colour < 2; ++colour) {
        // every colour-0 value is written and visible grid-wide after this
        if (colour) cg::this_grid().sync();
        // colour 0: (0,0) and (1,1); colour 1: (0,1) and (1,0)
        if (colour == 0) {
            update_run<T, B, A, 0>(p, tb, sm, 0, bx, per_target, tiles_i);
            // the previous run's last reads of every ring are done
            __syncthreads();
            update_run<T, B, A, 3>(p, tb, sm, 0, second, per_target,
                                   tiles_i);
        } else {
            update_run<T, B, A, 1>(p, tb, sm, 1, bx, per_target, tiles_i);
            __syncthreads();
            update_run<T, B, A, 2>(p, tb, sm, 1, second, per_target,
                                   tiles_i);
        }
    }
}

// K4: one whole RB sweep, a kernel for each ring depth A, in namespace
// aheadA.  The shallow ring's kernel walks a tile at a time and is bounded
// by its threads alone (128 registers in float32: an 8-plane
// column's four blocks share an SM); the deep rings' kernels walk runs of
// tiles and are bounded for one block an SM, and take the registers that
// shorten a plane (168-206), which leaves them only where the shared
// memory holds at most two blocks or three (bfloat16 bands): plan_sweep
// never trades a block.
namespace ahead2 {
template <typename T, typename B>
__global__ void __launch_bounds__(kMaxThreads)
sweep_kernel(const Params<T, B> p) {
    sweep_tiles<T, B>(p);
}
}
#define K4_AT_DEPTH(A)                                                  \
    namespace ahead##A {                                                \
    template <typename T, typename B>                                   \
    __global__ void __launch_bounds__(kMaxThreads, 1)                   \
    sweep_kernel(const Params<T, B> p) {                                \
        sweep_runs<T, B, A>(p);                                         \
    }                                                                   \
    }
K4_AT_DEPTH(7)
K4_AT_DEPTH(13)
#undef K4_AT_DEPTH
static_assert(kMinAhead == 2 && kMaxAhead == 7 && kDeepAhead == 13,
              "K4 has a kernel for the depths 2, 7 and 13");

// K4's kernel of ring depth `ahead`; none where it has no such depth
template <typename T, typename B>
const void* sweep_kernel_at(int ahead) {
    void (*k)(const Params<T, B>) = nullptr;
    switch (ahead) {
        case kMinAhead: k = ahead2::sweep_kernel<T, B>; break;
        case kMaxAhead: k = ahead7::sweep_kernel<T, B>; break;
        case kDeepAhead:
            // a timing's depth: float32 state on float32 bands only
            if constexpr (sizeof(T) == 4 && sizeof(B) == 4)
                k = ahead13::sweep_kernel<T, B>;
            break;
    }
    return reinterpret_cast<const void*>(k);
}

// The launch plan of one sweep: threads per block (tile rows of kCols),
// the ring depth, dynamic shared memory, resident blocks per SM and the
// cooperative grid.
struct Plan {
    int nt, ahead, per_sm, grid;
    size_t smem;
};

// the blocks of nt threads and smem bytes an SM holds at once with the
// kernel of ring depth `ahead` (allowed that much dynamic shared memory
// first)
template <typename T, typename B>
cudaError_t resident(int ahead, int nt, size_t smem, int& per_sm) {
    const void* kern = sweep_kernel_at<T, B>(ahead);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            nt, smem);
    return err;
}

// ahead: the ring depth to take (a depth K4 has a kernel of), or 0 for the
// plan's own
template <typename T, typename B>
cudaError_t plan_sweep(int nz, int H, int W, int ahead, Plan& pl) {
    using S = Smem<T, B>;
    if (ahead != 0 && !sweep_kernel_at<T, B>(ahead))
        return cudaErrorInvalidValue;
    // the most threads (tile rows of kCols) whose columns fit a block with
    // the shallow ring, and the blocks an SM holds so
    int nt = kMaxThreads;
    while (nt > kCols && S::bytes(nz, nt, kMinAhead) > kMaxDynSmem) nt /= 2;
    if (S::bytes(nz, nt, kMinAhead) > kMaxDynSmem)
        return cudaErrorInvalidValue;
    int per_sm = 0;
    cudaError_t err =
        resident<T, B>(kMinAhead, nt, S::bytes(nz, nt, kMinAhead), per_sm);
    if (err != cudaSuccess) return err;
    if (ahead == 0) {
        // then the deep ring where it keeps them: never a block for depth
        ahead = kMinAhead;
        const size_t deep = S::bytes(nz, nt, kMaxAhead);
        if (deep <= kMaxDynSmem) {
            int held = 0;
            err = resident<T, B>(kMaxAhead, nt, deep, held);
            if (err != cudaSuccess) return err;
            if (held >= per_sm) ahead = kMaxAhead;
        }
    }
    const size_t smem = S::bytes(nz, nt, ahead);
    if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
    // a cooperative grid must be resident at once: at most the blocks the
    // card holds with this shared memory, each walking its share of tiles
    int dev = 0, sms = 0;
    err = resident<T, B>(ahead, nt, smem, per_sm);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int rows = nt / kCols;
    const long long tiles = 2LL * ((H + rows - 1) / rows)
                            * ((W + kCols - 1) / kCols);
    pl.nt = nt;
    pl.ahead = ahead;
    pl.smem = smem;
    pl.per_sm = per_sm;
    pl.grid = (int)(tiles < (long long)per_sm * sms
                        ? tiles : (long long)per_sm * sms);
    return cudaSuccess;
}

// The plan of each (device, quads, asked depth) a launch of this instance
// took, made once: a launch of a shape seen before asks no occupancy
template <typename T, typename B>
cudaError_t cached_plan(int nz, int H, int W, int ahead, Plan& pl) {
    struct Seen {
        int dev, nz, H, W, ahead;
        Plan pl;
    };
    static std::mutex mu;
    static std::vector<Seen> seen;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> hold(mu);
    for (const Seen& s : seen) {
        if (s.dev == dev && s.nz == nz && s.H == H && s.W == W
            && s.ahead == ahead) {
            pl = s.pl;
            return cudaSuccess;
        }
    }
    err = plan_sweep<T, B>(nz, H, W, ahead, pl);
    if (err == cudaSuccess) seen.push_back({dev, nz, H, W, ahead, pl});
    return err;
}

template <typename T, typename B>
int launch_sweep(const SweepArgs* a, int nz, int H, int W, int real,
                 int ahead, void* stream) {
    Params<T, B> p;
    for (int i = 0; i < 4; ++i) {
        p.q[i] = static_cast<const T*>(a->q[i]);
        p.bq[i] = static_cast<const T*>(a->bq[i]);
        p.ud[i] = static_cast<const T*>(a->ud[i]);
        p.bet[i] = static_cast<const T*>(a->bet[i]);
        p.out[i] = static_cast<T*>(a->out[i]);
    }
    p.band = static_cast<const B*>(a->band);
    p.nz = nz;
    p.H = H;
    p.W = W;
    p.real = real;
    Plan pl;
    cudaError_t err = cached_plan<T, B>(nz, H, W, ahead, pl);
    if (err != cudaSuccess) return (int)err;
    const void* kern = sweep_kernel_at<T, B>(pl.ahead);
    // another shape's plan may have allowed the kernel less since
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)pl.smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(kern, dim3(pl.grid), dim3(pl.nt), args,
                                      pl.smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ahead: the ring depth to take, 0 for the launch plan's own
int mg_sweep_fused_f32(const SweepArgs* a, int nz, int H, int W, int real,
                       int ahead, void* stream) {
    return launch_sweep<float, float>(a, nz, H, W, real, ahead, stream);
}

int mg_sweep_fused_f64(const SweepArgs* a, int nz, int H, int W, int real,
                       int ahead, void* stream) {
    return launch_sweep<double, double>(a, nz, H, W, real, ahead, stream);
}

int mg_sweep_fused_bf16(const SweepArgs* a, int nz, int H, int W, int real,
                        int ahead, void* stream) {
    return launch_sweep<float, __nv_bfloat16>(a, nz, H, W, real, ahead,
                                              stream);
}

int mg_sweep_fused_f64_bf16(const SweepArgs* a, int nz, int H, int W,
                            int real, int ahead, void* stream) {
    return launch_sweep<double, __nv_bfloat16>(a, nz, H, W, real, ahead,
                                               stream);
}

// The plan a launch of instance `inst` (0: f32, 1: f64, 2: bf16, 3:
// f64_bf16, the entries above in order) takes at quads (nz, H, W) with
// ring depth `ahead` (0: the plan's own): out = {threads, blocks per SM,
// grid, dynamic shared memory bytes, ring depth}.
int mg_sweep_fused_plan(int inst, int nz, int H, int W, int ahead,
                        int* out) {
    Plan pl;
    cudaError_t err;
    switch (inst) {
        case 0: err = plan_sweep<float, float>(nz, H, W, ahead, pl); break;
        case 1: err = plan_sweep<double, double>(nz, H, W, ahead, pl); break;
        case 2:
            err = plan_sweep<float, __nv_bfloat16>(nz, H, W, ahead, pl);
            break;
        case 3:
            err = plan_sweep<double, __nv_bfloat16>(nz, H, W, ahead, pl);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    out[0] = pl.nt;
    out[1] = pl.per_sm;
    out[2] = pl.grid;
    out[3] = (int)pl.smem;
    out[4] = pl.ahead;
    return 0;
}

// The compiled term recipe of target quad t (_TKEYS index): 16 rows of
// (band, bk, bj, bi, src, dk, oj, oi), sweep_fused.band_term_table's
// layout, for the tests to hold against it.
int mg_sweep_terms(int t, int* out) {
    if (t < 0 || t > 3) return (int)cudaErrorInvalidValue;
    for (int m = 0; m < kTerms; ++m) {
        const Term tm = term_of(t, m);
        const int row[8] = {tm.band, tm.bk, tm.bj, tm.bi,
                            tm.src, tm.dk, tm.oj, tm.oi};
        for (int f = 0; f < 8; ++f) out[8 * m + f] = row[f];
    }
    return 0;
}

}  // extern "C"
