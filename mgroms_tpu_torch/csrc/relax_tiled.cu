// K1 and K2 for Hopper (sm_90a): one colour update of a quad-parity level,
// every target quad of the colour in one launch.
//
// Replaces mgroms_tpu/ops/pallas/relax_tiled.py:color_update_tiled (K1)
// and :color_update_tiled_emit (K2), which the JAX package launches once
// per target quad, and computes, term for term and in the same operation
// order, what their plain versions (ops/kernels/relax_tiled.
// color_update_plain, color_update_emit_plain) compute: per target quad,
// the 12-term gather g (14 with 'real': the four plane-0 terms summed into
// x0 and added last, relax_compact.gather_blocks), then the factored
// Thomas solve x_k = (bq_k - g_k - ud_{k-1} x_{k-1}) bet_k,
// x_k -= (ud_k bet_k) x_{k+1}; K2 also gives the raw residual
// r = bq - d x - lo x_- - hi x_+ - g of the updated target.
//
// What bounds it: memory.  Per column and plane a target reads 12 operator
// values, 12 state values, the RHS, ud and bet, and writes its solution
// (~2 flops per value read).  The design, per thing that held the first
// port back (one thread a column walking k with every load issued as the
// plane came, the Thomas forward values and the gather round-tripping
// through device memory, one launch per target):
//
// - One launch per colour.  A block owns a tile of rows x kCols quad
//   columns, one thread per (J, I), and the thread updates every target of
//   the colour at (J, I): both of an RB colour (relax_compact.
//   colour_targets), one of an FC colour.  The 12 base terms of each
//   target read only the target's row and column siblings, which are the
//   same two quads for both targets of an RB colour.
// - The operator in the layout the level holds it (compile-time BANDS):
//   the 24 halo-extended band quads (relax_compact.band_quads; an RB
//   colour reads each once), or the gather blocks.  Either is read in
//   place, coalesced along I (K3's finding: band values read in place beat
//   a staged band ring).  An FC colour loads a plane's operator values and
//   RHS, ud and bet a plane ahead into a second set of registers; an RB
//   colour loads them where it solves the plane.
// - The two sibling quads are staged once, over k (cp.async, LDGSTS): while
//   plane k is solved, plane k + 1 + kAhead is in flight into a ring of
//   kStages planes of (rows + 2) x (kCols + 2) values of each quad; each
//   staged value serves up to six terms of two targets at three planes.
//   One block barrier a plane.  The plane-0 'real' couplings (4 terms a
//   target, one plane) read their operator and the diagonal sibling's
//   state in place.
// - Resident warps over bytes moved.  What sets the time is the loads in
//   flight per SM: the registers are capped at two blocks of kMaxRows
//   tile rows an SM, and the forward values of the Thomas recurrence go
//   to `out`, re-read by the back substitution.  Its multipliers c_k =
//   ud_k bet_k are fixed by the target count: an FC colour (one target)
//   keeps them in shared memory, computed once in the forward pass, and
//   recomputes them from ud and bet re-read only where nz planes of them
//   do not fit; an RB colour (two targets) always recomputes them, since
//   shared memory of nz planes a column would halve its resident blocks,
//   which costs it more than the re-reads save (PERF.md).
// - K2's residual is written from the back substitution: r_{k+1} is final
//   once x_k is known (g_{k+1} read back from `res`, where the forward
//   pass left it, bq and ud re-read, d read there, a plane ahead).  No
//   third pass over k.
//
// Instances: (float, float), (double, double) and (float, bfloat16: the
// low-precision smoother operator, upcast at read, K1 only), in both
// layouts, for the two RB colours and the four FC targets (K2: the RB
// colours only).
//
// Rounding: built with -fmad=false (0 ulp from the plain versions).
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the launch's CUDA error code (cudaErrorInvalidValue
// for an instance that does not exist).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_terms.cuh"

// Pointers of one launch: the four extended state quads (nz, H+2, W+2) in
// _TKEYS order (0,0), (0,1), (1,0), (1,1); per target of the colour (slot
// 0: the first target, slot 1: its RB partner) the RHS, ud, bet, d, the
// solution and the raw residual (K2), the gather blocks and 'real' pair
// (gather-block layout); and the start of the band stack's storage (band
// layout: 24 band quads x (nz + 2) planes x (H + 2) rows of `pitch`
// values, extended column C at storage column C + 16 / sizeof(value) - 1,
// relax_compact.band_layout).
struct ColourArgs {
    const void* e[4];
    const void* bq[2];
    const void* ud[2];
    const void* bet[2];
    const void* d[2];
    void* out[2];
    void* res[2];
    const void* blocks[2];
    const void* rb[2];
    const void* band;
};

namespace {

constexpr int kCols = kBandTile;   // tile width: two warps a tile row
constexpr int kWW = kCols + 2;     // window row: the tile's columns + halo
constexpr int kMaxRows = 4;
constexpr int kAhead = 2;          // planes staged ahead of the last read
// ring planes live at once: k - 2 .. k + 1 + kAhead (a block barrier a
// plane, and a slot is refilled before the barrier that retires its last
// reader)
constexpr int kStages = kAhead + 4;
// window values a thread stages a plane, at most (one tile row)
constexpr int kMaxWinSlots = (3 * 2 * kWW + kCols - 1) / kCols;
constexpr size_t kMaxDynSmem = 227 * 1024;
// a block's shared memory that still lets several blocks share an SM: the
// most tile rows under it are taken
constexpr size_t kBlockSmem = 64 * 1024;

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

template <typename T, typename B>
struct Params {
    const T* e[4];
    const T* bq[2];
    const T* ud[2];
    const T* bet[2];
    const T* d[2];
    T* out[2];
    T* res[2];
    const B* blocks[2];
    const B* rb[2];
    const B* band;
    int nz, H, W, real;
    int keep_c;     // an FC colour's c in shared memory (plan())
};

// the 'real' pair's gather_keys(True) index per 'real' term (12..15)
__host__ __device__ constexpr int real_block(int m) {
    return m == 12 ? 4 : (m == 13 ? 12 : (m == 14 ? 10 : 13));
}

// The target of slot S of a launch whose first target is TG0: the colour
// partner of an RB target (a, b) is (1 - a, 1 - b).
template <int TG0, int S>
struct Target {
    static constexpr int tg = S == 0 ? TG0 : 3 - TG0;
    // the window quads: the row and column siblings of the first target
    // (for an RB partner the same two, swapped)
    static constexpr int w0 = 2 * (1 - (TG0 >> 1)) + (TG0 & 1);
    static constexpr int w1 = 2 * (TG0 >> 1) + (1 - (TG0 & 1));
};

// Shared memory of a block of nt = rows * kCols threads: the window ring
// (kStages planes of [rows + 2][2 quads][kWW]), then, where an FC colour
// keeps them, c_k at [k][nt].
template <typename T>
struct Smem {
    __host__ __device__ static int win_plane(int rows) {
        return (rows + 2) * 2 * kWW;
    }
    __host__ __device__ static size_t ring_bytes(int rows) {
        return ((size_t)kStages * win_plane(rows) * sizeof(T) + 15) / 16 * 16;
    }
    static size_t bytes(int nz, int rows, bool keep_c) {
        return ring_bytes(rows)
               + (keep_c ? (size_t)nz * rows * kCols * sizeof(T) : 0);
    }
};

// Two blocks of kMaxRows tile rows share an SM at least: the registers a
// thread takes are capped so (PERF.md: more resident warps, more loads in
// flight, beat every on-chip Thomas form at the CUC level-0 quads).
template <typename T, typename B, bool BANDS, bool EMIT, int TG0, int NT>
__global__ void __launch_bounds__(kCols * kMaxRows, 2)
colour_kernel(const Params<T, B> p) {
    using L = BandLayout<B>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int nz = p.nz, H = p.H, W = p.W;
    const int nt = blockDim.x, tid = threadIdx.x, rows = nt / kCols;
    const int jj = tid / kCols, ii = tid % kCols;
    const int tiles_i = (W + kCols - 1) / kCols;
    const int J0 = (blockIdx.x / tiles_i) * rows;
    const int I0 = (blockIdx.x % tiles_i) * kCols;
    const int J = J0 + jj, I = I0 + ii;
    const bool active = J < H && I < W;
    const uint32_t P = (uint32_t)H * W;
    const uint32_t EP = (uint32_t)(H + 2) * (W + 2);
    const uint32_t col = active ? (uint32_t)J * W + I : 0;
    const int pitch = L::pitch(W);
    const uint32_t PB = (uint32_t)(H + 2) * pitch;     // a band plane
    const uint32_t wrow = (uint32_t)kBaseKeys * W;       // a block row
    constexpr int W0 = Target<TG0, 0>::w0, W1 = Target<TG0, 0>::w1;
    const int wplane = Smem<T>::win_plane(rows);
    T* const ring = reinterpret_cast<T*>(smem);
    auto wslot = [&](int kk) -> T* {
        return ring + (size_t)((kk + kStages) % kStages) * wplane;
    };
    // c on chip: an FC colour's, where it fits (at [k][tid])
    const bool keep_c = NT == 1 && p.keep_c;
    T* const cs = reinterpret_cast<T*>(smem + Smem<T>::ring_bytes(rows))
                  + tid;

    // this thread's share of a window plane: quad (0: W0, 1: W1, -1:
    // outside the extended quad, never read) and offset in the plane
    int wq[kMaxWinSlots];
    uint32_t woff[kMaxWinSlots];
#pragma unroll
    for (int i = 0; i < kMaxWinSlots; ++i) {
        const int e = tid + i * nt;
        wq[i] = -1;
        woff[i] = 0;
        if (e < wplane) {
            const int wr = e / (2 * kWW), w = (e / kWW) % 2, wc = e % kWW;
            const int R = J0 + wr, C = I0 + wc;
            if (R <= H + 1 && C <= W + 1) {
                wq[i] = w;
                woff[i] = (uint32_t)R * (W + 2) + C;
            }
        }
    }
    // window plane kk (-1 and nz: zeros, as _kshift pads)
    auto stage = [&](int kk) {
        if (kk > nz) return;
        T* dst = wslot(kk) + tid;
        if (kk < 0 || kk == nz) {
#pragma unroll
            for (int i = 0; i < kMaxWinSlots; ++i)
                if (wq[i] >= 0) dst[i * nt] = T(0);
            return;
        }
        const uint32_t kp = (uint32_t)kk * EP;
#pragma unroll
        for (int i = 0; i < kMaxWinSlots; ++i)
            if (wq[i] >= 0)
                cp_async<sizeof(T)>(dst + i * nt,
                                    (wq[i] ? p.e[W1] : p.e[W0]) + kp
                                        + woff[i]);
    };

    // One plane's RHS, ud, bet and operator values of a target slot.  An
    // FC colour (one target) loads them a plane ahead into a second set of
    // registers, swapped each plane without moves; an RB colour (two
    // targets) loads them where it computes: the registers a second set
    // takes would halve the resident blocks, which the loads' latency needs
    // more (PERF.md).
    constexpr bool kAheadRegs = NT == 1;
    struct Plane {
        T bq, ud, bet;
        B bv[kBaseKeys];
    };
    Plane pa[NT], pb[NT];
    T udp[NT], xf[NT];      // ud of the plane before; the running solution
    auto load = [&](auto si, int kk, Plane* dst) {
        constexpr int S = decltype(si)::value;
        constexpr int TG = Target<TG0, S>::tg;
        Plane& c = dst[S];
        const uint32_t o = (uint32_t)kk * P + col;
        c.bq = p.bq[S][o];
        c.bet = p.bet[S][o];
        c.ud = kk < nz - 1 ? p.ud[S][o] : T(0);
        if (BANDS) {
            const uint32_t base = (uint32_t)kk * PB
                                  + (uint32_t)J * pitch + L::lpad + I;
#pragma unroll
            for (int m = 0; m < kBaseKeys; ++m) {
                const Term tm = term_of(TG, m);
                c.bv[m] = __ldg(p.band + base
                                + ((uint32_t)tm.band * (nz + 2) + tm.bk + 1)
                                      * PB
                                + (uint32_t)tm.bj * pitch + tm.bi);
            }
        } else {
            const B* brow = p.blocks[S] + ((size_t)kk * H + J) * wrow + I;
#pragma unroll
            for (int m = 0; m < kBaseKeys; ++m)
                c.bv[m] = __ldg(brow + (size_t)m * W);
        }
    };
    auto load_all = [&](int kk, Plane* dst) {
        load(Int<0>{}, kk, dst);
        if constexpr (NT == 2) load(Int<1>{}, kk, dst);
    };

    // the gather of target slot S at plane k; wk: the thread's place in
    // window planes k - 1, k, k + 1
    auto gather = [&](auto si, const T* const* wk, int k,
                      const Plane& c) -> T {
        constexpr int S = decltype(si)::value;
        constexpr int TG = Target<TG0, S>::tg;
        auto value = [&](auto mi) -> T {
            constexpr int m = decltype(mi)::value;
            constexpr Term tm = term_of(TG, m);
            static_assert(tm.src == W0 || tm.src == W1,
                          "a base term reads a sibling outside the window");
            constexpr int w = tm.src == W0 ? 0 : 1;
            return up(c.bv[m])
                   * wk[tm.dk + 1][tm.oj * 2 * kWW + w * kWW + tm.oi];
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
            // the plane-0 'real' couplings: the diagonal sibling, in place
            constexpr int DIAG = 3 - TG;
            const T* e = p.e[DIAG];
            T x0 = T(0);
#pragma unroll
            for (int m = kBaseKeys; m < kTerms; ++m) {
                const Term tm = term_of(TG, m);
                B bv;
                if (BANDS) {
                    bv = p.band[((uint32_t)tm.band * (nz + 2) + tm.bk + 1)
                                    * PB
                                + (uint32_t)(J + tm.bj) * pitch + L::lpad + I
                                + tm.bi];
                } else {
                    const int b = real_block(m);
                    bv = b < kBaseKeys
                        ? p.blocks[S][(size_t)J * wrow + (size_t)b * W + I]
                        : p.rb[S][(size_t)J * 2 * W
                                  + (size_t)(b - kBaseKeys) * W + I];
                }
                const T tv = up(bv)
                             * e[(uint32_t)(J + tm.oj) * (W + 2) + I + tm.oi];
                x0 = (m == kBaseKeys) ? tv : x0 + tv;
            }
            g = g + x0;
        }
        return g;
    };

    // the forward substitution of slot S at plane k: the forward value to
    // `out`, K2's gather to `res`, c to shared memory where it is kept
    auto forward = [&](auto si, const T* const* wk, int k, const Plane& c) {
        constexpr int S = decltype(si)::value;
        const T g = gather(si, wk, k, c);
        const T rhs = c.bq - g;
        xf[S] = (k == 0) ? rhs * c.bet : (rhs - udp[S] * xf[S]) * c.bet;
        const size_t o = (size_t)k * P + col;
        p.out[S][o] = xf[S];
        if (EMIT) p.res[S][o] = g;
        if (keep_c && k < nz - 1) cs[(size_t)k * nt] = c.ud * c.bet;
        udp[S] = c.ud;
    };

    // plane k: stage the window plane k + 1 + kAhead, meet the barrier that
    // publishes plane k + 1, solve plane k from `cur` (an FC colour: loaded
    // a plane before; its plane k + 1 goes into `nxt` first)
    const int wthread = jj * 2 * kWW + ii;
    auto step = [&](int k, Plane* cur, Plane* nxt) {
        stage(k + kAhead + 1);
        cp_commit();
        if (kAheadRegs && active && k + 1 < nz) load_all(k + 1, nxt);
        cp_wait_ahead();
        __syncthreads();
        if (!active) return;
        if (!kAheadRegs) load_all(k, cur);
        const T* wk[3] = {wslot(k - 1) + wthread, wslot(k) + wthread,
                          wslot(k + 1) + wthread};
        forward(Int<0>{}, wk, k, cur[0]);
        if constexpr (NT == 2) forward(Int<1>{}, wk, k, cur[1]);
    };

    for (int kk = -1; kk <= kAhead; ++kk) {
        stage(kk);
        cp_commit();
    }
#pragma unroll
    for (int s = 0; s < NT; ++s) {
        udp[s] = T(0);      // plane 0 has no lower coupling
        xf[s] = T(0);
    }
    if (kAheadRegs && active) load_all(0, pa);
    for (int k = 0; k < nz; k += 2) {
        step(k, pa, pb);
        if (k + 1 < nz) step(k + 1, pb, pa);
    }
    cp_wait_all();
    if (!active) return;

    // The back substitution, every slot in one loop: x_k = xs_k - c_k
    // x_{k+1}, xs_k the forward value in `out`; K2 emits r_{k+1} once x_k
    // is known (lo = ud_k, hi = ud_{k+1}, 0 at the top plane), then r_0.
    // Each plane's loads are issued a plane ahead.
    struct Back {
        T x1, x2;               // x_{k+1}, x_{k+2}
        T xs, c, ud, bet;       // plane k's: forward value, c (or ud, bet)
        T bq, d, g, hi;         // K2, plane k + 1's: bq, d, g; ud_{k+1}
    };
    Back bk[NT], nx[NT];
    auto bload = [&](int s, int k, Back& b) {
        const uint32_t o = (uint32_t)k * P + col;
        b.xs = p.out[s][o];
        if (keep_c) {
            b.c = cs[(size_t)k * nt];
            if (EMIT) b.ud = p.ud[s][o];
        } else {
            b.ud = p.ud[s][o];
            b.bet = p.bet[s][o];
        }
        if (EMIT) {
            const uint32_t o1 = o + P;
            b.bq = p.bq[s][o1];
            b.d = p.d[s][o1];
            b.g = p.res[s][o1];
        }
    };
#pragma unroll
    for (int s = 0; s < NT; ++s) {
        bk[s].x1 = xf[s];
        bk[s].x2 = T(0);
        bk[s].hi = T(0);
        bload(s, nz - 2, nx[s]);
    }
    for (int k = nz - 2; k >= 0; --k) {
#pragma unroll
        for (int s = 0; s < NT; ++s) {
            const Back b = nx[s];
            if (k > 0) bload(s, k - 1, nx[s]);
            const T c = keep_c ? b.c : b.ud * b.bet;
            const T x0 = b.xs - c * bk[s].x1;
            const uint32_t o = (uint32_t)k * P + col;
            p.out[s][o] = x0;
            if (EMIT) {
                // r_{k+1}: xm = x_k, x = x_{k+1}, xp = x_{k+2}
                p.res[s][o + P] = b.bq - b.d * bk[s].x1 - b.ud * x0
                                  - bk[s].hi * bk[s].x2 - b.g;
                bk[s].hi = b.ud;
            }
            bk[s].x2 = bk[s].x1;
            bk[s].x1 = x0;
        }
    }
    if (EMIT) {
#pragma unroll
        for (int s = 0; s < NT; ++s) {
            const T lo = T(0), xm = T(0);
            p.res[s][col] = p.bq[s][col] - p.d[s][col] * bk[s].x1 - lo * xm
                            - bk[s].hi * bk[s].x2 - p.res[s][col];
        }
    }
}

template <typename T, typename B, bool BANDS, bool EMIT, int TG0, int NT>
int launch(const Params<T, B>& p, int rows, cudaStream_t s) {
    const void* kern = reinterpret_cast<const void*>(
        &colour_kernel<T, B, BANDS, EMIT, TG0, NT>);
    const size_t smem = Smem<T>::bytes(p.nz, rows, p.keep_c);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (long long)((p.H + rows - 1) / rows)
                            * ((p.W + kCols - 1) / kCols);
    colour_kernel<T, B, BANDS, EMIT, TG0, NT>
        <<<(unsigned)tiles, rows * kCols, smem, s>>>(p);
    return (int)cudaGetLastError();
}

// the instance for the colour's first target tg0 and its target count
template <typename T, typename B, bool BANDS, bool EMIT>
int dispatch(const Params<T, B>& p, int tg0, int ntargets, int rows,
             cudaStream_t s) {
    if (ntargets == 2) {
        if (tg0 == 0) return launch<T, B, BANDS, EMIT, 0, 2>(p, rows, s);
        if (tg0 == 1) return launch<T, B, BANDS, EMIT, 1, 2>(p, rows, s);
        return (int)cudaErrorInvalidValue;
    }
    if constexpr (EMIT) {
        return (int)cudaErrorInvalidValue;     // K2: the RB colours only
    } else {
        switch (tg0) {
            case 0: return launch<T, B, BANDS, false, 0, 1>(p, rows, s);
            case 1: return launch<T, B, BANDS, false, 1, 1>(p, rows, s);
            case 2: return launch<T, B, BANDS, false, 2, 1>(p, rows, s);
            case 3: return launch<T, B, BANDS, false, 3, 1>(p, rows, s);
        }
        return (int)cudaErrorInvalidValue;
    }
}

// Whether a launch keeps c on chip (an FC colour, where nz planes of c fit
// a block of one tile row), and its tile rows: the most under kBlockSmem
// (one row if none is).
template <typename T>
void plan(int nz, int ntargets, int& keep_c, int& rows_out) {
    keep_c = ntargets == 1 && Smem<T>::bytes(nz, 1, true) <= kMaxDynSmem;
    int rows = 1;
    for (int r = kMaxRows; r > 1; r /= 2) {
        if (Smem<T>::bytes(nz, r, keep_c) <= kBlockSmem) {
            rows = r;
            break;
        }
    }
    rows_out = rows;
}

template <typename T, typename B>
int launch_colour(const ColourArgs* a, int nz, int H, int W, int real,
                  int tg0, int ntargets, int emit, int bands, void* stream) {
    if (nz < 2 || tg0 < 0 || tg0 > 3 || ntargets < 1 || ntargets > 2)
        return (int)cudaErrorInvalidValue;
    Params<T, B> p;
    for (int i = 0; i < 4; ++i) p.e[i] = static_cast<const T*>(a->e[i]);
    for (int i = 0; i < 2; ++i) {
        p.bq[i] = static_cast<const T*>(a->bq[i]);
        p.ud[i] = static_cast<const T*>(a->ud[i]);
        p.bet[i] = static_cast<const T*>(a->bet[i]);
        p.d[i] = static_cast<const T*>(a->d[i]);
        p.out[i] = static_cast<T*>(a->out[i]);
        p.res[i] = static_cast<T*>(a->res[i]);
        p.blocks[i] = static_cast<const B*>(a->blocks[i]);
        p.rb[i] = static_cast<const B*>(a->rb[i]);
    }
    p.band = static_cast<const B*>(a->band);
    p.nz = nz;
    p.H = H;
    p.W = W;
    p.real = real;
    int rows = 1;
    plan<T>(nz, ntargets, p.keep_c, rows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bands)
        return emit ? dispatch<T, B, true, true>(p, tg0, ntargets, rows, s)
                    : dispatch<T, B, true, false>(p, tg0, ntargets, rows, s);
    return emit ? dispatch<T, B, false, true>(p, tg0, ntargets, rows, s)
                : dispatch<T, B, false, false>(p, tg0, ntargets, rows, s);
}

}  // namespace

extern "C" {

// One colour update: targets tg0 (and, with ntargets 2, its RB partner
// 3 - tg0); emit: K2; bands: the band-stack layout.
int mg_colour_update_f32(const ColourArgs* a, int nz, int H, int W, int real,
                         int tg0, int ntargets, int emit, int bands,
                         void* stream) {
    return launch_colour<float, float>(a, nz, H, W, real, tg0, ntargets,
                                       emit, bands, stream);
}

int mg_colour_update_f64(const ColourArgs* a, int nz, int H, int W, int real,
                         int tg0, int ntargets, int emit, int bands,
                         void* stream) {
    return launch_colour<double, double>(a, nz, H, W, real, tg0, ntargets,
                                         emit, bands, stream);
}

// K1 on the low-precision smoother operator: float32 state, bfloat16
// operator (no emit form: the emitted residual needs the true operator).
int mg_colour_update_bf16(const ColourArgs* a, int nz, int H, int W,
                          int real, int tg0, int ntargets, int emit,
                          int bands, void* stream) {
    if (emit) return (int)cudaErrorInvalidValue;
    return launch_colour<float, __nv_bfloat16>(a, nz, H, W, real, tg0,
                                               ntargets, 0, bands, stream);
}

}  // extern "C"
