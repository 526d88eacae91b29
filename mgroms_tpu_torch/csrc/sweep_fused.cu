// The colour-fused red-black sweep for Hopper (sm_90a): one launch per
// smoother sweep of a quad-parity level, colour 0 then colour 1.
//
// Replaces mgroms_tpu/ops/pallas/sweep_fused.py:_sweep_chunk (called by
// relax_fused_sweep) and computes, term for term and in the same operation
// order, what its plain version (ops/kernels/sweep_fused.
// relax_fused_sweep_plain, i.e. relax_compact_quads) computes: per colour,
// the 16-term gather through the quad halo extension of the state that
// colour reads (relax_compact.extend_quads), then the factored Thomas solve
// with gam = ud * bet recomputed.
//
// Design: a cooperative launch, one thread per (J, I) column of a target
// quad in grid-stride loops.  Phase 0 updates the colour-0 quads (0,0),
// (1,1) from the pre-sweep quads into their outputs; a grid barrier; phase 1
// updates (0,1), (1,0), reading the colour-0 quads' new values from those
// outputs and the colour-1 quads' pre-sweep values from the inputs.  The
// halo extension is done in the index arithmetic (halo_map, the rule of
// extend_quads), so no extended copy of the state is made: every halo read
// lands on the quad point whose value the plain sweep's extension copies,
// pre-sweep or post-colour-0 as the plain sweep has it.  Instances:
// (float, float), (double, double) and (float, bfloat16 blocks: the
// low-precision smoother operator, upcast at read).
//
// Bound: memory.  Per column and plane a sweep reads 12 operator blocks of
// its target, 12 state values, the RHS, ud and bet, and writes the solution
// (~2 flops per value read).  Against four K1 launches a sweep saves the
// extended state copies (2 glue passes and the 3-quad reads per target
// become the 4 raw quads, L1/L2 serving the neighbour reuse); it re-reads
// the colour-0 outputs in phase 1 (2 quads, ~3% of the bytes at the CUC
// level-0 shape).  The TPU kernel's tile overhang (colour 0 recomputed on a
// one-row/column ring so no barrier is needed) would add ~1/3 more colour-0
// work at a 32x8 tile and needs a private store for the ring's in-place
// Thomas; the barrier costs neither.  No shared-memory staging of blocks
// or state yet.
//
// Rounding: built with -fmad=false (0 ulp from the plain version).
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "quad_terms.cuh"

namespace cg = cooperative_groups;

// Pointers of one sweep, per quad in _TKEYS order (0,0), (0,1), (1,0),
// (1,1): the pre-sweep state, the RHS, the target's smoother blocks and
// 'real' pair (null unless real), ud, bet, and the output.
struct SweepArgs {
    const void* q[4];
    const void* bq[4];
    const void* blocks[4];
    const void* rb[4];
    const void* ud[4];
    const void* bet[4];
    void* out[4];
};

namespace {

constexpr int kThreads = 256;

template <typename T, typename B>
struct Params {
    const T* q[4];
    const T* bq[4];
    const B* blocks[4];
    const B* rb[4];
    const T* ud[4];
    const T* bet[4];
    T* out[4];
    int nz, H, W, real;
};

// The fields of one target quad.
template <typename T, typename B>
struct Target {
    const B* blocks;
    const B* rb;
    const T* bq;
    const T* ud;
    const T* bet;
    T* out;
};

template <int t, typename T, typename B>
__device__ __forceinline__ Target<T, B> target(const Params<T, B>& p) {
    return {p.blocks[t], p.rb[t], p.bq[t], p.ud[t], p.bet[t], p.out[t]};
}

// extend_quads along one axis: extended index X (0..n+1) of a quad of
// parity a with n interior points reads quad parity sa at index x.  Index 0
// is the -1 mirror (parity 0, index 0), n+1 the n mirror (parity 1, index
// n-1); the never-read junk ends follow the same rule.
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

template <typename T>
__device__ __forceinline__ const T* pick(int i, const T* s0, const T* s1,
                                         const T* s2, const T* s3) {
    return i == 0 ? s0 : i == 1 ? s1 : i == 2 ? s2 : s3;
}

// One RB colour update of column (J, I) of a target quad with term table
// tt: the gather reads the four quads s0..s3 (_TKEYS order) through the
// halo map, then the factored Thomas solve into tg.out (forward values in
// place, then the back substitution, as K1).
template <typename T, typename B>
__device__ __forceinline__ void update_column(
        const Params<T, B>& p, const Target<T, B>& tg, const Terms& tt,
        int J, int I, const T* s0, const T* s1, const T* s2, const T* s3) {
    const int nz = p.nz, H = p.H, W = p.W;
    const size_t P = (size_t)H * W;
    const T* sp[kTerms];
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
        int sa, r, sb, c;
        halo_map(tt.src[m] >> 1, J + tt.oj[m], H, sa, r);
        halo_map(tt.src[m] & 1, I + tt.oi[m], W, sb, c);
        sp[m] = pick(2 * sa + sb, s0, s1, s2, s3) + (size_t)r * W + c;
    }
    auto val = [&](int m, int k) -> T {
        const int kk = k + tt.dk[m];
        return (kk < 0 || kk >= nz) ? T(0) : sp[m][(size_t)kk * P];
    };
    const size_t wrow = (size_t)kBaseKeys * W;
    const size_t col = (size_t)J * W + I;
    T x = T(0);
    for (int k = 0; k < nz; ++k) {
        const B* brow = tg.blocks + ((size_t)k * H + J) * wrow + I;
        T s = up(brow[0]) * val(0, k);
#pragma unroll
        for (int m = 1; m < kBaseKeys; ++m) {
            s = s + up(brow[(size_t)m * W]) * val(m, k);
        }
        if (p.real && k == 0) {
            T x0 = T(0);
#pragma unroll
            for (int m = kBaseKeys; m < kTerms; ++m) {
                const int b = tt.blk[m];
                T bv = up(b < kBaseKeys
                              ? tg.blocks[(size_t)J * wrow + (size_t)b * W + I]
                              : tg.rb[(size_t)J * 2 * W
                                      + (size_t)(b - kBaseKeys) * W + I]);
                T t = bv * val(m, 0);
                x0 = (m == kBaseKeys) ? t : x0 + t;
            }
            s = s + x0;
        }
        const size_t o = (size_t)k * P + col;
        T rhs = tg.bq[o] - s;
        x = (k == 0) ? rhs * tg.bet[o] : (rhs - tg.ud[o - P] * x) * tg.bet[o];
        tg.out[o] = x;
    }
    for (int k = nz - 2; k >= 0; --k) {
        const size_t o = (size_t)k * P + col;
        x = tg.out[o] - (tg.ud[o] * tg.bet[o]) * x;
        tg.out[o] = x;
    }
}

// K4: one whole RB sweep.  `tt` holds the four targets' term tables
// (_TKEYS order) in device memory; they are copied to shared memory.
template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const Params<T, B> p, const Terms* __restrict__ tt) {
    __shared__ Terms s_tt[4];
    for (int i = threadIdx.x; i < (int)(4 * sizeof(Terms) / sizeof(int));
         i += blockDim.x) {
        reinterpret_cast<int*>(s_tt)[i] = reinterpret_cast<const int*>(tt)[i];
    }
    __syncthreads();
    const size_t HW = (size_t)p.H * p.W;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    // colour 0: (0,0) and (1,1), from the pre-sweep quads
    for (size_t i = first; i < 2 * HW; i += stride) {
        const bool lo = i < HW;
        const size_t c = lo ? i : i - HW;
        update_column(p, lo ? target<0>(p) : target<3>(p), s_tt[lo ? 0 : 3],
                      (int)(c / p.W), (int)(c % p.W), p.q[0], p.q[1], p.q[2],
                      p.q[3]);
    }
    // every colour-0 value is written and visible grid-wide after this
    cg::this_grid().sync();
    // colour 1: (0,1) and (1,0), reading the colour-0 quads' new values
    for (size_t i = first; i < 2 * HW; i += stride) {
        const bool lo = i < HW;
        const size_t c = lo ? i : i - HW;
        update_column(p, lo ? target<1>(p) : target<2>(p), s_tt[lo ? 1 : 2],
                      (int)(c / p.W), (int)(c % p.W), p.out[0], p.q[1],
                      p.q[2], p.out[3]);
    }
}

template <typename T, typename B>
int launch_sweep(const SweepArgs* a, int nz, int H, int W, int real,
                 const void* tt, void* stream) {
    Params<T, B> p;
    for (int i = 0; i < 4; ++i) {
        p.q[i] = static_cast<const T*>(a->q[i]);
        p.bq[i] = static_cast<const T*>(a->bq[i]);
        p.blocks[i] = static_cast<const B*>(a->blocks[i]);
        p.rb[i] = static_cast<const B*>(a->rb[i]);
        p.ud[i] = static_cast<const T*>(a->ud[i]);
        p.bet[i] = static_cast<const T*>(a->bet[i]);
        p.out[i] = static_cast<T*>(a->out[i]);
    }
    p.nz = nz;
    p.H = H;
    p.W = W;
    p.real = real;
    const void* kern = reinterpret_cast<const void*>(&sweep_kernel<T, B>);
    // a cooperative grid must be resident at once: at most the blocks the
    // card holds, each thread walking its share of the columns
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const long long want = (2LL * H * W + kThreads - 1) / kThreads;
    const int grid = (int)(want < (long long)per_sm * sms
                               ? want : (long long)per_sm * sms);
    const Terms* tp = static_cast<const Terms*>(tt);
    void* args[] = {&p, &tp};
    err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), args,
                                      0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_sweep_fused_f32(const SweepArgs* a, int nz, int H, int W, int real,
                       const void* tt, void* stream) {
    return launch_sweep<float, float>(a, nz, H, W, real, tt, stream);
}

int mg_sweep_fused_f64(const SweepArgs* a, int nz, int H, int W, int real,
                       const void* tt, void* stream) {
    return launch_sweep<double, double>(a, nz, H, W, real, tt, stream);
}

int mg_sweep_fused_bf16(const SweepArgs* a, int nz, int H, int W, int real,
                        const void* tt, void* stream) {
    return launch_sweep<float, __nv_bfloat16>(a, nz, H, W, real, tt, stream);
}

}  // extern "C"
