// Roofline probes of the level-0 smoother for Hopper (sm_90a): how long K1's
// loads alone take, and the card's float32 FMA rate.
//
//   dma_only        <- scripts/micro_roofline.py:dma_only (copy_kernel)
//   dma_only_bands     the same, on the band stack (no JAX counterpart:
//                      the JAX K1 reads gather blocks)
//   fma_run         <- scripts/micro_roofline.py:fma_run (fma_kernel)
//
// dma_only takes K1's operands at K1's shapes (ops/kernels/relax_tiled.py
// _shapes), K1's grid (32 x 8 threads per block, one thread per (J, I)
// column) and K1's per-plane loads (relax_tiled.cu gather and
// color_update_kernel): the 12 state values of the term table (and the 4
// 'real' ones on plane 0), the 12 operator blocks (and the 'real' pair on
// plane 0; float32, or bfloat16 as K1 reads them in perf mode), ud at k-1,
// bet, and the RHS.  `which` selects all of them, only
// the state windows (with the RHS) or only the blocks (with the RHS), as the
// TPU probe's three variants.  Its body is trivial: every loaded value is
// added, in a fixed order, into the output, so no load can be dropped and
// the plain version (roofline.dma_only_plain) computes the same sums bit
// for bit.  K1's time against this one's says whether K1 is bound by its
// bytes.  Bound: memory.  The JAX probe DMAs each window into VMEM once a
// plane, and K1 stages its sibling quads through a cp.async ring: so the
// forms with windows (dma_only_ring_kernel) stage the three extended quads'
// (8 + 2) x (32 + 2) windows of a plane and the block's RHS in shared
// memory, a ring of kWSlots planes (k-1 .. k+1 read, five in flight), and
// read the 12 (16) terms from there.  A thread per column loading each
// term from device memory (the first port) fetched every window value up
// to four times through L1 and ran at ~0.8 TB/s; an RHS loaded into a
// register a plane ahead left each plane waiting on its latency.  The
// blocks form (dma_only_kernel) is the coalesced walk it always was.
//
// dma_only_bands: the same probe for K1 as the card's solver launches it
// on an RB colour (relax_tiled.cu colour_kernel<float, B, true, false,
// TG0, 2>): the band stack read in place, K1's block of kMaxRows x 64
// threads, a thread per (J, I) updating both targets.  Per plane, target
// TG0 then its partner 3 - TG0: the RHS, the 12 band values of the
// target's base terms (term_of; float32 or bfloat16, upcast at load),
// for the first target the two sibling quads' own value at (J, I) (the
// bytes K1 stages once), ud (below the top plane) and bet, added in that
// order into the target's output.  The 'real' terms (plane 0 only) are
// left out.  K1's time against this one's says how much of K1 its loads
// alone take, and the float32 stack against the bfloat16 one how the
// time follows the bytes.
//
// step_floor: the floor of K6's one-launch forms (relax_fused.cu
// relax_resident), whose time is their serial colour steps.  nsteps steps
// in one launch on a (nz, ny, nx) state in shared memory, a thread per
// column of the step's parity colour ((j + i + step) even), as K6's RB
// step: the column reads its (j - 1, i) neighbour's plane 0 (the other
// colour; the edge clamped to itself) and runs an nz-deep dependent chain
// of one shared-memory load and one multiply and add a plane, acc = acc *
// h + x[k], then writes plane 0; a barrier ends the step.  One block, or
// a cluster of up to 16 blocks (8 where 16 cannot be resident), a band of
// rows each, the first row reading its neighbour from the block above
// through distributed shared memory, a cluster barrier a step.  Bound:
// neither bytes nor operations but the chain and the barrier; K6's time
// over this one's says how far a one-launch form is from its floor.
//
// fma_run: 8 independent chains x 64 chained fused multiply-adds per
// element of a (8, 8, 512) block, over 256 tiles (every tile recomputes the
// block and writes the same values), then the 8 chains summed.  The build
// has -fmad=false, so the FMAs are written as __fmaf_rn.  Bound:
// operations; its time gives the measured float32 FMA rate.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"
#include "quad_terms.cuh"

namespace {

constexpr int kFmaChains = 8;
constexpr int kFmaReps = 64;

// K1's grid block: 32 x 8 threads, a thread per (J, I) column
constexpr int kWI = 32, kWJ = 8;
constexpr int kWT = kWI * kWJ;
// the windows' ring: planes k-1, k, k+1 (the term table's reach) and
// kWSlots - 3 in flight ahead of them, each plane the three quads'
// (kWJ+2) x (kWI+2) windows and the RHS
constexpr int kWSlots = 8;
constexpr int kWP = kWI + 2;
constexpr int kWin = (kWJ + 2) * kWP;
constexpr int kWQ = 3 * kWin;               // the windows, then the RHS
constexpr int kWSlot = kWQ + kWT;
constexpr int kWIters = (kWQ + kWT - 1) / kWT;
constexpr size_t kWBytes = (size_t)kWSlots * kWSlot * sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 4-byte copy to shared address dst
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(src), "n"(4) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the newest N groups landed
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The first port's kernel, kept as it was for the blocks form (which 2):
// a thread walks its column with coalesced loads.  Its windows and all
// paths (which 0, 1) no longer launch (dma_only_ring_kernel runs those
// forms); they stay so that the blocks form compiles to the code it
// always ran (a copy without them measured slower on bfloat16 blocks:
// scripts/micro_overlap.py, variant blocks_only).  B: the block type, float or bfloat16 (K1 on the low-precision
// smoother operator), upcast at load as K1 does.
template <typename B>
__global__ void dma_only_kernel(const float* __restrict__ e0,
                                const float* __restrict__ e1,
                                const float* __restrict__ e2,
                                const B* __restrict__ blocks,
                                const B* __restrict__ rb,
                                const float* __restrict__ ud,
                                const float* __restrict__ bet,
                                const float* __restrict__ gam,
                                const float* __restrict__ bq,
                                float* __restrict__ out, int nz, int H, int W,
                                int which, Terms tt) {
    const int I = blockIdx.x * blockDim.x + threadIdx.x;
    const int J = blockIdx.y * blockDim.y + threadIdx.y;
    if (I >= W || J >= H) return;
    const float* eq[3] = {e0, e1, e2};
    const size_t P = (size_t)H * W;
    const size_t EP = (size_t)(H + 2) * (W + 2);
    const size_t c = (size_t)J * W + I;
    const size_t wrow = (size_t)kBaseKeys * W;
    const bool windows = which != 2, blks = which != 1, all = which == 0;
    for (int k = 0; k < nz; ++k) {
        const size_t o = (size_t)k * P + c;
        float acc = bq[o];
        if (windows) {
            const int nt = (rb != nullptr && k == 0) ? kTerms : kBaseKeys;
            for (int m = 0; m < nt; ++m) {
                const int kk = k + tt.dk[m];
                const float v = (kk < 0 || kk >= nz)
                    ? 0.0f
                    : eq[tt.src[m]][(size_t)kk * EP
                                    + (size_t)(J + tt.oj[m]) * (W + 2)
                                    + (I + tt.oi[m])];
                acc = acc + v;
            }
        }
        if (blks) {
            const B* brow = blocks + ((size_t)k * H + J) * wrow + I;
#pragma unroll
            for (int m = 0; m < kBaseKeys; ++m) acc = acc + up(brow[m * W]);
            if (rb != nullptr && k == 0) {
                acc = acc + up(rb[(size_t)J * 2 * W + I]);
                acc = acc + up(rb[(size_t)J * 2 * W + W + I]);
            }
        }
        if (all) {
            if (k > 0) acc = acc + ud[o - P];
            acc = acc + bet[o];
            if (gam != nullptr && k < nz - 1) acc = acc + gam[o];
        }
        out[o] = acc;
    }
}

// which 0 (ALL) and 1 (the state windows, with the RHS): the windows are
// staged plane by plane in shared memory through a cp.async ring (the
// extended quads' rows, of W + 2 values, in 4-byte copies), as K1 stages
// its sibling quads, and the terms read from there; the RHS rides in the
// same ring (a thread's own value).  With ALL, the blocks, rb, ud, bet and
// gam are single coalesced loads into registers, issued at the top of
// their plane, before its barrier.
template <typename B, bool ALL>
__global__ void __launch_bounds__(kWT)
dma_only_ring_kernel(const float* __restrict__ e0,
                     const float* __restrict__ e1,
                     const float* __restrict__ e2,
                     const B* __restrict__ blocks,
                     const B* __restrict__ rb, const float* __restrict__ ud,
                     const float* __restrict__ bet,
                     const float* __restrict__ gam,
                     const float* __restrict__ bq, float* __restrict__ out,
                     int nz, int H, int W, Terms tt) {
    const int I = blockIdx.x * kWI + threadIdx.x;
    const int J = blockIdx.y * kWJ + threadIdx.y;
    const bool act = I < W && J < H;
    const size_t P = (size_t)H * W;
    const size_t c = (size_t)J * W + I;
    const size_t wrow = (size_t)kBaseKeys * W;
    const size_t EP = (size_t)(H + 2) * (W + 2);
    extern __shared__ __align__(16) float ring[];
    const int tid = threadIdx.y * kWI + threadIdx.x;
    // this thread's window copies, the same every plane: the source at
    // plane 0 (nullptr: none)
    const float* wsrc[kWIters];
    {
        const int I0 = blockIdx.x * kWI, J0 = blockIdx.y * kWJ;
        const int rows = min(kWJ, H - J0), cols = min(kWI, W - I0);
#pragma unroll
        for (int m = 0; m < kWIters; ++m) {
            const int e = tid + m * kWT;
            const int q = e / kWin, w = (e % kWin) / kWP, cc = e % kWP;
            wsrc[m] = (q < 3 && w < rows + 2 && cc < cols + 2)
                          ? (q == 0 ? e0 : q == 1 ? e1 : e2)
                                + (size_t)(J0 + w) * (W + 2) + I0 + cc
                          : nullptr;
        }
    }
    const uint32_t sbase = smem_addr(ring) + (uint32_t)tid * 4;
    const auto stage = [&](int k) {
        const uint32_t s = sbase + ((unsigned)k % kWSlots) * (kWSlot * 4);
#pragma unroll
        for (int m = 0; m < kWIters; ++m)
            if (wsrc[m] != nullptr)
                cp_async4(s + m * kWT * 4, wsrc[m] + (size_t)k * EP);
        if (act) cp_async4(s + kWQ * 4, bq + (size_t)k * P + c);
    };
    constexpr int ahead = kWSlots - 3;        // planes in flight past k+1
#pragma unroll
    for (int q = 0; q <= ahead; ++q) {
        if (q < nz) stage(q);
        cp_commit();
    }
    // a base term's offset in a plane's windows, worked out once
    int toff[kBaseKeys];
#pragma unroll
    for (int m = 0; m < kBaseKeys; ++m)
        toff[m] = tt.src[m] * kWin + (threadIdx.y + tt.oj[m]) * kWP
                  + threadIdx.x + tt.oi[m];
    for (int k = 0; k < nz; ++k) {
        const size_t o = (size_t)k * P + c;
        const bool rk = rb != nullptr && k == 0;
        // the plane's coalesced loads, issued before its barrier
        float vb[kBaseKeys], vr[2] = {0.0f, 0.0f};
        float vu = 0.0f, vt = 0.0f, vg = 0.0f;
        if (ALL && act) {
            const B* brow = blocks + ((size_t)k * H + J) * wrow + I;
#pragma unroll
            for (int m = 0; m < kBaseKeys; ++m) vb[m] = up(brow[m * W]);
            if (rk) {
                vr[0] = up(rb[(size_t)J * 2 * W + I]);
                vr[1] = up(rb[(size_t)J * 2 * W + W + I]);
            }
            if (k > 0) vu = ud[o - P];
            vt = bet[o];
            if (gam != nullptr && k < nz - 1) vg = gam[o];
        }
        cp_wait<ahead - 1>();                  // planes <= k+1 landed
        // ... for every thread, and every thread is past plane k-1, so
        // plane k-2's slot takes plane k+1+ahead
        __syncthreads();
        if (k + 1 + ahead < nz) stage(k + 1 + ahead);
        cp_commit();
        if (!act) continue;
        // planes k-1, k, k+1: their slots, and whether they exist
        const int s0 = ((unsigned)(k + kWSlots - 1) % kWSlots) * kWSlot;
        const int s1 = ((unsigned)k % kWSlots) * kWSlot;
        const int s2 = ((unsigned)(k + 1) % kWSlots) * kWSlot;
        const bool lo = k > 0, hi = k + 1 < nz;
        const auto term = [&](int dk, int off) {
            if ((dk < 0 && !lo) || (dk > 0 && !hi)) return 0.0f;
            return ring[(dk < 0 ? s0 : dk > 0 ? s2 : s1) + off];
        };
        float acc = ring[s1 + kWQ + tid];
#pragma unroll
        for (int m = 0; m < kBaseKeys; ++m)
            acc = acc + term(tt.dk[m], toff[m]);
        if (rk) {
#pragma unroll
            for (int m = kBaseKeys; m < kTerms; ++m)
                acc = acc + term(tt.dk[m],
                                 tt.src[m] * kWin
                                     + (threadIdx.y + tt.oj[m]) * kWP
                                     + threadIdx.x + tt.oi[m]);
        }
        if (ALL) {
#pragma unroll
            for (int m = 0; m < kBaseKeys; ++m) acc = acc + vb[m];
            if (rk) {
                acc = acc + vr[0];
                acc = acc + vr[1];
            }
            if (k > 0) acc = acc + vu;
            acc = acc + vt;
            if (gam != nullptr && k < nz - 1) acc = acc + vg;
        }
        out[o] = acc;
    }
}

constexpr int kProbeRows = 4;      // relax_tiled.cu kMaxRows

template <typename B, int TG0>
__global__ void __launch_bounds__(kBandTile * kProbeRows)
dma_only_bands_kernel(const float* __restrict__ s0,
                      const float* __restrict__ s1,
                      const float* __restrict__ bq0,
                      const float* __restrict__ bq1,
                      const float* __restrict__ ud0,
                      const float* __restrict__ ud1,
                      const float* __restrict__ bet0,
                      const float* __restrict__ bet1,
                      const B* __restrict__ band, float* __restrict__ out0,
                      float* __restrict__ out1, int nz, int H, int W) {
    using L = BandLayout<B>;
    constexpr int TG1 = 3 - TG0;
    const int tiles_i = (W + kBandTile - 1) / kBandTile;
    const int J = (blockIdx.x / tiles_i) * kProbeRows
                  + threadIdx.x / kBandTile;
    const int I = (blockIdx.x % tiles_i) * kBandTile
                  + threadIdx.x % kBandTile;
    if (J >= H || I >= W) return;
    const uint32_t P = (uint32_t)H * W;
    const uint32_t EP = (uint32_t)(H + 2) * (W + 2);
    const uint32_t col = (uint32_t)J * W + I;
    const uint32_t ecol = (uint32_t)(J + 1) * (W + 2) + I + 1;
    const int pitch = L::pitch(W);
    const uint32_t PB = (uint32_t)(H + 2) * pitch;
    const uint32_t bcol = (uint32_t)J * pitch + L::lpad + I;
    auto bands = [&](auto tg, uint32_t kb, float acc) {
        constexpr int TG = decltype(tg)::value;
#pragma unroll
        for (int m = 0; m < kBaseKeys; ++m) {
            const Term tm = term_of(TG, m);
            acc = acc + up(__ldg(band + kb
                                 + ((uint32_t)tm.band * (nz + 2) + tm.bk + 1)
                                       * PB
                                 + (uint32_t)tm.bj * pitch + tm.bi));
        }
        return acc;
    };
    for (int k = 0; k < nz; ++k) {
        const uint32_t o = (uint32_t)k * P + col;
        const uint32_t kb = (uint32_t)k * PB + bcol;
        float a0 = bands(Int<TG0>{}, kb, bq0[o]);
        a0 = a0 + s0[(uint32_t)k * EP + ecol];
        a0 = a0 + s1[(uint32_t)k * EP + ecol];
        if (k < nz - 1) a0 = a0 + ud0[o];
        out0[o] = a0 + bet0[o];
        float a1 = bands(Int<TG1>{}, kb, bq1[o]);
        if (k < nz - 1) a1 = a1 + ud1[o];
        out1[o] = a1 + bet1[o];
    }
}

__global__ void fma_kernel(const float* __restrict__ x, float* __restrict__ out,
                           int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float v = x[i];
    float acc[kFmaChains];
#pragma unroll
    for (int c = 0; c < kFmaChains; ++c) acc[c] = v * (float)(1.0 + 0.001 * c);
#pragma unroll 8
    for (int r = 0; r < kFmaReps; ++r) {
#pragma unroll
        for (int c = 0; c < kFmaChains; ++c)
            acc[c] = __fmaf_rn(acc[c], 1.000001f, v);
    }
    float s = acc[0];
#pragma unroll
    for (int c = 1; c < kFmaChains; ++c) s = s + acc[c];
    out[i] = s;
}

constexpr float kFloorH = 0.5f;

template <bool CLUSTER>
__global__ void __launch_bounds__(1024)
step_floor_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int nz, int ny, int nx, int nb, int nsteps) {
    extern __shared__ __align__(16) float sx[];
    int r = 0;
    if constexpr (CLUSTER) r = (int)cooperative_groups::this_cluster()
                                   .block_rank();
    const int j0 = (int)((long long)r * ny / nb);
    const int j1 = (int)((long long)(r + 1) * ny / nb);
    const int j0u = (int)((long long)(r - 1) * ny / nb);
    const size_t PS = (size_t)((ny + nb - 1) / nb) * nx;
    const size_t P = (size_t)ny * nx;
    const int hx = (nx + 1) / 2, t = threadIdx.x;
    const int lr = t / hx, m = t % hx;
    const int rows = j1 - j0;
    for (size_t o = t; o < (size_t)nz * rows * nx; o += blockDim.x) {
        const size_t band = (size_t)rows * nx;
        const size_t k = o / band, rest = o % band;
        sx[k * PS + rest] = x[k * P + (size_t)j0 * nx + rest];
    }
    const float* up = sx;
    if constexpr (CLUSTER) {
        if (r > 0)
            up = cooperative_groups::this_cluster().map_shared_rank(sx,
                                                                    r - 1);
        cooperative_groups::this_cluster().sync();
    } else {
        __syncthreads();
    }
    for (int step = 0; step < nsteps; ++step) {
        const int j = j0 + lr, i = 2 * m + ((j + step) & 1);
        if (j < j1 && i < nx) {
            const int jn = j > 0 ? j - 1 : 0;
            const float nv = (CLUSTER && jn < j0)
                                 ? up[(size_t)(jn - j0u) * nx + i]
                                 : sx[(size_t)(jn - j0) * nx + i];
            const size_t own = (size_t)(j - j0) * nx + i;
            float acc = nv * kFloorH;
            for (int k = 0; k < nz; ++k)
                acc = acc * kFloorH + sx[k * PS + own];
            sx[own] = acc;
        }
        if constexpr (CLUSTER) {
            cooperative_groups::this_cluster().sync();
        } else {
            __syncthreads();
        }
    }
    for (size_t o = t; o < (size_t)nz * rows * nx; o += blockDim.x) {
        const size_t band = (size_t)rows * nx;
        const size_t k = o / band, rest = o % band;
        out[k * P + (size_t)j0 * nx + rest] = sx[k * PS + rest];
    }
}

// step_floor in one block (cluster 0) or a cluster of min(16, ny) blocks
// (min(8, ny) where 16 cannot be resident, as K6); blocks[0] <- the blocks
// launched
int launch_step_floor(const float* x, float* out, int nz, int ny, int nx,
                      int nsteps, int cluster, int* blocks, cudaStream_t s) {
    const int cands[2] = {cluster ? (ny < 16 ? ny : 16) : 1, ny < 8 ? ny : 8};
    for (int c = 0; c < (cluster ? 2 : 1); ++c) {
        const int nb = cands[c];
        const int rows = (ny + nb - 1) / nb, nt = rows * ((nx + 1) / 2);
        const size_t smem = (size_t)nz * rows * nx * sizeof(float);
        if (nt > 1024 || smem > 232448) return (int)cudaErrorInvalidValue;
        *blocks = nb;
        if (!cluster) {
            const int e = kernel_attributes(
                (const void*)step_floor_kernel<false>, smem, false);
            if (e != 0) return e;
            step_floor_kernel<false><<<1, nt, smem, s>>>(x, out, nz, ny, nx,
                                                          1, nsteps);
            return (int)cudaGetLastError();
        }
        const int rc = launch_cluster(step_floor_kernel<true>, nb, nt, smem,
                                      s, x, out, nz, ny, nx, nb, nsteps);
        if (rc != kNoCluster) return rc;
    }
    return (int)cudaErrorLaunchOutOfResources;
}

// the windows form stages what the term table reads: planes k-1 .. k+1
// (the ring's reach), rows and columns 0 .. 2 of the extended quads
bool terms_in_ring(const Terms& tt) {
    for (int m = 0; m < kTerms; ++m)
        if (tt.dk[m] < -1 || tt.dk[m] > 1 || tt.oj[m] < 0 || tt.oj[m] > 2
            || tt.oi[m] < 0 || tt.oi[m] > 2 || tt.src[m] < 0 || tt.src[m] > 2)
            return false;
    return true;
}

template <typename B>
int launch_dma_only(const void* e0, const void* e1, const void* e2,
                    const void* blocks, const void* rb, const void* ud,
                    const void* bet, const void* gam, const void* bq,
                    void* out, int nz, int H, int W, int which,
                    const Terms* tt, void* stream) {
    if (which < 0 || which > 2 || (which != 2 && !terms_in_ring(*tt)))
        return (int)cudaErrorInvalidValue;
    const dim3 block(kWI, kWJ);
    const dim3 grid((W + kWI - 1) / kWI, (H + kWJ - 1) / kWJ);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (which == 2)
        dma_only_kernel<B><<<grid, block, 0, s>>>(
            (const float*)e0, (const float*)e1, (const float*)e2,
            (const B*)blocks, (const B*)rb, (const float*)ud,
            (const float*)bet, (const float*)gam, (const float*)bq,
            (float*)out, nz, H, W, which, *tt);
    else if (which == 0)
        dma_only_ring_kernel<B, true><<<grid, block, kWBytes, s>>>(
            (const float*)e0, (const float*)e1, (const float*)e2,
            (const B*)blocks, (const B*)rb, (const float*)ud,
            (const float*)bet, (const float*)gam, (const float*)bq,
            (float*)out, nz, H, W, *tt);
    else
        dma_only_ring_kernel<B, false><<<grid, block, kWBytes, s>>>(
            (const float*)e0, (const float*)e1, (const float*)e2,
            (const B*)blocks, (const B*)rb, (const float*)ud,
            (const float*)bet, (const float*)gam, (const float*)bq,
            (float*)out, nz, H, W, *tt);
    return (int)cudaGetLastError();
}

template <typename B, int TG0>
int launch_bands(const void* const* a, void* out0, void* out1, int nz,
                 int H, int W, cudaStream_t s) {
    const long long tiles = (long long)((H + kProbeRows - 1) / kProbeRows)
                            * ((W + kBandTile - 1) / kBandTile);
    dma_only_bands_kernel<B, TG0><<<(unsigned)tiles, kBandTile * kProbeRows,
                                    0, s>>>(
        (const float*)a[0], (const float*)a[1], (const float*)a[2],
        (const float*)a[3], (const float*)a[4], (const float*)a[5],
        (const float*)a[6], (const float*)a[7], (const B*)a[8],
        (float*)out0, (float*)out1, nz, H, W);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_dma_only(const void* e0, const void* e1, const void* e2,
                const void* blocks, const void* rb, const void* ud,
                const void* bet, const void* gam, const void* bq, void* out,
                int nz, int H, int W, int which, const Terms* tt,
                void* stream) {
    return launch_dma_only<float>(e0, e1, e2, blocks, rb, ud, bet, gam, bq,
                                  out, nz, H, W, which, tt, stream);
}

// K1's loads with bfloat16 blocks (color_update_kernel<float,
// __nv_bfloat16, false>)
int mg_dma_only_bf16(const void* e0, const void* e1, const void* e2,
                     const void* blocks, const void* rb, const void* ud,
                     const void* bet, const void* gam, const void* bq,
                     void* out, int nz, int H, int W, int which,
                     const Terms* tt, void* stream) {
    return launch_dma_only<__nv_bfloat16>(e0, e1, e2, blocks, rb, ud, bet,
                                          gam, bq, out, nz, H, W, which, tt,
                                          stream);
}

// dma_only_bands on the RB colour of first target tg0 (0 or 1): s0, s1 the
// two sibling quads (nz, H+2, W+2), per target bq, ud, bet and the output;
// band: the stack's storage start less lpad values, as relax_tiled.py
// passes it; bf16: a bfloat16 stack
int mg_dma_only_bands(const void* s0, const void* s1, const void* bq0,
                      const void* bq1, const void* ud0, const void* ud1,
                      const void* bet0, const void* bet1, const void* band,
                      void* out0, void* out1, int nz, int H, int W, int tg0,
                      int bf16, void* stream) {
    if (nz < 2 || tg0 < 0 || tg0 > 1) return (int)cudaErrorInvalidValue;
    const void* a[] = {s0, s1, bq0, bq1, ud0, ud1, bet0, bet1, band};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return tg0 ? launch_bands<__nv_bfloat16, 1>(a, out0, out1, nz, H, W, s)
                   : launch_bands<__nv_bfloat16, 0>(a, out0, out1, nz, H, W, s);
    return tg0 ? launch_bands<float, 1>(a, out0, out1, nz, H, W, s)
               : launch_bands<float, 0>(a, out0, out1, nz, H, W, s);
}

// x out (nz, ny, nx) float32 | nz ny nx nsteps cluster | blocks (int*)
int mg_step_floor(const void* x, void* out, int nz, int ny, int nx,
                  int nsteps, int cluster, int* blocks, void* stream) {
    return launch_step_floor((const float*)x, (float*)out, nz, ny, nx,
                             nsteps, cluster, blocks,
                             static_cast<cudaStream_t>(stream));
}

int mg_fma_run(const void* x, void* out, int n, int ntiles, void* stream) {
    if (ntiles < 1 || ntiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + 255) / 256, ntiles);
    fma_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        (const float*)x, (float*)out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
