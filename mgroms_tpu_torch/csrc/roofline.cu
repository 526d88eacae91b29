// Roofline probes of the level-0 smoother for Hopper (sm_90a): how long K1's
// loads alone take, and the card's float32 FMA rate.
//
//   dma_only  <- scripts/micro_roofline.py:dma_only (copy_kernel)
//   fma_run   <- scripts/micro_roofline.py:fma_run (fma_kernel)
//
// dma_only takes K1's operands at K1's shapes (ops/kernels/relax_tiled.py
// _shapes), K1's grid (32 x 8 threads per block, one thread per (J, I)
// column) and K1's per-plane load pattern (relax_tiled.cu gather and
// color_update_kernel): the 12 state values of the term table (and the 4
// 'real' ones on plane 0), the 12 operator blocks (and the 'real' pair on
// plane 0; float32, or bfloat16 as K1 reads them in perf mode), ud at k-1,
// bet, and the RHS.  `which` selects all of them, only
// the state windows (with the RHS) or only the blocks (with the RHS), as the
// TPU probe's three variants.  Its body is trivial: every loaded value is
// added, in a fixed order, into the output, so no load can be dropped and
// the plain version (roofline.dma_only_plain) computes the same sums bit
// for bit.  K1's time against this one's says whether K1 is bound by its
// bytes.  Bound: memory.
//
// fma_run: 8 independent chains x 64 chained fused multiply-adds per
// element of a (8, 8, 512) block, over 256 tiles (every tile recomputes the
// block and writes the same values), then the 8 chains summed.  The build
// has -fmad=false, so the FMAs are written as __fmaf_rn.  Bound:
// operations; its time gives the measured float32 FMA rate.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "quad_terms.cuh"

namespace {

constexpr int kFmaChains = 8;
constexpr int kFmaReps = 64;

// which: 0 all, 1 the state windows, 2 the blocks (each with the RHS).  B:
// the block type, float or bfloat16 (K1 on the low-precision smoother
// operator), upcast at load as K1 does.
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

template <typename B>
int launch_dma_only(const void* e0, const void* e1, const void* e2,
                    const void* blocks, const void* rb, const void* ud,
                    const void* bet, const void* gam, const void* bq,
                    void* out, int nz, int H, int W, int which,
                    const Terms* tt, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    dma_only_kernel<B><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        (const float*)e0, (const float*)e1, (const float*)e2,
        (const B*)blocks, (const B*)rb, (const float*)ud, (const float*)bet,
        (const float*)gam, (const float*)bq, (float*)out, nz, H, W, which,
        *tt);
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

int mg_fma_run(const void* x, void* out, int n, int ntiles, void* stream) {
    if (ntiles < 1 || ntiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + 255) / 256, ntiles);
    fma_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        (const float*)x, (float*)out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
