// Quad-parity red-black line-relaxation kernels for Hopper (sm_90a).
//
// Two kernels, one thread per (J, I) column of a target quad, looping
// over z.  They replace the Pallas TPU kernels of
// mgroms_tpu/ops/pallas/relax_tiled.py and compute, term for term and in
// the same operation order, what their plain torch versions in
// mgroms_tpu_torch/ops/kernels/relax_tiled.py compute:
//
//   color_update       <- relax_tiled.py:color_update_tiled (_kernel)
//   color_update_emit  <- relax_tiled.py:color_update_tiled_emit (_kernel_emit)
//
// (K3, relax_tiled.py:_rr_one, is rr_fused.cu: all four targets a launch.)
//
// Bound: memory.  Per column and z-plane a kernel reads 12 operator blocks,
// 12 state values (3 or 4 extended quads), the RHS and 1-3 pivot/diagonal
// fields, and does ~2 flops per value read.  Design for that: I is the
// fastest thread index, so a warp reads 32 adjacent addresses of every
// (nz, H, W)-contiguous array (coalesced); each value is read once per
// kernel from device memory, apart from the state's neighbour reuse, which
// the L1/L2 caches serve.  No shared-memory staging yet: a later step can
// stage the state windows and stream the blocks with TMA.
//
// K1 also reads the low-precision smoother operator (cfg.fused_bands_bf16):
// bfloat16 blocks, upcast at read (exact), the compute in float32 — half
// the bytes of the dominant block stream.  K2 is a residual path and reads
// only full-precision blocks.
//
// Rounding: built with -fmad=false, so every product and sum rounds on its
// own like the separate torch ops of the plain versions (0 ulp apart).
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "quad_terms.cuh"

namespace {

struct Geom {
    int nz, H, W;
    __device__ size_t plane() const { return (size_t)H * W; }
    __device__ size_t eplane() const { return (size_t)(H + 2) * (W + 2); }
};

template <typename T>
__device__ __forceinline__ T state(const T* const* eq, const Terms& tt,
                                   int m, int k, int J, int I,
                                   const Geom& g) {
    int kk = k + tt.dk[m];
    if (kk < 0 || kk >= g.nz) return T(0);
    return eq[tt.src[m]][(size_t)kk * g.eplane()
                         + (size_t)(J + tt.oj[m]) * (g.W + 2)
                         + (I + tt.oi[m])];
}

// Off-column coupling sum at plane k: the 12 base terms summed in order,
// then on plane 0 the four 'real' terms summed into x0 and added last
// (relax_compact.gather_blocks).  Blocks of type B are upcast to T.
template <typename T, typename B>
__device__ __forceinline__ T gather(const T* const* eq, const B* blocks,
                                    const B* rb, int real, const Terms& tt,
                                    int k, int J, int I, const Geom& g) {
    const size_t wrow = (size_t)kBaseKeys * g.W;
    const B* brow = blocks + ((size_t)k * g.H + J) * wrow + I;
    T s = up(brow[0]) * state(eq, tt, 0, k, J, I, g);
#pragma unroll
    for (int m = 1; m < kBaseKeys; ++m) {
        s = s + up(brow[(size_t)m * g.W]) * state(eq, tt, m, k, J, I, g);
    }
    if (real && k == 0) {
        T x0 = T(0);
#pragma unroll
        for (int m = kBaseKeys; m < kTerms; ++m) {
            int b = tt.blk[m];
            T bv = up(b < kBaseKeys
                          ? blocks[(size_t)J * wrow + (size_t)b * g.W + I]
                          : rb[(size_t)J * 2 * g.W
                               + (size_t)(b - kBaseKeys) * g.W + I]);
            T t = bv * state(eq, tt, m, k, J, I, g);
            x0 = (m == kBaseKeys) ? t : x0 + t;
        }
        s = s + x0;
    }
    return s;
}

// K1/K2: one RB colour update of one target quad.  Forward substitution
// x_k = (rhs_k - ud_{k-1} x_{k-1}) * bet_k into `out`, then the back
// substitution x_k -= (ud_k * bet_k) * x_{k+1} in place (gam recomputed,
// ops/relax.thomas_factored_unrolled).  EMIT keeps the gather in `res`
// and then overwrites it with the raw residual bq - d x - lo x_- - hi x_+ - g.
// B is the block type: T, or bfloat16 for the smoother's low-precision
// operator (K1 only).
template <typename T, typename B, bool EMIT>
__global__ void color_update_kernel(const T* __restrict__ e0,
                                    const T* __restrict__ e1,
                                    const T* __restrict__ e2,
                                    const B* __restrict__ blocks,
                                    const B* __restrict__ rb,
                                    const T* __restrict__ ud,
                                    const T* __restrict__ bet,
                                    const T* __restrict__ bq,
                                    const T* __restrict__ d,
                                    T* __restrict__ out,
                                    T* __restrict__ res,
                                    Geom g, int real, Terms tt) {
    const int I = blockIdx.x * blockDim.x + threadIdx.x;
    const int J = blockIdx.y * blockDim.y + threadIdx.y;
    if (I >= g.W || J >= g.H) return;
    const T* eq[3] = {e0, e1, e2};
    const size_t P = g.plane();
    const size_t c = (size_t)J * g.W + I;

    T x = T(0);
    for (int k = 0; k < g.nz; ++k) {
        const size_t o = (size_t)k * P + c;
        T gk = gather(eq, blocks, rb, real, tt, k, J, I, g);
        if (EMIT) res[o] = gk;
        T rhs = bq[o] - gk;
        x = (k == 0) ? rhs * bet[o] : (rhs - ud[o - P] * x) * bet[o];
        out[o] = x;
    }
    for (int k = g.nz - 2; k >= 0; --k) {
        const size_t o = (size_t)k * P + c;
        x = out[o] - (ud[o] * bet[o]) * x;
        out[o] = x;
    }
    if (EMIT) {
        for (int k = 0; k < g.nz; ++k) {
            const size_t o = (size_t)k * P + c;
            T lo = k > 0 ? ud[o - P] : T(0);
            T xm = k > 0 ? out[o - P] : T(0);
            T hi = k < g.nz - 1 ? ud[o] : T(0);
            T xp = k < g.nz - 1 ? out[o + P] : T(0);
            res[o] = bq[o] - d[o] * out[o] - lo * xm - hi * xp - res[o];
        }
    }
}

dim3 grid_for(int H, int W, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
}

const dim3 kBlock(32, 8);

template <typename T, typename B, bool EMIT>
int launch_color_update(const void* e0, const void* e1, const void* e2,
                        const void* blocks, const void* rb, const void* ud,
                        const void* bet, const void* bq, const void* d,
                        void* out, void* res, int nz, int H, int W, int real,
                        const Terms* tt, void* stream) {
    Geom g{nz, H, W};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    color_update_kernel<T, B, EMIT><<<grid_for(H, W, kBlock), kBlock, 0, s>>>(
        (const T*)e0, (const T*)e1, (const T*)e2, (const B*)blocks,
        (const B*)rb, (const T*)ud, (const T*)bet, (const T*)bq,
        (const T*)d, (T*)out, (T*)res, g, real, *tt);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_color_update(const void* e0, const void* e1, const void* e2,
                        const void* blocks, const void* rb, const void* ud,
                        const void* bet, const void* bq, const void* d,
                        void* out, void* res, int nz, int H, int W, int real,
                        int emit, const Terms* tt, void* stream) {
    return emit ? launch_color_update<T, T, true>(
                      e0, e1, e2, blocks, rb, ud, bet, bq, d, out, res, nz,
                      H, W, real, tt, stream)
                : launch_color_update<T, T, false>(
                      e0, e1, e2, blocks, rb, ud, bet, bq, d, out, res, nz,
                      H, W, real, tt, stream);
}

}  // namespace

extern "C" {

int mg_color_update_f32(const void* e0, const void* e1, const void* e2,
                        const void* blocks, const void* rb, const void* ud,
                        const void* bet, const void* bq, const void* d,
                        void* out, void* res, int nz, int H, int W, int real,
                        int emit, const Terms* tt, void* stream) {
    return launch_color_update<float>(e0, e1, e2, blocks, rb, ud, bet, bq, d,
                                      out, res, nz, H, W, real, emit, tt,
                                      stream);
}

int mg_color_update_f64(const void* e0, const void* e1, const void* e2,
                        const void* blocks, const void* rb, const void* ud,
                        const void* bet, const void* bq, const void* d,
                        void* out, void* res, int nz, int H, int W, int real,
                        int emit, const Terms* tt, void* stream) {
    return launch_color_update<double>(e0, e1, e2, blocks, rb, ud, bet, bq,
                                       d, out, res, nz, H, W, real, emit, tt,
                                       stream);
}

// K1 on the low-precision smoother operator: float32 state, bfloat16 blocks
// (no emit form: the emitted residual needs the true operator).
int mg_color_update_bf16(const void* e0, const void* e1, const void* e2,
                         const void* blocks, const void* rb, const void* ud,
                         const void* bet, const void* bq, const void* d,
                         void* out, void* res, int nz, int H, int W, int real,
                         int emit, const Terms* tt, void* stream) {
    if (emit) return (int)cudaErrorInvalidValue;
    return launch_color_update<float, __nv_bfloat16, false>(
        e0, e1, e2, blocks, rb, ud, bet, bq, d, out, res, nz, H, W, real, tt,
        stream);
}

}  // extern "C"
