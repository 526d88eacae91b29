// Shared by the quad-parity kernels (relax_tiled.cu, sweep_fused.cu,
// rr_fused.cu, roofline.cu): the term counts of the 16-term neighbour
// gather, the band stack's row layout, the per-term read recipe of the
// gather blocks built in Python (roofline.cu's dma_only), the compiled
// recipe on the band quads (term_of) and the upcast of an operator value
// to the state type.
#pragma once

#include <cuda_bf16.h>

constexpr int kTerms = 16;      // 12 base gather terms + 4 plane-0 'real'
constexpr int kBaseKeys = 12;   // blocks side by side in the wide array

// The band stack (relax_compact.band_quads) is stored in tiles of
// kBandTile columns (relax_compact.BAND_TILE).
constexpr int kBandTile = 64;

// The band stack's row layout (relax_compact.band_layout): values per 16
// bytes, the storage column of extended column 0 and the row pitch, a
// multiple of 16 bytes with room for every tile's staged span.
template <typename B>
struct BandLayout {
    static constexpr int e16 = 16 / sizeof(B);
    static constexpr int lpad = e16 - 1;
    static constexpr int span = kBandTile + e16;  // values staged per tile row
    static constexpr int chunks = span / e16;    // 16-byte copies a tile row
    __host__ __device__ static int pitch(int W) {
        return (W + kBandTile - 1) / kBandTile * kBandTile + 2 * e16;
    }
};

// Per-term read recipe, built in Python (relax_tiled.term_table): for term
// m the state value is quad src[m] at z-offset dk[m], extended row J+oj[m],
// extended column I+oi[m]; the operator value is block blk[m] (blk >= 12:
// half blk-12 of the plane-0 'real' pair).
struct Terms {
    int src[kTerms];
    int dk[kTerms];
    int oj[kTerms];
    int oi[kTerms];
    int blk[kTerms];
};

// Operator blocks are stored in the state type or, for the low-precision
// smoother operator, in bfloat16; the gather multiplies in the state type
// (the upcast is exact, as the plain versions' .to(dtype) is).
__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ double up(double v) { return v; }
__device__ __forceinline__ float up(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// ---------------------------------------- the term recipe on the band quads

// One term's reads for target quad t (_TKEYS index, (a, b) = (t >> 1,
// t & 1)): the band value is band quad `band` (band_quads order) at plane
// k + bk, extended row J + bj, column I + bi; the state value is quad
// `src` at plane k + dk, extended row J + oj, column I + oi.  The index
// algebra of relax_compact._qread and of the JAX kernel's band_read
// (sweep_fused.band_term_table builds the same table in Python; the CUDA
// tests hold the two equal through mg_sweep_terms).
struct Term {
    int band, bk, bj, bi, src, dk, oj, oi;
};

__host__ __device__ constexpr int pmod2(int x) { return ((x % 2) + 2) % 2; }

// term m of relax_compact._BASE_TERMS then _REAL_TERMS, in the summation
// order: band n, band offset (bk, bj, bi), state offset (pk, pj, pi)
__host__ __device__ constexpr Term term_of(int t, int m) {
    int n = 0, bk = 0, bj = 0, bi = 0, pk = 0, pj = 0, pi = 0;
    switch (m) {
        case 0: n = 3; pk = 1; pj = -1; break;
        case 1: n = 3; bk = -1; bj = 1; pk = -1; pj = 1; break;
        case 2: n = 4; pj = -1; break;
        case 3: n = 4; bj = 1; pj = 1; break;
        case 4: n = 5; pk = -1; pj = -1; break;
        case 5: n = 5; bk = 1; bj = 1; pk = 1; pj = 1; break;
        case 6: n = 6; pk = 1; pi = -1; break;
        case 7: n = 6; bk = -1; bi = 1; pk = -1; pi = 1; break;
        case 8: n = 7; pi = -1; break;
        case 9: n = 7; bi = 1; pi = 1; break;
        case 10: n = 8; pk = -1; pi = -1; break;
        case 11: n = 8; bk = 1; bi = 1; pk = 1; pi = 1; break;
        case 12: n = 5; pj = 1; pi = -1; break;
        case 13: n = 5; bj = -1; bi = 1; pj = -1; pi = 1; break;
        case 14: n = 8; pj = -1; pi = -1; break;
        default: n = 8; bj = 1; bi = 1; pj = 1; pi = 1; break;
    }
    const int a = t >> 1, b = t & 1;
    const int kb0 = pmod2(a + bj), kb1 = pmod2(b + bi);
    const int a2 = pmod2(a + pj), b2 = pmod2(b + pi);
    return Term{(n - 3) * 4 + 2 * kb0 + kb1, bk, 1 + (a + bj - kb0) / 2,
                1 + (b + bi - kb1) / 2, 2 * a2 + b2, pk,
                1 + (a + pj - a2) / 2, 1 + (b + pi - b2) / 2};
}

// a compile-time term index, for the generic lambda of the gather
template <int N>
struct Int {
    static constexpr int value = N;
};
