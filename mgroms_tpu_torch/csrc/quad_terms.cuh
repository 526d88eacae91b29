// Shared by the quad-parity kernels (relax_tiled.cu, sweep_fused.cu): the
// term counts of the 16-term neighbour gather, relax_tiled.cu's per-term
// read recipe (sweep_fused.cu compiles its own, on the band quads) and the
// upcast of an operator value to the state type.
#pragma once

#include <cuda_bf16.h>

constexpr int kTerms = 16;      // 12 base gather terms + 4 plane-0 'real'
constexpr int kBaseKeys = 12;   // blocks side by side in the wide array

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
