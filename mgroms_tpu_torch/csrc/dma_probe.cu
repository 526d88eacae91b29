// Load-rate probes for Hopper (sm_90a) (K11): how fast the card moves the
// stream shapes of the smoother kernels from device memory into shared
// memory.
//
// Replaces the four Pallas TPU probes of scripts/micro_dma_probe.py:
//
//   probe_windows        <- probe_windows (:28, pallas_call :46)
//   probe_blocks         <- probe_blocks (:60, pallas_call :75)
//   probe_windows_jlead  <- probe_windows_jlead (:165, pallas_call :184)
//   probe_wide_stream    <- main2's one-wide-stream kernel (:242-260)
//
// What each computes (float32, the streams summed left to right, as the
// TPU kernels' acc = acc + x, so the plain versions in
// ops/kernels/dma_probe.py match bit for bit):
//
//   windows  out[z, j, c] = sum_s x_s[z, j + 2, c + 2]   x_s (nz, hs, wide)
//   blocks   out = sum_s x_s                             x_s (nz, H, Wc)
//   jlead    out[j, z, c] = sum_s x_s[j + 2, z, c + 2]   x_s (hs, nz, wide)
//   wide     out = sum_{m < ng} x[:, :, 128 m : 128 (m + 1)]   x (nz, H, 128 ng)
//
// What each loads.  The probes measure a load pattern, so each moves the
// bytes the TPU's DMA moved: at every grid step i (rows i*tj ..) every
// byte of every stream's window (ws rows of all `wide` columns, rows that
// the next step loads again included; tj rows for the blocks) is copied
// into shared memory, the counterpart of the VMEM buffer, and the output
// slice is then summed from shared memory.  A whole step's window does
// not fit one block (811 KB per stream at nz 64, ws 24, wide 132; a block
// has 227 KB), so the step is split over blocks:
//
//   windows, blocks  one block per (step, plane): the plane's window,
//                    ws x wide (tj x Wc) floats, one contiguous span;
//   jlead            one block per (step, chunk of zc planes): ws rows of
//                    zc * wide contiguous floats, nz * wide apart;
//   wide             one block per (step, plane), walking its tj rows in
//                    chunks of rc rows (rc * 128 ng contiguous floats).
//
// The streams (and for `wide` the row chunks) go through one shared
// buffer in turn: load, barrier, add, barrier.  Every staged float is
// stored to shared memory, which the compiler cannot drop; the loads are
// 16-byte vectors (every row length and pitch is a multiple of 4 floats).
// Plain loads, one buffer: cp.async or TMA double buffering (the TPU's
// pl.Buffered(2)) is later work.  Bound: memory.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// geometry the kernels do not take (more than kMaxStreams streams, more
// outputs than a block holds, a staged span over kMaxSmem, a row length
// or pitch not a multiple of 4 floats); these checks are the only ones.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 64;
constexpr int kThreads = 512;
constexpr int kMaxAcc = 16;            // outputs per thread
constexpr int kMaxSmem = 227 * 1024;

}  // namespace

// The stream pointers, by value in the kernel's parameters.
struct ProbeStreams {
    const float* x[kMaxStreams];
};

// One staged-sum probe (windows, blocks, jlead), in floats.  Block
// (i, zb) stages, per stream, `nrows` rows of `rowlen` floats from
// x_s + i*tj*pitch + zb*zstride (rows `pitch` apart), then adds, for
// output row jj < tj, plane zl < zc and column c < ow, the staged value
// at row jj + off, column zl*wide + c + off into
// out[i*tj*out_jpitch + zb*out_zstride + jj*out_jpitch + zl*out_zpitch + c].
struct ProbeGeom {
    int nstreams;
    int nrows;
    int rowlen;
    int tj;
    int zc;
    int wide;
    int off;
    int ow;
    long long pitch;
    long long zstride;
    long long out_jpitch;
    long long out_zpitch;
    long long out_zstride;
};

namespace {

// Copy nrows x rowlen floats (rows `pitch` apart) into `stage`, 16 bytes
// a thread at a time.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* stage, int nrows,
                                           int rowlen, long long pitch) {
    const int v4 = rowlen / 4;
    const int n4 = nrows * v4;
    float4* st = reinterpret_cast<float4*>(stage);
    if (pitch == rowlen) {                     // one contiguous span
        const float4* s4 = reinterpret_cast<const float4*>(src);
        for (int v = threadIdx.x; v < n4; v += blockDim.x) st[v] = s4[v];
        return;
    }
    for (int v = threadIdx.x; v < n4; v += blockDim.x) {
        const int r = v / v4;
        const int c = v - r * v4;
        st[v] = *reinterpret_cast<const float4*>(src + r * pitch + 4 * c);
    }
}

__global__ void __launch_bounds__(kThreads)
staged_sum_kernel(ProbeStreams xs, ProbeGeom g, float* __restrict__ out) {
    extern __shared__ __align__(16) float stage[];
    const int i = blockIdx.x;
    const int zb = blockIdx.y;
    const long long src_off = (long long)i * g.tj * g.pitch
                              + (long long)zb * g.zstride;
    const int nout = g.tj * g.zc * g.ow;
    float acc[kMaxAcc];
    for (int s = 0; s < g.nstreams; ++s) {
        stage_rows(xs.x[s] + src_off, stage, g.nrows, g.rowlen, g.pitch);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kMaxAcc; ++r) {
            const int e = threadIdx.x + r * blockDim.x;
            if (e < nout) {
                const int jj = e / (g.zc * g.ow);
                const int rem = e - jj * g.zc * g.ow;
                const int zl = rem / g.ow;
                const int c = rem - zl * g.ow;
                const float v = stage[(jj + g.off) * g.rowlen + zl * g.wide
                                      + c + g.off];
                acc[r] = s == 0 ? v : acc[r] + v;
            }
        }
        __syncthreads();
    }
    const long long out_off = (long long)i * g.tj * g.out_jpitch
                              + (long long)zb * g.out_zstride;
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
        const int e = threadIdx.x + r * blockDim.x;
        if (e < nout) {
            const int jj = e / (g.zc * g.ow);
            const int rem = e - jj * g.zc * g.ow;
            const int zl = rem / g.ow;
            const int c = rem - zl * g.ow;
            out[out_off + jj * g.out_jpitch + zl * g.out_zpitch + c] = acc[r];
        }
    }
}

// main2's one wide stream: block (i, z) walks rows i*tj .. i*tj + tj of
// plane z in chunks of rc rows; each chunk (rc rows of ng*gw floats, one
// contiguous span) is staged, then each output (row, c) of the chunk sums
// its ng lane groups in order.
__global__ void __launch_bounds__(kThreads)
wide_stream_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int H, int tj, int ng, int gw, int rc) {
    extern __shared__ __align__(16) float stage[];
    const int i = blockIdx.x;
    const int z = blockIdx.y;
    const int ww = ng * gw;
    for (int r0 = 0; r0 < tj; r0 += rc) {
        const long long row = (long long)z * H + (long long)i * tj + r0;
        stage_rows(x + row * ww, stage, rc, ww, ww);
        __syncthreads();
        for (int e = threadIdx.x; e < rc * gw; e += blockDim.x) {
            const int r = e / gw;
            const int c = e - r * gw;
            const float* st = stage + r * ww + c;
            float acc = st[0];
            for (int m = 1; m < ng; ++m) acc = acc + st[m * gw];
            out[(row + r) * gw + c] = acc;
        }
        __syncthreads();
    }
}

int set_smem(const void* kernel, size_t smem) {
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// nsteps x nzb blocks of staged_sum_kernel over the g->nstreams stream
// pointers xs
int mg_probe_staged(const float* const* xs, const ProbeGeom* g, void* out,
                    int nsteps, int nzb, void* stream) {
    if (g->nstreams < 1 || g->nstreams > kMaxStreams
        || g->tj * g->zc * g->ow > kMaxAcc * kThreads || g->rowlen % 4
        || g->pitch % 4 || g->zstride % 4)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)g->nrows * g->rowlen * sizeof(float);
    int e = set_smem((const void*)staged_sum_kernel, smem);
    if (e) return e;
    ProbeStreams ps = {};
    for (int s = 0; s < g->nstreams; ++s) ps.x[s] = xs[s];
    staged_sum_kernel<<<dim3(nsteps, nzb), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(ps, *g,
                                                             (float*)out);
    return (int)cudaGetLastError();
}

int mg_probe_wide(const void* x, void* out, int nz, int H, int tj, int ng,
                  int gw, int rc, void* stream) {
    if (rc < 1 || tj % rc || H % tj || (ng * gw) % 4)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)rc * ng * gw * sizeof(float);
    int e = set_smem((const void*)wide_stream_kernel, smem);
    if (e) return e;
    wide_stream_kernel<<<dim3(H / tj, nz), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        (const float*)x, (float*)out, H, tj, ng, gw, rc);
    return (int)cudaGetLastError();
}

}  // extern "C"
