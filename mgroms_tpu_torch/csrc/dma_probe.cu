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
// The streams (and for `wide` the row chunks) are staged through a ring
// of shared-memory stages filled asynchronously, the counterpart of the
// TPU's pl.Buffered(2): warp 0 asks for each stage with 1-D bulk copies
// (cp.async.bulk, one per contiguous span: the whole stage where rows are
// contiguous, else one per row) completed on the stage's mbarrier with
// its transaction bytes; every thread waits on that barrier, adds, and
// after a block barrier the freed stage is refilled with the stream (or
// chunk) `stages` ahead.  So while stream s is added, streams s+1 ..
// s+stages-1 are in flight.  What sets the load rate on the H100 is the
// bytes in flight per SM, i.e. the blocks an SM holds: PR 6's kernel held
// 16 accumulators a thread (128 registers, one block an SM) and staged
// 8-13 KB a round, so little was ever in flight.  Here a thread holds only
// the accumulators its outputs need (NACC: 4 for the windows and blocks,
// 16 for the j-lead windows) and, where the block's outputs are whole
// rows, their places in a stage as one base and a step, so registers
// leave room for four blocks an SM (three with 16 accumulators); and the
// ring stays within kRingBytes (at least two
// stages, at most kMaxStages: blocks 4 x 8 KB and case A 3 x 12.7 KB, so
// four blocks fit an SM; j-lead windows, windows 516 wide and the wide
// stream 2 x ~50 KB, two).  Every staged byte lands in
// shared memory: the copy engine writes the whole span.  Bound: memory.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// geometry the kernels do not take (more than kMaxStreams streams, more
// outputs than a block holds, a staged span over kMaxSmem, a row length,
// pitch or plane stride not a multiple of 4 floats, which the bulk
// copies' 16-byte alignment needs); these checks are the only ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 64;
constexpr int kThreads = 512;
constexpr int kMaxAcc = 16;            // outputs per thread
constexpr int kMaxSmem = 226 * 1024;    // a block's shared memory, less the static mbarriers
constexpr int kMaxStages = 4;
constexpr int kRingBytes = 48 * 1024;   // shared memory a block's ring aims at

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// the one arrival of a stage's phase, with the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                     "\n\tselp.u32 %0, 1, 0, p;\n\t}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completed on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// Warp 0: ask for nrows x rowlen floats (rows `pitch` apart) into `dst`,
// completing on `bar`: one copy for a contiguous span, else one per row.
__device__ __forceinline__ void stage_rows(const float* src, float* dst,
                                           int nrows, int rowlen,
                                           long long pitch, uint64_t* bar) {
    const int lane = threadIdx.x;
    const uint32_t row_bytes = (uint32_t)rowlen * sizeof(float);
    if (lane == 0) mbar_expect(bar, row_bytes * nrows);
    __syncwarp();
    if (pitch == rowlen) {
        if (lane == 0) bulk_copy(dst, src, row_bytes * nrows, bar);
        return;
    }
    for (int r = lane; r < nrows; r += 32)
        bulk_copy(dst + (size_t)r * rowlen, src + r * pitch, row_bytes, bar);
}

// The ring: item s (a stream, or a row chunk) goes to stage s % stages of
// `sf` floats; `issue(s, dst, bar)` (warp 0) asks for it, `use(s, st)`
// (every thread) reads it once it has landed.  A stage is refilled only
// after a block barrier, when no thread reads it any more.
template <typename Issue, typename Use>
__device__ __forceinline__ void ring(int n, int stages, int sf, Issue issue,
                                     Use use) {
    __shared__ __align__(8) uint64_t full[kMaxStages];
    extern __shared__ __align__(128) float stage[];
    if (threadIdx.x == 0) {
        for (int st = 0; st < stages; ++st) mbar_init(&full[st]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32)
        for (int s = 0; s < n && s < stages; ++s)
            issue(s, stage + (size_t)s * sf, &full[s]);
    for (int s = 0; s < n; ++s) {
        const int st = s % stages;
        mbar_wait(&full[st], (uint32_t)(s / stages) & 1);
        use(s, stage + (size_t)st * sf);
        __syncthreads();
        if (threadIdx.x < 32 && s + stages < n)
            issue(s + stages, stage + (size_t)st * sf, &full[st]);
    }
}

// Blocks an SM should hold, which sets the registers a thread may use:
// NACC accumulators, and the outputs' places in a stage (one base and a
// step where REG, the block's outputs a whole number of rows; one each
// else).
template <int NACC, bool REG>
constexpr int kMinBlocks = REG ? (NACC <= 8 ? 4 : 3) : (NACC <= 4 ? 2 : 1);

template <int NACC, bool REG>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<NACC, REG>))
staged_sum_kernel(ProbeStreams xs, ProbeGeom g, float* __restrict__ out,
                  int stages, int sf) {
    const int i = blockIdx.x;
    const int zb = blockIdx.y;
    const long long src_off = (long long)i * g.tj * g.pitch
                              + (long long)zb * g.zstride;
    const int nout = g.tj * g.zc * g.ow;
    // output e = threadIdx.x + r * blockDim.x: (row jj, plane zl, column c)
    auto split = [&](int e, int& jj, int& zl, int& c) {
        jj = e / (g.zc * g.ow);
        const int rem = e - jj * g.zc * g.ow;
        zl = rem / g.ow;
        c = rem - zl * g.ow;
    };
    // where this thread's outputs sit in a stage: with REG, output r is
    // blockDim.x / (zc * ow) rows below output 0
    constexpr int NS = REG ? 1 : NACC;
    int soff[NS];
#pragma unroll
    for (int r = 0; r < NS; ++r) {
        int jj, zl, c;
        split(threadIdx.x + r * blockDim.x, jj, zl, c);
        soff[r] = (jj + g.off) * g.rowlen + zl * g.wide + c + g.off;
    }
    const int sstep = REG ? (int)blockDim.x / (g.zc * g.ow) * g.rowlen : 0;
    float acc[NACC];
    ring(g.nstreams, stages, sf,
         [&](int s, float* dst, uint64_t* bar) {
             stage_rows(xs.x[s] + src_off, dst, g.nrows, g.rowlen, g.pitch,
                        bar);
         },
         [&](int s, const float* st) {
#pragma unroll
             for (int r = 0; r < NACC; ++r) {
                 if (threadIdx.x + r * blockDim.x < nout) {
                     const float v = st[REG ? soff[0] + r * sstep
                                            : soff[REG ? 0 : r]];
                     acc[r] = s == 0 ? v : acc[r] + v;
                 }
             }
         });
    const long long out_off = (long long)i * g.tj * g.out_jpitch
                              + (long long)zb * g.out_zstride;
#pragma unroll
    for (int r = 0; r < NACC; ++r) {
        const int e = threadIdx.x + r * blockDim.x;
        if (e < nout) {
            int jj, zl, c;
            split(e, jj, zl, c);
            out[out_off + jj * g.out_jpitch + zl * g.out_zpitch + c] = acc[r];
        }
    }
}

// main2's one wide stream: block (i, z) walks rows i*tj .. i*tj + tj of
// plane z in chunks of rc rows through the ring; each chunk (rc rows of
// ng*gw floats, one contiguous span) is staged, then each output (row, c)
// of the chunk sums its ng lane groups in order.
__global__ void __launch_bounds__(kThreads)
wide_stream_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int H, int tj, int ng, int gw, int rc, int stages,
                   int sf) {
    const int i = blockIdx.x;
    const int z = blockIdx.y;
    const int ww = ng * gw;
    const long long row0 = (long long)z * H + (long long)i * tj;
    ring(tj / rc, stages, sf,
         [&](int s, float* dst, uint64_t* bar) {
             stage_rows(x + (row0 + (long long)s * rc) * ww, dst, rc, ww, ww,
                        bar);
         },
         [&](int s, const float* st0) {
             for (int e = threadIdx.x; e < rc * gw; e += blockDim.x) {
                 const int r = e / gw;
                 const int c = e - r * gw;
                 const float* st = st0 + r * ww + c;
                 float acc = st[0];
                 for (int m = 1; m < ng; ++m) acc = acc + st[m * gw];
                 out[(row0 + (long long)s * rc + r) * gw + c] = acc;
             }
         });
}

// Stages of `span` floats each (rounded up to 128 bytes) for a ring:
// as many as fit kRingBytes, at least two (one when two do not fit a
// block), at most kMaxStages.  Returns the stage size in floats.
int ring_plan(long long span, int& stages) {
    const long long sf = (span + 31) / 32 * 32;
    const long long bytes = sf * (long long)sizeof(float);
    stages = (int)(kRingBytes / bytes);
    stages = stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
    if (stages * bytes > kMaxSmem) stages = (int)(kMaxSmem / bytes);
    return (int)sf;
}

// the dynamic shared memory a launch asks for; set whatever its size
// (dynamic 48 KB beside the static mbarriers is already past the default)
int set_smem(const void* kernel, size_t smem) {
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NACC, bool REG>
int launch_staged(const ProbeStreams& ps, const ProbeGeom& g, float* out,
                  int nsteps, int nzb, int stages, int sf, size_t smem,
                  cudaStream_t st) {
    int e = set_smem((const void*)staged_sum_kernel<NACC, REG>, smem);
    if (e) return e;
    staged_sum_kernel<NACC, REG><<<dim3(nsteps, nzb), kThreads, smem, st>>>(
        ps, g, out, stages, sf);
    return (int)cudaGetLastError();
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
    int stages = 0;
    const int sf = ring_plan((long long)g->nrows * g->rowlen, stages);
    if (stages < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)stages * sf * sizeof(float);
    ProbeStreams ps = {};
    for (int s = 0; s < g->nstreams; ++s) ps.x[s] = xs[s];
    // accumulators a thread holds: as few as the outputs need, so the
    // registers leave room for several blocks an SM
    const int per = (g->tj * g->zc * g->ow + kThreads - 1) / kThreads;
    const bool reg = kThreads % (g->zc * g->ow) == 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* o = (float*)out;
    if (per <= 4)
        return reg ? launch_staged<4, true>(ps, *g, o, nsteps, nzb, stages,
                                            sf, smem, st)
                   : launch_staged<4, false>(ps, *g, o, nsteps, nzb, stages,
                                             sf, smem, st);
    if (per <= 8)
        return reg ? launch_staged<8, true>(ps, *g, o, nsteps, nzb, stages,
                                            sf, smem, st)
                   : launch_staged<8, false>(ps, *g, o, nsteps, nzb, stages,
                                             sf, smem, st);
    return reg ? launch_staged<16, true>(ps, *g, o, nsteps, nzb, stages, sf,
                                         smem, st)
               : launch_staged<16, false>(ps, *g, o, nsteps, nzb, stages, sf,
                                          smem, st);
}

int mg_probe_wide(const void* x, void* out, int nz, int H, int tj, int ng,
                  int gw, int rc, void* stream) {
    if (rc < 1 || tj % rc || H % tj || (ng * gw) % 4)
        return (int)cudaErrorInvalidValue;
    int stages = 0;
    const int sf = ring_plan((long long)rc * ng * gw, stages);
    if (stages < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)stages * sf * sizeof(float);
    int e = set_smem((const void*)wide_stream_kernel, smem);
    if (e) return e;
    wide_stream_kernel<<<dim3(H / tj, nz), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        (const float*)x, (float*)out, H, tj, ng, gw, rc, stages, sf);
    return (int)cudaGetLastError();
}

}  // extern "C"
