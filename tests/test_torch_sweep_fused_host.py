"""K4's source (csrc/sweep_fused.cu) built for the host and held to the
plain sweep bit for bit, on the CPU, at every depth of its staging ring.

The CUDA kernel cannot run here.  Its own source is compiled with g++
instead: the CUDA keywords as empty macros, each block's threads as host
threads meeting at a barrier where the block's do (``__syncthreads``), the
grid's at another (the cooperative grid barrier between the colours), a
block's shared memory a buffer of its own, and each ``cp.async`` a copy
made when it is issued.  So the ring's slots, the order in which a tile's
planes are staged and read, the runs of tiles a block walks, and the next
tile's first planes staged before the back substitution are the source's
own; only the copies land at once.  The launcher and the C entries are
cut: the test picks the kernel of a depth through ``sweep_kernel_at``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mgroms_tpu_torch.ops import relax_compact as rc
from mgroms_tpu_torch.ops.kernels import sweep_fused as ksf

torch.set_num_threads(1)

SOURCE = (Path(ksf.__file__).resolve().parents[2] / "csrc"
          / "sweep_fused.cu")

_PRELUDE = r"""
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x)
struct dim3 { unsigned x, y, z; };
static thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
static thread_local std::barrier<>* block_barrier;
static thread_local unsigned char* block_smem;
static std::barrier<>* grid_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
    const uint32_t u = uint32_t(b.bits) << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
namespace cooperative_groups {
struct grid_group { void sync() { grid_barrier->arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}
"""

_HOST_GRID = r"""
template <typename T, typename B>
static int run(const SweepArgs* a, int nz, int H, int W, int real,
               int ahead, int nt, int grid) {
    const void* kern = sweep_kernel_at<T, B>(ahead);
    if (!kern) return 1;
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
    const size_t smem = Smem<T, B>::bytes(nz, nt, ahead);
    // a block's shared memory starts with stale bytes
    std::vector<std::vector<unsigned char>> mem(
        grid, std::vector<unsigned char>(smem + 16, 0xab));
    std::deque<std::barrier<>> bars;
    for (int b = 0; b < grid; ++b) bars.emplace_back(nt);
    std::barrier<> all(grid * nt);
    grid_barrier = &all;
    auto fn = reinterpret_cast<void (*)(const Params<T, B>)>(
        const_cast<void*>(kern));
    std::vector<std::thread> threads;
    for (int b = 0; b < grid; ++b)
        for (int t = 0; t < nt; ++t)
            threads.emplace_back([&, b, t] {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                blockDim = {(unsigned)nt, 1, 1};
                gridDim = {(unsigned)grid, 1, 1};
                block_barrier = &bars[b];
                block_smem = reinterpret_cast<unsigned char*>(
                    (reinterpret_cast<uintptr_t>(mem[b].data()) + 15)
                    / 16 * 16);
                fn(p);
            });
    for (auto& t : threads) t.join();
    return 0;
}
extern "C" int host_f32(const SweepArgs* a, int nz, int H, int W, int real,
                        int ahead, int nt, int grid) {
    return run<float, float>(a, nz, H, W, real, ahead, nt, grid);
}
extern "C" int host_bf16(const SweepArgs* a, int nz, int H, int W,
                         int real, int ahead, int nt, int grid) {
    return run<float, __nv_bfloat16>(a, nz, H, W, real, ahead, nt, grid);
}
"""


def host_source() -> str:
    """The kernel's source, its term header inlined, with the CUDA
    headers, the copy instructions' inline assembly, the launcher and the C
    entries replaced."""
    terms = (SOURCE.parent / "quad_terms.cuh").read_text()
    src = SOURCE.read_text().replace('#include "quad_terms.cuh"', terms)
    for inc in ("cooperative_groups.h", "cuda_bf16.h", "cuda_runtime.h"):
        src = src.replace(f"#include <{inc}>", "")
    # each inline-assembly statement, by its instruction: the copies made
    # at once, the waits gone
    asm = {"cp.async.ca.shared.global": "std::memcpy(dst, src, N);",
           "cp.async.cg.shared.global": "std::memcpy(dst, src, 16);",
           "cp.async.commit_group": ";", "cp.async.wait_group": ";",
           "cp.async.wait_all": ";"}
    while "asm volatile(" in src:
        start = src.index("asm volatile(")
        key = next(k for k in asm if src.startswith(f'asm volatile("{k}',
                                                      start))
        end = src.index(";", src.index(")", start + len(key) + 15)) + 1
        src = src[:start] + asm[key] + src[end:]
    assert "asm" not in src
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem[];", "unsigned char* smem = block_smem;")
    return (src[:src.index("// The launch plan of one sweep")]
            + "}  // namespace\n" + _HOST_GRID)


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("k4_host")
    (d / "k4_host.cpp").write_text(_PRELUDE + host_source())
    # -ffp-contract=off: no fused multiply-add, as -fmad=false on the card
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-o", str(d / "k4_host.so"),
                    str(d / "k4_host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "k4_host.so"))
    for fn in (lib.host_f32, lib.host_bf16):
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7
    return lib


def host_sweep(lib, q, bq, pack, ahead, nt, grid):
    """One sweep of K4's host build with ring depth ``ahead``, ``nt``
    threads a block and ``grid`` blocks (None: no kernel of that depth)."""
    nz, H, W = q[(0, 0)].shape
    ebands, bet, band = ksf.sweep_bands(pack, torch.float32)
    out = {t: torch.full_like(q[(0, 0)], float("nan")) for t in rc._TKEYS}
    arr = lambda xs: (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    lpad, _ = rc.band_layout(W, ebands.element_size())
    args = ksf._SweepArgs(arr([q[t] for t in rc._TKEYS]),
                          arr([bq[t] for t in rc._TKEYS]),
                          ebands.data_ptr() - lpad * ebands.element_size(),
                          arr(pack.ud), arr(bet),
                          arr([out[t] for t in rc._TKEYS]))
    fn = lib.host_bf16 if band == torch.bfloat16 else lib.host_f32
    rc_ = fn(ctypes.byref(args), nz, H, W, int(pack.real_matrix), ahead, nt,
             grid)
    return None if rc_ else out


def inputs(nz, H, W, real, lp, seed):
    g = torch.Generator().manual_seed(seed)
    cA = torch.rand((8, nz, 2 * H + 2, 2 * W + 2), generator=g,
                    dtype=torch.float64) * 0.2 - 0.1
    cA[0] -= 4.0
    pack = rc.build_band_pack(cA.float(), real)
    if lp:
        pack = rc.attach_lp(pack)
    q, bq = (rc.split_quads(torch.randn((nz, 2 * H, 2 * W), generator=g))
             for _ in range(2))
    return q, bq, pack


# (quads, threads a block, blocks): planes fewer and more than the ring
# holds, a one-column quad, W over two 64-column tiles, one-row tiles (64
# threads), and grids below, at and above a colour's tile count, so that a
# block walks runs of one, several and no tiles of a target
CASES = [((6, 5, 70), 128, 3), ((2, 1, 1), 128, 2), ((9, 3, 130), 64, 4),
         ((16, 7, 65), 128, 5), ((12, 6, 33), 128, 1)]


# (ring depth, bfloat16 bands): both depths of the plan in both band
# types, and the depth only a timing asks for (float32 bands only)
DEPTHS = [(a, lp) for a in (2, 7) for lp in (False, True)] + [(13, False)]


@pytest.mark.parametrize("ahead,lp", DEPTHS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_host_build_is_bit_exact_at_every_ring_depth(host_k4, ahead, lp,
                                                     case):
    """At each ring depth K4 has a kernel of: one sweep equals the plain
    sweep bit for bit, 'real' on in every other case."""
    shape, nt, grid = CASES[case]
    q, bq, pack = inputs(*shape, case % 2 == 0, lp, seed=ahead + case)
    got = host_sweep(host_k4, q, bq, pack, ahead, nt, grid)
    want = ksf.relax_fused_sweep_plain(q, bq, pack, 1)
    for t in rc._TKEYS:
        assert torch.equal(got[t], want[t]), (shape, nt, grid, t)


def test_host_build_has_no_other_depths(host_k4):
    q, bq, pack = inputs(4, 2, 3, True, False, 0)
    for ahead in (0, 1, 3, 4, 5, 6, 8, 12, 14):
        assert host_sweep(host_k4, q, bq, pack, ahead, 128, 1) is None
    q, bq, pack = inputs(4, 2, 3, True, True, 0)
    assert host_sweep(host_k4, q, bq, pack, 13, 128, 1) is None
