"""The one-pass divergence RHS (ops/kernels/rhs_fused.py) on the CPU.

The wrapper takes its plain version, ops/rhs.compute_rhs, for CPU tensors
and counts no launch; the module is registered with the kernel modules
(its launch count, its graph-node name); its ctypes argument struct and C
entries match csrc/rhs_fused.cu.  The kernel source itself, compiled by
the host's C++ compiler (CUDA's keywords as empty macros, the launch a
loop over blocks and threads), equals compute_rhs bit for bit on random
metrics at ragged shapes, in float32 and float64, with and without
``bmask``, a strided ``zw`` and given face masks.  On the card the kernel
is held to compute_rhs by tests/test_torch_rhs_cuda.py.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.assembly import FineMetrics, masks_from_rmask
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops import kernels
from mgroms_tpu_torch.ops.kernels import _build, rhs_fused as kr
from mgroms_tpu_torch.ops.rhs import compute_rhs, wall_face_masks

torch.set_num_threads(1)

SOURCE = _build.CSRC / "rhs_fused.cu"
SHAPES = [(5, 7, 9), (1, 3, 4), (2, 1, 1), (16, 33, 31)]


def random_case(nz, ny, nx, dtype, seed, bmask, strided=True,
                faces=False):
    """Random metrics (positive dx, dy, dzw, cw; a random land mask with
    ``bmask``; ``zw`` a view of a halo-2 field when ``strided``), random
    velocities and, with ``faces``, random 0/1 face masks."""
    g = torch.Generator().manual_seed(seed)
    J, I = ny + 2, nx + 2

    def rand(*s):
        return torch.rand(s, generator=g, dtype=dtype)

    def randn(*s):
        return torch.randn(s, generator=g, dtype=dtype)

    rmask = ((rand(J, I) > 0.3).to(dtype) if bmask
             else torch.ones((J, I), dtype=dtype))
    umask, vmask = masks_from_rmask(rmask, bmask)
    zwe = randn(nz + 1, J + 2, I + 2)
    zw = zwe[:, 1:-1, 1:-1]
    m = FineMetrics(dx=0.5 + rand(J, I), dy=0.5 + rand(J, I),
                    zr=randn(nz, J, I),
                    zw=zw if strided else zw.contiguous(),
                    dzw=0.5 + rand(nz + 1, J, I), zx=randn(nz, J, I),
                    zy=randn(nz, J, I), cw=0.5 + rand(nz + 1, J, I),
                    umask=umask, vmask=vmask, rmask=rmask)
    uvw = (randn(nz, J, nx + 1), randn(nz, ny + 1, I), randn(nz + 1, J, I))
    masks = ((rand(ny, nx + 1) > 0.2).to(dtype),
             (rand(ny + 1, nx) > 0.2).to(dtype)) if faces else (None, None)
    return m, uvw, masks


@pytest.mark.parametrize("bmask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_cpu_takes_the_plain_version(shape, dtype, bmask):
    """CPU tensors: rhs_fused is compute_rhs, bit for bit, with the
    default walls and with given face masks, and launches nothing."""
    kernels.reset_launches()
    for faces in (False, True):
        m, uvw, (um, vm) = random_case(*shape, dtype, 3, bmask,
                                       faces=faces)
        got = kr.rhs_fused(m, *uvw, bmask, uface_mask=um, vface_mask=vm)
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(got, compute_rhs(m, *uvw, bmask, um, vm))
    assert kernels.launches()["rhs_fused"] == 0


def test_model_rhs_goes_through_the_wrapper(monkeypatch):
    """NHModel.rhs and check_nondivergence call rhs_fused (on the CPU its
    plain version): the same b as compute_rhs on the model's metrics."""
    calls = []
    wrapped = kr.rhs_fused

    def counted(*a, **k):
        calls.append(1)
        return wrapped(*a, **k)

    import mgroms_tpu_torch.model as model_mod
    monkeypatch.setattr(model_mod, "rhs_fused", counted)
    n = 16
    m = NHModel(n, n, n, cfg=SolverConfig(dtype="float64"), device="cpu")
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(n, n, n, dtype=torch.float64, device="cpu")
    b = m.rhs(u, v, w)
    div = m.check_nondivergence(u, v, w)
    want = compute_rhs(m.metrics, u, v, w, False)
    assert torch.equal(b, want)
    assert float(div) == float(want.abs().max())
    assert len(calls) == 2


def test_registered_with_the_kernel_modules():
    """The module is in MODULES, its count in launches(), and a graph
    node of either instance maps to it."""
    assert kr in kernels.MODULES
    assert "rhs_fused" in kernels.launches()
    for t in ("float", "double"):
        name = (f"void (anonymous namespace)::rhs_kernel<{t}>(RhsArgs, "
                f"int, int, int)")
        assert kernels.kernel_key(name) == "rhs_fused"
    assert kernels.kernel_key("void (anonymous namespace)::rr_kernel"
                              "<float, true, 2>(RRArgs)") != "rhs_fused"


def test_args_struct_and_entries_match_the_source():
    """_RhsArgs lists RhsArgs' members in order, ENTRIES the C entries,
    and _build declares both."""
    src = SOURCE.read_text()
    body = re.search(r"struct RhsArgs \{(.*?)\};", src, re.S).group(1)
    members = re.findall(r"(\w+);", body)
    assert members == [n for n, _ in kr._RhsArgs._fields_]
    assert sorted(kr.ENTRIES.values()) == ["mg_rhs_fused_f32",
                                           "mg_rhs_fused_f64"]
    for entry in kr.ENTRIES.values():
        assert re.search(rf"int {entry}\(const RhsArgs\* a, int nz, "
                         rf"int ny, int nx,", src)
    assert 'f"mg_rhs_fused_{dt}"' in Path(_build.__file__).read_text()


def test_cuda_wrapper_refuses_other_devices():
    m, uvw, _ = random_case(2, 3, 4, torch.float32, 0, False)
    with pytest.raises(ValueError):
        kr.rhs_fused(m, *(x.to("meta") for x in uvw), False)


# ---------------------------------------- the source on the host compiler

_PRELUDE = r"""
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, threadIdx;
"""

_HOST_LOOP = r"""
template <typename T>
static void run(const RhsArgs* a, int nz, int ny, int nx) {
    for (unsigned by = 0; by < (unsigned)((ny + kTileY - 1) / kTileY); ++by)
    for (unsigned bx = 0; bx < (unsigned)((nx + kTileX - 1) / kTileX); ++bx)
    for (unsigned ty = 0; ty < (unsigned)kTileY; ++ty)
    for (unsigned tx = 0; tx < (unsigned)kTileX; ++tx) {
        blockIdx = {bx, by, 0};
        threadIdx = {tx, ty, 0};
        rhs_kernel<T>(*a, nz, ny, nx);
    }
}
extern "C" void host_f32(const RhsArgs* a, int nz, int ny, int nx) {
    run<float>(a, nz, ny, nx);
}
extern "C" void host_f64(const RhsArgs* a, int nz, int ny, int nx) {
    run<double>(a, nz, ny, nx);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/rhs_fused.cu's kernel built for the host: the CUDA include,
    the launcher and the C entries cut, every block and thread run in
    turn (no barrier, no shared memory: the order does not matter)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = SOURCE.read_text().replace("#include <cuda_runtime.h>", "")
    src = (src[:src.index("template <typename T>\nint launch_rhs")]
           + src[src.index("}  // namespace"):src.index('extern "C" {')])
    d = tmp_path_factory.mktemp("rhs_host")
    (d / "rhs_host.cpp").write_text(_PRELUDE + src + _HOST_LOOP)
    # -ffp-contract=off: no fused multiply-add, as -fmad=false on the card
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-o", str(d / "rhs_host.so"),
                    str(d / "rhs_host.cpp")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(d / "rhs_host.so"))
    for fn in (lib.host_f32, lib.host_f64):
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    return lib


def host_rhs(lib, m, u, v, w, bmask, uface=None, vface=None):
    """The kernel's b on the host, with rhs_fused's arguments."""
    nz = u.shape[0]
    ny, nx = m.dx.shape[0] - 2, m.dx.shape[1] - 2
    if bmask:
        uface = vface = None
    else:
        walls = wall_face_masks(ny, nx, u)
        uface = walls[0] if uface is None else uface
        vface = walls[1] if vface is None else vface
    out = torch.empty((nz, ny, nx), dtype=u.dtype)
    ptrs = (u, v, w, m.dx, m.dy, m.zw, m.dzw, m.zx, m.zy, m.cw, m.umask,
            m.vmask, m.rmask, uface, vface, out)
    args = kr._RhsArgs(*(_build.ptr(t) for t in ptrs), m.zw.stride(0),
                       m.zw.stride(1))
    fn = lib.host_f32 if u.dtype == torch.float32 else lib.host_f64
    fn(ctypes.byref(args), nz, ny, nx)
    return out


@pytest.mark.parametrize("faces", [False, True])
@pytest.mark.parametrize("bmask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_host_build_of_the_kernel_is_bit_exact(host_kernel, shape, dtype,
                                               bmask, faces):
    """The kernel's recipe (registers carried a plane, the bottom terms
    once, the faces computed by both columns beside them) equals
    compute_rhs bit for bit, with a strided and a contiguous zw."""
    for strided in (True, False):
        m, uvw, (um, vm) = random_case(*shape, dtype, sum(shape), bmask,
                                       strided=strided, faces=faces)
        got = host_rhs(host_kernel, m, *uvw, bmask, um, vm)
        assert torch.equal(got, compute_rhs(m, *uvw, bmask, um, vm))


def test_host_build_on_the_model_metrics(host_kernel):
    """Seamount 16^3 float32 (the model's own metrics, zw a view of the
    halo-2 field): the kernel's b equals NHModel.rhs's bit for bit."""
    n = 16
    m = NHModel(n, n, n, cfg=SolverConfig(dtype="float32"), device="cpu")
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    assert not m.metrics.zw.is_contiguous()
    uvw = initial_velocities(n, n, n, dtype=torch.float32, device="cpu")
    got = host_rhs(host_kernel, m.metrics, *uvw, False)
    assert torch.equal(got, m.rhs(*uvw))
