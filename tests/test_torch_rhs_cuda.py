"""The one-pass divergence RHS (csrc/rhs_fused.cu) on the card: 0 ulp from
its plain version, ops/rhs.compute_rhs, run on the same card.

Marked ``cuda``: the tests skip without a CUDA device.  Run on a GPU with

    python -m pytest --noconftest tests/test_torch_rhs_cuda.py

Cases: CUC 1024^2 x 64 float32 on the synthetic slope (the model's
metrics, zw a view of the halo-2 field); random metrics at ragged shapes,
in float32 and float64, with ``bmask`` and a random land mask, with a
contiguous zw, and with the face masks of each tile of a 2 x 2 mesh.  A
solve from the kernel's b equals one from the plain version's, pressure
and history bit for bit; on a virtual 2 x 2 mesh of the one card the
distributed rhs (shard_face_masks per tile) equals the single-card one;
``LAUNCHES["rhs_fused"]`` grows by one a ``rhs`` call.
"""

import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.assembly import FineMetrics, masks_from_rmask
from mgroms_tpu_torch.cases.cuc import setup_cuc_synthetic
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops.kernels import launches, reset_launches
from mgroms_tpu_torch.ops.kernels import rhs_fused as kr
from mgroms_tpu_torch.ops.rhs import compute_rhs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_velocities(nz, ny, nx, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, dtype=dtype, device=dev)
                 for s in ((nz, ny + 2, nx + 1), (nz, ny + 1, nx + 2),
                           (nz + 1, ny + 2, nx + 2)))


def random_metrics(nz, ny, nx, dtype, dev, seed, bmask, strided=True):
    """Positive dx, dy, dzw, cw; a random land mask with ``bmask``; zw a
    view of a halo-2 field when ``strided``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    J, I = ny + 2, nx + 2

    def rand(*s):
        return torch.rand(s, generator=g, dtype=dtype, device=dev)

    def randn(*s):
        return torch.randn(s, generator=g, dtype=dtype, device=dev)

    rmask = ((rand(J, I) > 0.3).to(dtype) if bmask
             else torch.ones((J, I), dtype=dtype, device=dev))
    umask, vmask = masks_from_rmask(rmask, bmask)
    zw = randn(nz + 1, J + 2, I + 2)[:, 1:-1, 1:-1]
    return FineMetrics(dx=0.5 + rand(J, I), dy=0.5 + rand(J, I),
                       zr=randn(nz, J, I),
                       zw=zw if strided else zw.contiguous(),
                       dzw=0.5 + rand(nz + 1, J, I), zx=randn(nz, J, I),
                       zy=randn(nz, J, I), cw=0.5 + rand(nz + 1, J, I),
                       umask=umask, vmask=vmask, rmask=rmask)


def tile_face_masks(ny, nx, dtype, dev, pj, pi, npy=2, npx=2):
    """parallel/exchange.shard_face_masks of tile (pj, pi) of an
    (npy, npx) mesh: the wall-normal flux zeroed at physical walls only."""
    um = torch.ones((ny, nx + 1), dtype=dtype, device=dev)
    vm = torch.ones((ny + 1, nx), dtype=dtype, device=dev)
    if pi == 0:
        um[:, 0] = 0.0
    if pi == npx - 1:
        um[:, nx] = 0.0
    if pj == 0:
        vm[0, :] = 0.0
    if pj == npy - 1:
        vm[ny, :] = 0.0
    return um, vm


def assert_same(m, uvw, bmask, um=None, vm=None):
    """The kernel's b equals compute_rhs's on the card, bit for bit, and
    the call counts one launch."""
    before = launches()["rhs_fused"]
    got = kr.rhs_fused(m, *uvw, bmask, uface_mask=um, vface_mask=vm)
    torch.cuda.synchronize()
    assert launches()["rhs_fused"] == before + 1
    want = compute_rhs(m, *uvw, bmask, um, vm)
    diff = (got - want).abs()
    assert torch.equal(got, want), (float(diff.max()),
                                    torch.nonzero(diff)[:4].tolist())


def test_cuc_main_shape(cuda):
    """CUC 1024^2 x 64 float32 on the synthetic slope, the model's own
    metrics, the drivers' field and a random one."""
    n, nz = 1024, 64
    m = NHModel(n, n, nz, cfg=SolverConfig(dtype="float32"), device=cuda)
    c = setup_cuc_synthetic(n, n, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    assert not m.metrics.zw.is_contiguous()
    assert_same(m.metrics, initial_velocities(n, n, nz, dtype=m.dtype,
                                              device=cuda), False)
    assert_same(m.metrics, random_velocities(nz, n, n, m.dtype, cuda, 5),
                False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bmask", [False, True])
@pytest.mark.parametrize("shape", [(5, 7, 9), (64, 33, 31), (1, 3, 4)])
def test_ragged_shapes(cuda, shape, bmask, dtype):
    """Random metrics at ragged shapes: the default walls or the land
    mask, zw strided and contiguous."""
    for strided in (True, False):
        m = random_metrics(*shape, dtype, cuda, sum(shape), bmask, strided)
        assert_same(m, random_velocities(*shape, dtype, cuda, 7), bmask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_face_masks(cuda, dtype):
    """The face masks of each tile of a 2 x 2 mesh (one to two physical
    walls), on a (16, 40, 36) tile."""
    nz, ny, nx = 16, 40, 36
    m = random_metrics(nz, ny, nx, dtype, cuda, 11, False)
    uvw = random_velocities(nz, ny, nx, dtype, cuda, 13)
    for pj in range(2):
        for pi in range(2):
            assert_same(m, uvw, False,
                        *tile_face_masks(ny, nx, dtype, cuda, pj, pi))


def _seamount(dev, n, dtype="float32", **cfg):
    m = NHModel(n, n, n, cfg=SolverConfig(dtype=dtype, **cfg), device=dev)
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def test_solve_from_the_kernel_equals_the_plain_b(cuda):
    """NHModel.solve (b from the kernel) and a solve of compute_rhs's b
    give the same pressure, bit for bit, and the same F-cycles; one launch
    a solve."""
    n = 32
    m = _seamount(cuda, n)
    uvw = initial_velocities(n, n, n, dtype=m.dtype, device=cuda)
    reset_launches()
    *_, p, info = m.solve(*uvw, tol=1e-4)
    assert launches()["rhs_fused"] == 1
    b = compute_rhs(m.metrics, *uvw, m.cfg.bmask)
    p_plain, info_plain = m.pressure_solve(b, tol=1e-4)
    assert info.niter == info_plain.niter
    assert info.history == info_plain.history
    assert torch.equal(p, p_plain)


def test_launches_one_a_rhs_call(cuda):
    """rhs, check_nondivergence and solve each launch the kernel once, in
    float32 and float64 (its two instances)."""
    n = 16
    for dtype in ("float32", "float64"):
        m = _seamount(cuda, n, dtype)
        uvw = initial_velocities(n, n, n, dtype=m.dtype, device=cuda)
        reset_launches()
        m.rhs(*uvw)
        assert launches()["rhs_fused"] == 1
        m.check_nondivergence(*uvw)
        assert launches()["rhs_fused"] == 2
        m.solve(*uvw, tol=1e-4)
        assert launches()["rhs_fused"] == 3


@pytest.mark.parametrize("bmask", [False, True])
def test_distributed_rhs_on_a_virtual_mesh(cuda, bmask):
    """On a virtual 2 x 2 mesh of the one card the distributed rhs (the
    kernel on each tile, with its shard_face_masks) equals the single-card
    rhs bit for bit, one launch a tile."""
    n = 32
    rmask = None
    if bmask:
        rmask = torch.ones((n, n), dtype=torch.float64)
        rmask[:5, :7] = 0.0
    models = []
    for mesh in (None, (2, 2)):
        m = NHModel(n, n, n, cfg=SolverConfig(dtype="float32", bmask=bmask),
                    device=cuda)
        c = setup_seamount(n, n, n)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=rmask, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        if mesh:
            m.distribute(*mesh, devices=[cuda] * 4, comm="shard_map")
        models.append(m)
    single, dist = models
    uvw = random_velocities(n, n, n, torch.float32, cuda, 17)
    reset_launches()
    b1 = single.rhs(*uvw)
    assert launches()["rhs_fused"] == 1
    b4 = dist.rhs(*uvw)
    assert launches()["rhs_fused"] == 5
    assert torch.equal(b4.to(b1.device), b1)
    assert float(dist.check_nondivergence(*uvw)) == float(b1.abs().max())
