"""The solver modes on the card: the kernels on a land-masked operator, the
direct coarsest solve replayed, and the order-exact GS solve.

Marked ``cuda``: every test skips without a CUDA device.  Run on a GPU
machine with

    python -m pytest --noconftest tests/test_torch_modes_cuda.py

- K4 (one sweep and three, on float32 and bfloat16 bands), K3 (its three
  modes, both operator layouts) and K1-K2 (every colour of both
  orderings, both layouts, the bfloat16 operator) on the level-0 operator
  of a masked seamount (land and ring columns have no horizontal
  coupling), each held to its plain version to 0 ulp;
- ``coarsest='direct'``: the replayed solve equals the eager solve bit for
  bit (history and pressure), the dense product captured with the step;
- ``gs_exact``: ``graph=True`` is refused, the default solve runs eagerly
  (no graph is captured) and equals the CPU solve to 1e-12 relative.
"""

import numpy as np
import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops import relax_compact as rc
from mgroms_tpu_torch.ops.kernels import launches, reset_launches
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt
from mgroms_tpu_torch.ops.kernels import sweep_fused as ksf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def land_mask(ny, nx):
    """A coastal strip (the western two columns) and a 4 x 4 island."""
    rmask = np.ones((ny, nx))
    rmask[:, :2] = 0.0
    rmask[ny // 2: ny // 2 + 4, nx // 2: nx // 2 + 4] = 0.0
    return rmask


def _model(device, n, dtype="float32", rmask=None, **cfg):
    nx, ny, nz = n
    m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype=dtype, **cfg),
                device=device)
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=rmask, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def _masked_inputs(cuda, dtype, layout, lp):
    n = (64, 32, 16)
    m = _model(cuda, n, "float32" if dtype == torch.float32 else "float64",
               rmask=land_mask(n[1], n[0]), bmask=True)
    cA = m.ops[0].cA
    pack = (rc.build_band_pack if layout == "bands"
            else rc.build_compact_pack)(cA, True)
    if lp:
        pack = rc.attach_lp(pack)
    g = torch.Generator(device=cuda).manual_seed(5)
    q = rc.split_quads(torch.randn(cA.shape[1:2] + (n[1], n[0]), generator=g,
                                   dtype=dtype, device=cuda))
    bq = rc.split_quads(torch.randn(cA.shape[1:2] + (n[1], n[0]),
                                    generator=g, dtype=dtype, device=cuda))
    return pack, q, bq


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for t in got:
        assert torch.equal(got[t], want[t]), t


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_sweep_matches_plain(cuda, dtype, lp):
    """K4 on the masked operator's band stack (bfloat16 with its
    consistent pivots when ``lp``), one sweep and three: 0 ulp."""
    pack, q, bq = _masked_inputs(cuda, dtype, "bands", lp)
    for ns in (1, 3):
        _equal(ksf.relax_fused_sweep(q, bq, pack, ns),
               ksf.relax_fused_sweep_plain(q, bq, pack, ns))


@pytest.mark.parametrize("layout", ["bands", "blocks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_rr_matches_plain(cuda, dtype, layout):
    """K3 on the masked operator in its coarse-RHS, residual and z-pair
    modes: 0 ulp."""
    pack, q, bq = _masked_inputs(cuda, dtype, layout, False)
    e = rc.extend_quads(q)
    e4 = tuple(e[k] for k in rc._TKEYS)
    for mode, targets in (("coarse", rc._TKEYS), ("residual", rc._TKEYS),
                          ("zsum", ((0, 0), (1, 1)))):
        got = kt.residual_restrict(e4, bq, pack, mode, targets)
        want = kt.residual_restrict_plain(e4, bq, pack, mode, targets)
        if isinstance(got, dict):
            _equal(got, want)
        else:
            assert torch.equal(got, want), mode


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("layout", ["bands", "blocks"])
def test_masked_colour_updates_match_plain(cuda, layout, lp):
    """K1 on every colour of both orderings and K2 on the RB colours on the
    masked float32 operator (K1 also on its bfloat16 copy): 0 ulp, the
    emitted raw residual too."""
    pack, q, bq = _masked_inputs(cuda, torch.float32, layout, lp)
    e = rc.extend_quads(q)
    for colour in rc.colour_targets("RB") + rc.colour_targets("FC"):
        _equal(kt.color_update(e, bq, pack, colour),
               kt.color_update_plain(e, bq, pack, colour))
        if len(colour) == 2 and not lp:
            got = kt.color_update_emit(e, bq, pack, colour)
            want = kt.color_update_emit_plain(e, bq, pack, colour)
            for g_, w_ in zip(got, want):
                _equal(g_, w_)


def test_direct_coarsest_replayed_equals_eager(cuda):
    """Seamount 32^3 float32 with coarsest='direct': the replayed solve
    (the coarsest level one product with the dense inverse, captured in
    the step) equals the eager solve bit for bit, history and pressure,
    with the same launches (K4 and K3 only)."""
    m = _model(cuda, (32, 32, 32), coarsest="direct")
    assert m.ops[-1].Ainv is not None and m.ops[-1].Ainv.is_cuda
    b = m.rhs(*initial_velocities(32, 32, 32, dtype=m.dtype, device=cuda))
    reset_launches()
    pe, ie = m.pressure_solve(b, tol=0.0, maxiter=4, graph=False)
    eager = launches()
    assert {k for k, n in eager.items() if n} == {
        "relax_fused_sweep", "residual_restrict", "residual_quads"}
    for rep in range(2):
        reset_launches()
        pg, ig = m.pressure_solve(b, tol=0.0, maxiter=4)
        assert len(m.backend.graphs) == 1
        assert ig.history == ie.history, (rep, ig.history, ie.history)
        assert torch.equal(pg, pe), rep
        assert launches() == eager, rep


def test_gs_exact_runs_eagerly_and_matches_the_cpu(cuda):
    """Seamount 8^3 float64, relax_method='GS' with gs_exact: graph=True
    raises, the default solve captures no graph, and its history and
    pressure equal the CPU solve's to 1e-12 relative."""
    n = (8, 8, 8)
    kw = dict(dtype="float64", relax_method="GS", gs_exact=True)
    m = _model(cuda, n, **kw)
    u, v, w = initial_velocities(*n, device=cuda)
    with pytest.raises(ValueError, match="gs_exact"):
        m.solve(u, v, w, tol=0.0, maxiter=2, graph=True)
    *_, p, info = m.solve(u, v, w, tol=0.0, maxiter=2)
    assert not m.backend.graphs
    mc = _model("cpu", n, **kw)
    *_, pc, infoc = mc.solve(*initial_velocities(*n, device="cpu"), tol=0.0,
                             maxiter=2)
    np.testing.assert_allclose(info.history, infoc.history, rtol=1e-12)
    np.testing.assert_allclose(p.cpu().numpy(), pc.numpy(), rtol=0,
                               atol=1e-12 * float(pc.abs().max()))
