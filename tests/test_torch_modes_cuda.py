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
  (no graph is captured) and equals the CPU solve to 1e-12 relative;
- ``offload_metrics``: the metrics' bytes to pinned host memory, the
  device memory back but for umask and vmask (level 0's operator holds
  them), the next rhs bit for bit the one before;
- ``utils.tictoc.profile_fcycle(device_timer=True)`` at seamount 64^3:
  every level, device seconds beside the host's;
- ``scripts.profile_cuc.run`` and ``scripts.schedule_sweep.run`` at a
  small grid: their rows (four schedules);
- the GSPMD layer on a virtual 2x2 mesh of the card: K6 on the gathered
  sharded levels under ``use_pallas`` gives the single-device K6 solve's
  pressure bit for bit with the same launches, and at seamount 64^3 K4
  and K3 launch on the replicated levels exactly as the routing says.
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
from mgroms_tpu_torch.scripts import profile_cuc, schedule_sweep
from mgroms_tpu_torch.utils.tictoc import TicToc, profile_fcycle

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


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_offload_metrics_on_the_card(cuda):
    n = (64, 32, 16)
    m = _model(cuda, n)
    uvw = initial_velocities(*n, dtype=m.dtype, device=cuda)
    b = m.rhs(*uvw)
    torch.cuda.synchronize(cuda)
    held = torch.cuda.memory_allocated(cuda)
    moved = m.offload_metrics()
    assert moved == _nbytes(m.metrics)
    assert all(t.device.type == "cpu" and t.is_pinned() for t in m.metrics)
    freed = held - torch.cuda.memory_allocated(cuda)
    assert freed >= moved - _nbytes((m.metrics.umask, m.metrics.vmask))
    assert torch.equal(m.rhs(*uvw), b)
    assert all(t.is_cuda for t in m.metrics) and not m._metrics_offloaded


def test_profile_fcycle_device_timer(cuda):
    """Seamount 64^3: every level's relax, every level's prolong but the
    coarsest's, the eager pass's device seconds and host seconds beside
    the re-timed table, the same keys and counts."""
    n = (64, 64, 64)
    m = _model(cuda, n)
    b = m.rhs(*initial_velocities(*n, dtype=m.dtype, device=cuda))
    tt = profile_fcycle(m.backend, b, m.cfg, device_timer=True, iters=3,
                        tictoc=TicToc())
    L = m.backend.nlevs
    assert {k[0] for k in tt.table} == set(range(L))
    assert all((lev, "relax") in tt.table for lev in range(L))
    assert all((lev, "prolong") in tt.table for lev in range(L - 1))
    counts = lambda t: {k: c for k, (_, c) in t.items()}
    assert counts(tt.device) == counts(tt.table) == counts(tt.host)
    assert all(s > 0.0 for s, _ in tt.table.values())
    assert all(s > 0.0 for s, _ in tt.device.values())
    assert len(tt.report(tt.device).splitlines()) == 1 + L


def test_profile_cuc_small(cuda):
    row = profile_cuc.run(64, 64, 32, iters=2, device=cuda)
    assert row["config"]["coarsest"] == "direct"
    assert row["device_ms_sum"] > 0.0 and row["fcycle_ms_replay"] > 0.0
    assert {r["lev"] for r in row["rows"]} == set(range(row["levels"]))


def test_schedule_sweep_rows(cuda):
    rows = schedule_sweep.run(64, 64, 32, reps=2, device=cuda)
    assert [(r["ns_pre"], r["ns_post"]) for r in rows] == list(
        schedule_sweep.SCHEDULES)
    for r in rows:
        assert r["fcycle_ms"] > 0.0
        assert len(r["history"]) == schedule_sweep.CYCLES + 1
        assert r["history"][1] < r["history"][0]


def _gspmd(cuda, n, **cfg):
    m = _model(cuda, n, **cfg)
    m.distribute(2, 2, devices=[cuda] * 4, comm="gspmd")
    return m


def test_gspmd_gathered_k6_equals_single(cuda):
    """Seamount 64 x 64 x 32, ``use_pallas``, ``compact=False``: levels
    0-2 sharded, each relax K6 on the level gathered onto the card; the
    pressure equals the single-device eager K6 solve's bit for bit, the
    launches are the same (K6 only), the history within the float32
    norms' round-off (the tiles' partial sums)."""
    from mgroms_tpu_torch.parallel import DistributedBackend
    n = (64, 64, 32)
    cfg = dict(use_pallas=True, compact=False)
    out = []
    for m in (_model(cuda, n, **cfg), _gspmd(cuda, n, **cfg)):
        b = m.rhs(*initial_velocities(*n, dtype=m.dtype, device=cuda))
        reset_launches()
        p, info = m.pressure_solve(b, tol=0.0, maxiter=3, graph=False)
        out.append((p, info, launches()))
    (p1, i1, l1), (p2, i2, l2) = out
    assert type(m.backend) is DistributedBackend
    be = m.backend
    assert [s.sharded for s in be.plan.shards][:3] == [True] * 3
    assert all(be._gathered(lev) for lev in range(3))
    assert torch.equal(p2, p1)
    assert l2 == l1 and {k for k, v in l1.items() if v} <= {
        "fused_relax", "fused_relax_cluster", "fused_relax_step"}
    np.testing.assert_allclose(i2.history, i1.history, rtol=1e-6)


def test_gspmd_seamount_replicated_levels_launch_k4_k3(cuda):
    """Seamount 64^3, default config: levels 0-2 sharded (plain torch per
    tile), 3-4 replicated; level 3 smooths with K4 (ns_pre + ns_post
    launches in each of the 4 V-cycles that reach it) and restricts with
    K3 (once in each), nothing else launches."""
    n = (64, 64, 64)
    m = _gspmd(cuda, n)
    be = m.backend
    assert [s.sharded for s in be.plan.shards] == [True] * 3 + [False] * 2
    assert [be.state_quads(lev) for lev in range(5)] == [False] * 3 + [
        True, False]
    b = m.rhs(*initial_velocities(*n, dtype=m.dtype, device=cuda))
    reset_launches()
    _, info = m.pressure_solve(b, tol=0.0, maxiter=2)
    got = {k: v for k, v in launches().items() if v}
    ns = m.cfg.ns_pre + m.cfg.ns_post
    assert got == {"relax_fused_sweep": 4 * ns * info.niter,
                   "residual_restrict": 4 * info.niter}
    assert info.history[-1] < 1e-2 * info.history[0]
