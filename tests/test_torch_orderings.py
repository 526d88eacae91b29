"""The FC and GS smoother orderings (``relax_method``) through the whole
solve, against the JAX package's, on the CPU.

- the slice: seamount 16^3 in float64 with relax_method 'FC' and 'GS',
  the port's F-cycle history against JAX's at rel 1e-10, on the default
  config and with ``use_pallas=True`` (in float64 neither package routes
  to K6, whose plain version tests/test_torch_relax_fused.py holds to the
  JAX kernel);
- the routing in float32: FC smooths its quad levels with K1 in four
  colours of one target and restricts with K3, never K2 or K4; GS keeps
  every level in full layout; with ``use_pallas`` K6 gets the solve's
  ordering;
- the operator layout of the K1-K2 route: with the band stack on every
  quad level (the card's rule, solver.band_stack_wanted) the RB
  (pallas_fused_sweep=False), FC and perf-mode solves give the history
  they give on the gather blocks, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu_torch import NHModel, SolverConfig, solver
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops.kernels import relax_fused as kf
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt

torch.set_num_threads(1)

N = 16


def _port(**kw):
    m = NHModel(N, N, N, cfg=SolverConfig(**kw), device="cpu")
    c = setup_seamount(N, N, N)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind", ["FC", "GS"])
def test_history_matches_jax(kind, use_pallas):
    cfg = dict(relax_method=kind, use_pallas=use_pallas)
    c = setup_seamount(N, N, N)
    jm = JModel(N, N, N, cfg=JConfig(**cfg))
    jm.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    *_, jp, jinfo = jm.solve(*jvel(N, N, N, dtype=jnp.float64), tol=0.0,
                             maxiter=3)
    m = _port(**cfg)
    *_, p, info = m.solve(*initial_velocities(N, N, N, device="cpu"),
                          tol=0.0, maxiter=3)
    assert len(info.history) == len(jinfo.history) == 4
    # every cycle cuts the residual (a wrong ordering stalls or diverges)
    assert all(b < a for a, b in zip(info.history, info.history[1:]))
    # atol: the f64 round-off of a relative residual norm (both packages
    # sum in their own order; tests/test_torch_model.py holds RB so too)
    np.testing.assert_allclose(info.history, jinfo.history, rtol=1e-10,
                               atol=1e-15)
    jp = np.asarray(jp)
    np.testing.assert_allclose(p.numpy(), jp, rtol=0,
                               atol=1e-10 * np.abs(jp).max())


def _record(monkeypatch, mod, name):
    """The (shape, kind, nsweeps) of every call the backend makes to
    ``mod.name``."""
    calls = []
    wrapped = getattr(mod, name)

    def record(p, b, pack_or_cA, nsweeps, kind="RB", *args, **kw):
        shape = (tuple(p.shape) if isinstance(p, torch.Tensor)
                 else tuple(p[(0, 0)].shape))
        calls.append((shape, kind, nsweeps))
        return wrapped(p, b, pack_or_cA, nsweeps, kind, *args, **kw)

    monkeypatch.setattr(mod, name, record)
    return calls


def _counting(monkeypatch, mod, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        wrapped = getattr(mod, name)

        def count(*args, _w=wrapped, _n=name, **kw):
            counts[_n] += 1
            return _w(*args, **kw)

        monkeypatch.setattr(mod, name, count)
    return counts


def _one_fcycle(m):
    u, v, w = initial_velocities(N, N, N, dtype=m.dtype, device="cpu")
    m.pressure_solve(m.rhs(u, v, w), tol=0.0, maxiter=1)


def test_fc_routing(monkeypatch):
    """FC, f32 default config: the quad levels run the K1 orchestration
    in the FC ordering, four K1 launches a sweep; K3 restricts; no K2."""
    sweeps = _record(monkeypatch, kt, "relax_compact_tiled_quads")
    counts = _counting(monkeypatch, kt, ("color_update", "color_update_emit",
                                         "residual_restrict"))
    m = _port(dtype="float32", relax_method="FC")
    be = m.backend
    assert [be.state_quads(lev) for lev in range(be.nlevs)] == [
        True, True, False]
    assert not be.fused_sweep and not be.supports_fused_residual(0)
    _one_fcycle(m)
    assert {k for _, k, _ in sweeps} == {"FC"}
    assert (counts["color_update_emit"] == 0
            and counts["residual_restrict"] > 0)
    # every sweep is four single-target colour updates
    assert counts["color_update"] == 4 * sum(n for _, _, n in sweeps) > 0


@pytest.mark.parametrize("kind", ["FC", "GS"])
def test_use_pallas_runs_k6_in_the_solve_ordering(monkeypatch, kind):
    """f32 ``use_pallas``: K6 in the solve's ordering, on the coarsest
    level for FC (its quad levels keep K1), on every level for GS (no
    quad form)."""
    calls = _record(monkeypatch, kf, "fused_relax")
    m = _port(dtype="float32", relax_method=kind, use_pallas=True)
    _one_fcycle(m)
    assert {k for _, k, _ in calls} == {kind}
    shapes = {s for s, _, _ in calls}
    if kind == "FC":
        assert shapes == {(4, 4, 4)}
    else:
        assert shapes == {(4, 4, 4), (8, 8, 8), (16, 16, 16)}
        assert not any(m.backend.state_quads(lev)
                       for lev in range(m.backend.nlevs))


@pytest.mark.parametrize("route", ["RB", "FC", "perf"])
def test_band_packs_keep_the_k1_route_history(monkeypatch, route):
    """The K1-K2 route with every quad level holding the band stack only
    (the card's rule, forced here through solver.band_stack_wanted): RB
    with pallas_fused_sweep=False (K1, K2's emitted residual, K3), FC (K1
    a target a colour, K3) and perf mode with K4 off (K1 on the bfloat16
    stack) give, over 3 F-cycles, the history of the same solve on the
    gather blocks, bit for bit."""
    cfg = {"RB": dict(pallas_fused_sweep=False),
           "FC": dict(relax_method="FC"),
           "perf": dict(dtype="float32", fused_bands_bf16=True, ns_pre=1,
                        ns_post=1, pallas_fused_sweep=False)}[route]
    hist = []
    for bands in (False, True):
        monkeypatch.setattr(solver, "band_stack_wanted",
                            lambda cfg, on_card, b=bands: b)
        m = _port(**cfg)
        packs = [pk for pk in m.backend.packs if pk is not None]
        assert packs and not m.backend.fused_sweep
        for pk in packs:
            assert (pk.blocks is None) == bands
            assert (pk.ebands is not None) == bands
            if route == "perf":
                assert (pk.lp.ebands is not None) == bands
        *_, info = m.solve(*initial_velocities(N, N, N, dtype=m.dtype,
                                               device="cpu"),
                           tol=0.0, maxiter=3)
        hist.append(info.history)
    assert len(hist[0]) == 4 and hist[1] == hist[0]
