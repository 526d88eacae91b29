"""The port's GSPMD comm layer (mgroms_tpu_torch/parallel/backend.py,
``NHModel.distribute(comm='gspmd')``) against the JAX package's, in
float64 on a mesh of CPU devices driven from one process (ports of the
gspmd cases of tests/test_distributed.py and tests/test_shardmap.py):

- solver.solve_p on a distributed backend of either layer takes the
  global b that ``NHModel.rhs`` gives and returns the global pressure;
  its device loop and host loop agree, and both JAX's distributed
  pressure to 1e-12 x max|p| (tests/test_distributed.py:188);
- seamount 16^3 on 2x2 and 32x16x8 on (4, 2), 4 F-cycles: JAX's
  ``comm='gspmd'`` pressure to 1e-12 x max|p| and history to rtol 1e-9
  (atol 1e-15, the residual's round-off);
  the end-to-end solve (rhs, solve, projection, check_nondivergence)
  against JAX's; the distributed rhs equal to the single-device one;
- against the port's single-device solve: a staged agglomeration
  (64x64x16 on (2, 4)), the RB, FC and GS orderings with
  ``compact=False``, and the ops run on the gathered level (K6 under
  ``use_pallas``, ``gs_exact``, the 'direct' coarsest product on a
  sharded coarsest level);
- ``comm='auto'`` builds the JAX package's backend class; the operators
  are held once per distinct device, next to shard_map's blocked tiles.
"""

import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
import mgroms_tpu.levels as jlev
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.parallel import MeshPlan as JMeshPlan
from mgroms_tpu.parallel import make_mesh as jmesh
from mgroms_tpu.parallel.shardmap_backend import default_comm as jdefault_comm
from mgroms_tpu_torch import NHModel, SolverConfig, solver
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops.kernels import relax_fused
from mgroms_tpu_torch.parallel import (DistributedBackend, ShardMapBackend,
                                       Tiles)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
CYCLES = 4


def _port(n, mesh=None, comm="gspmd", **cfg):
    nx, ny, nz = n
    c = setup_seamount(nx, ny, nz)
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**cfg), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    if mesh:
        m.distribute(*mesh, devices=CPU8, comm=comm)
    return m


def _port_solve(n, mesh=None, comm="gspmd", maxiter=CYCLES, **cfg):
    m = _port(n, mesh, comm, **cfg)
    u, v, w = initial_velocities(*n, device="cpu")
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=0.0, maxiter=maxiter)
    return m, p.numpy(), info


def _jax_model(n, mesh):
    nx, ny, nz = n
    c = setup_seamount(nx, ny, nz)
    j = JModel(nx, ny, nz, cfg=JConfig())
    j.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    j.distribute(*mesh, comm="gspmd")
    return j


def _history(info, want):
    """Histories to rtol 1e-9; atol 1e-15 (of ||b||) is the residual's
    round-off, which the last entries of 4 F-cycles (~1.5e-9) reach."""
    np.testing.assert_allclose(info.history, want.history, rtol=1e-9,
                               atol=1e-15)


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_16():
    """JAX's ``comm='gspmd'`` solve of seamount 16^3 on 2x2, 4 F-cycles."""
    j = _jax_model((16, 16, 16), (2, 2))
    p, info = j.pressure_solve(j.rhs(*jvel(16, 16, 16)), tol=0.0,
                               maxiter=CYCLES)
    return np.asarray(p), info


@pytest.fixture(scope="module")
def jax_4x2():
    """JAX's ``comm='gspmd'`` seamount 32x16x8 on (4, 2): the pressure of
    4 F-cycles, and the end-to-end solve of 4 F-cycles (corrected
    velocities, pressure, SolveInfo, max|div|)."""
    n = (32, 16, 8)
    j = _jax_model(n, (4, 2))
    u, v, w = jvel(*n)
    p, info = j.pressure_solve(j.rhs(u, v, w), tol=0.0, maxiter=CYCLES)
    uc, vc, wc, pe, ie = j.solve(u, v, w, tol=0.0, maxiter=CYCLES)
    div = float(j.check_nondivergence(uc, vc, wc))
    return dict(solve=(np.asarray(p), info),
                e2e=([np.asarray(x) for x in (uc, vc, wc, pe)], ie, div))


# ------------------------------------------------ solve_p at the mesh

@pytest.mark.parametrize("comm", ["gspmd", "shard_map"])
def test_solve_p_takes_and_gives_global_arrays(jax_16, comm):
    """solver.solve_p(m.backend, m.rhs(u, v, w)) on either layer
    (tests/test_distributed.py:188): the device loop and the host loop
    run the same cycles to the same history, and give the global
    pressure, JAX's distributed one to 1e-12 x max|p|."""
    n = (16, 16, 16)
    m = _port(n, (2, 2), comm)
    be = m.backend
    assert type(be) is (DistributedBackend if comm == "gspmd"
                        else ShardMapBackend)
    b = m.rhs(*initial_velocities(*n, device="cpu"))
    assert isinstance(b, torch.Tensor) and b.shape == (16, 16, 16)
    out = [solver.solve_p(be, b, m.cfg, tol=0.0, maxiter=CYCLES,
                          device_loop=dl) for dl in (False, True)]
    (p0, i0), (p1, i1) = out
    assert isinstance(p0, torch.Tensor) and p0.shape == (16, 16, 16)
    assert i0.niter == i1.niter == CYCLES
    np.testing.assert_allclose(i1.history, i0.history, rtol=1e-12)
    pj, ij = jax_16
    for p in (p0, p1):
        _close(p, pj)
    _history(i0, ij)


# ---------------------------------------------------- against JAX

@pytest.mark.parametrize("case", ["16^3 on 2x2", "32x16x8 on (4, 2)"])
def test_gspmd_solve_matches_jax(jax_16, jax_4x2, case):
    if case == "16^3 on 2x2":
        n, mesh, (pj, ij) = (16, 16, 16), (2, 2), jax_16
    else:
        n, mesh, (pj, ij) = (32, 16, 8), (4, 2), jax_4x2["solve"]
    m, p, info = _port_solve(n, mesh)
    assert type(m.backend) is DistributedBackend
    assert info.niter == ij.niter == CYCLES
    _close(p, pj)
    _history(info, ij)


def test_gspmd_end_to_end_solve_matches_jax(jax_4x2):
    """rhs -> solve -> projection on (4, 2), then check_nondivergence
    (tests/test_distributed.py:132's gspmd case)."""
    n = (32, 16, 8)
    m = _port(n, (4, 2))
    u, v, w = initial_velocities(*n, device="cpu")
    uc, vc, wc, p, info = m.solve(u, v, w, tol=0.0, maxiter=CYCLES)
    div = float(m.check_nondivergence(uc, vc, wc))
    want, ij, dj = jax_4x2["e2e"]
    assert info.niter == ij.niter == CYCLES
    _history(info, ij)
    for got, w_ in zip((uc, vc, wc, p), want):
        _close(got, w_)
    assert abs(div - dj) <= 1e-9 * max(dj, 1.0)


def test_gspmd_rhs_equals_single_exactly():
    n = (32, 16, 8)
    rng = np.random.default_rng(11)
    uvw = [x + torch.tensor(rng.standard_normal(x.shape))
           for x in initial_velocities(*n, device="cpu")]
    b1 = _port(n).rhs(*uvw)
    m = _port(n, (4, 2))
    assert type(m.backend) is DistributedBackend
    assert torch.equal(m.rhs(*uvw), b1)


# ------------------------------------ against the single-device port

def _against_single(n, mesh, maxiter, hist_rtol=1e-12, **cfg):
    """The GSPMD solve and the single-device one of the same case: the
    pressure to 1e-12 x max|p| (the ops are the same; only the norms sum
    in another order) and the history to ``hist_rtol``.  Returns the
    distributed model."""
    _, p1, i1 = _port_solve(n, maxiter=maxiter, **cfg)
    m, p2, i2 = _port_solve(n, mesh, maxiter=maxiter, **cfg)
    assert i2.niter == i1.niter == maxiter
    _close(p2, p1)
    np.testing.assert_allclose(i2.history, i1.history, rtol=hist_rtol)
    return m


def test_staged_agglomeration_matches_single():
    """64x64x16 on (2, 4) stages both axes -> both -> one -> replicated
    (tests/test_distributed.py:80's gspmd case); one F-cycle."""
    m = _against_single((64, 64, 16), (2, 4), 1)
    flags = [(s.shard_py, s.shard_px) for s in m.backend.plan.shards]
    assert flags[0] == (True, True)
    assert flags[2] in ((False, True), (True, False))
    assert not m.backend.plan.shards[3].sharded


@pytest.mark.parametrize("kind", ["RB", "FC", "GS"])
def test_orderings_full_layout_match_single(kind):
    m = _against_single((16, 16, 16), (2, 2), 2, relax_method=kind,
                        compact=False)
    be = m.backend
    assert be._sharded(0) and not any(be.state_quads(lev)
                                      for lev in range(be.nlevs))


@pytest.mark.parametrize("route", ["use_pallas", "gs_exact", "direct"])
def test_gathered_ops_match_single(monkeypatch, route):
    """The ops no tile runs alone, on sharded levels (8^3 on 2x2 with
    nsmall 2: every level sharded): each call gets the whole level.  K6
    routes float32 only (as JAX's ``_use_pallas``): its history to the
    float32 norms' round-off."""
    cfg = dict(use_pallas=dict(use_pallas=True, compact=False,
                               dtype="float32"),
               gs_exact=dict(relax_method="GS", gs_exact=True),
               direct=dict(coarsest="direct"))[route]
    shapes = []
    if route == "use_pallas":
        k6 = relax_fused.fused_relax
        monkeypatch.setattr(relax_fused, "fused_relax", lambda p, *a: (
            shapes.append(tuple(p.shape)), k6(p, *a))[1])
    m = _against_single((8, 8, 8), (2, 2), 1, nsmall=2,
                        hist_rtol=1e-6 if route == "use_pallas" else 1e-12,
                        **cfg)
    be = m.backend
    assert all(s.sharded for s in be.plan.shards)
    gathered = [lev for lev in range(be.nlevs) if be._gathered(lev)]
    assert gathered == ([be.nlevs - 1] if route == "direct"
                        else list(range(be.nlevs)))
    if route == "use_pallas":
        full = {(s.nzg, s.nyg, s.nxg) for s in m.levels}
        assert shapes and set(shapes) == full


# ------------------------------------------------ backends and storage

@pytest.mark.parametrize("cfg,want", [
    (dict(), ShardMapBackend),
    (dict(compact=False), DistributedBackend),
    (dict(relax_method="GS"), DistributedBackend)])
def test_auto_builds_the_jax_backend_class(cfg, want):
    """tests/test_shardmap.py:185: shard_map wherever a sharded level
    smooths in quad form, else GSPMD; the class JAX's ``default_comm``
    names on the CPU."""
    m = _port((32, 16, 8), (4, 2), comm="auto", **cfg)
    assert type(m.backend) is want
    levels = jlev.build_level_plan(32, 16, 8)
    comm = jdefault_comm(levels, JMeshPlan.create(jmesh(4, 2), levels),
                         JConfig(**cfg), "cpu")
    assert {"gspmd": DistributedBackend,
            "shard_map": ShardMapBackend}[comm] is want


def test_operators_replicated_once_per_device():
    """GSPMD holds every level's global operator, ``Ainv`` included, once
    per distinct device (one copy on a mesh of the CPU repeated: the
    single-device tensors themselves), each tile reading a window of it;
    shard_map holds per-tile blocked tiles (tests/test_shardmap.py:80)."""
    n = (32, 16, 8)
    m = _port(n, coarsest="direct")
    ops = [op.cA for op in m.ops]
    m.distribute(4, 2, devices=CPU8, comm="gspmd")
    be = m.backend
    for lev, rep in enumerate(be.replicas):
        assert list(rep.copies) == [torch.device("cpu")]
        assert rep.first is be.ops[lev]
        assert be.ops[lev].cA is ops[lev]
    assert be.ops[-1].Ainv is not None
    win = be._tile_cA(0)
    assert win.shape == (2, 4)
    assert all(t.shape == (8, 8, 10, 10)
               and t.untyped_storage().data_ptr()
               == ops[0].untyped_storage().data_ptr() for t in win.flat())
    sm = _port(n, (4, 2), comm="shard_map")
    assert isinstance(sm.backend.ops[0].cA, Tiles)
    assert {t.shape for t in sm.backend.ops[0].cA.flat()} == {(8, 8, 10, 10)}
    assert sm.backend.replicas == [None] * sm.backend.nlevs
