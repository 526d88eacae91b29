"""NHModel.offload_metrics and the entry points that build on it, on the
CPU:

- after offload_metrics, rhs / project / check_nondivergence equal their
  results before it bit for bit, the flag clears, and no graph, cache or
  closure keeps the device tensors (only umask and vmask, which level
  0's operator shares, stay alive);
- distribute after offload_metrics: the distributed rhs equals the
  undistributed one (a virtual mesh of the CPU, as tests/
  test_torch_parallel.py's);
- scripts/solve_wall.py's and scripts/profile_cuc.py's set-up is the JAX
  scripts' (coarsest='direct', the metrics offloaded);
- drivers.rndtopo on a 2 x 2 mesh of the CPU, under both comm layers:
  the history of the undistributed run within 1e-12; its --profile
  table.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.scripts import profile_cuc, schedule_sweep, solve_wall

torch.set_num_threads(1)


def _model(nx=32, ny=16, nz=8, **cfg):
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**cfg), device="cpu")
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    return m


def _uvw(nx=32, ny=16, nz=8, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(x + torch.tensor(rng.standard_normal(x.shape))
                 for x in initial_velocities(nx, ny, nz, device="cpu"))


def test_offload_round_trip_bit_for_bit():
    m = _model()
    u, v, w = _uvw()
    p = torch.tensor(np.random.default_rng(4).standard_normal((8, 16, 32)))
    before = (m.rhs(u, v, w), m.project(p, u, v, w),
              m.check_nondivergence(u, v, w))
    live = m.metrics
    refs = {name: weakref.ref(t) for name, t in zip(live._fields, live)}
    n = m.offload_metrics()
    assert n == sum(t.numel() * t.element_size() for t in live)
    assert m._metrics_offloaded
    del live
    gc.collect()
    # level 0's operator holds umask and vmask itself
    assert sorted(k for k, r in refs.items() if r() is not None) == [
        "umask", "vmask"]
    assert torch.equal(m.rhs(u, v, w), before[0])
    assert not m._metrics_offloaded
    for fn, want in ((lambda: m.project(p, u, v, w), before[1]),
                     (lambda: m.check_nondivergence(u, v, w), before[2])):
        m.offload_metrics()
        got = fn()
        assert not m._metrics_offloaded
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w_)
    # a solve does not read the metrics: they stay where they are
    m.offload_metrics()
    m.pressure_solve(before[0], tol=1e-6, maxiter=2)
    assert m._metrics_offloaded


def test_distribute_after_offload():
    nx, ny, nz = 32, 16, 8
    u, v, w = _uvw()
    single = _model().rhs(u, v, w)
    m = _model()
    m.offload_metrics()
    m.distribute(2, 2, devices=["cpu"] * 4, comm="shard_map")
    assert not m._metrics_offloaded
    got = m.rhs(u, v, w)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0,
                               atol=1e-12 * float(single.abs().max()))
    assert got.shape == (nz, ny, nx)


@pytest.mark.parametrize("script", [solve_wall, profile_cuc])
def test_timed_scripts_take_the_jax_configuration(script):
    """The JAX scripts' set-up (scripts/solve_wall.py:41-49,
    scripts/profile_cuc.py:54-59): coarsest='direct', float32, the
    metrics offloaded after the right-hand side."""
    if script is solve_wall:
        m, b, n = solve_wall.build(32, 32, 16, device="cpu")
        assert b.shape == (16, 32, 32) and bool(torch.isfinite(b).all())
        assert n == sum(t.numel() * t.element_size() for t in m.metrics)
    else:
        m = profile_cuc.build(32, 32, 16, device="cpu")
    assert m.cfg.coarsest == "direct" and m.cfg.dtype == "float32"
    assert m._metrics_offloaded
    assert m.ops[-1].Ainv is not None
    assert solve_wall.CONFIG == SolverConfig(dtype="float32",
                                             coarsest="direct")
    assert schedule_sweep.build is solve_wall.build


def test_rndtopo_driver_on_a_mesh(monkeypatch, tmp_path):
    """drivers.rndtopo on the CPU repeated 2 x 2 against the same case
    undistributed, under comm 'auto' (shard_map here) and 'gspmd': the
    same cycles, the history within 1e-12."""
    from mgroms_tpu_torch.drivers import rndtopo
    from mgroms_tpu_torch.parallel.shardmap_backend import ShardMapBackend
    monkeypatch.chdir(tmp_path)
    argv = ["--nx", "16", "--ny", "16", "--nz", "8", "--device", "cpu",
            "--tol", "1e-10", "--maxiter", "8"]
    m1, i1 = rndtopo.main(argv)
    m4, i4 = rndtopo.main(argv + ["--npx", "2", "--npy", "2"])
    assert isinstance(m4.backend, ShardMapBackend)
    assert not isinstance(m1.backend, ShardMapBackend)
    assert i4.niter == i1.niter and i1.res <= 1e-10
    np.testing.assert_allclose(i4.history, i1.history, rtol=1e-12,
                               atol=1e-12 * i1.history[0])
    from mgroms_tpu_torch.parallel import DistributedBackend
    mg, ig = rndtopo.main(argv + ["--npx", "2", "--npy", "2", "--comm",
                                  "gspmd"])
    assert type(mg.backend) is DistributedBackend
    assert ig.niter == i1.niter
    np.testing.assert_allclose(ig.history, i1.history, rtol=1e-12,
                               atol=1e-12 * i1.history[0])


def test_profile_on_a_mesh(monkeypatch, tmp_path, capsys):
    """--profile on a distributed model: the per-level table through the
    shard_map backend's ops (tiles as arguments)."""
    from mgroms_tpu_torch.drivers import rndtopo
    from mgroms_tpu_torch.utils import tictoc
    monkeypatch.chdir(tmp_path)
    tictoc.reset_tictoc()
    m, _ = rndtopo.main(["--nx", "16", "--ny", "16", "--nz", "8",
                         "--device", "cpu", "--tol", "1e-8", "--maxiter",
                         "2", "--npx", "2", "--npy", "2", "--profile"])
    table = tictoc._GLOBAL.table
    assert {k[0] for k in table} == set(range(len(m.levels)))
    assert table[(0, "relax")][1] >= 1 and table[(0, "to_state")][1] == 2
    out = capsys.readouterr().out
    assert len([line for line in out.splitlines()
                if line.strip()[:1].isdigit() and "s/" in line]) == len(
                    m.levels)
    tictoc.reset_tictoc()
