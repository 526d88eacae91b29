"""The port's NHModel end to end, in float64 on the CPU.

- seamount 32^3 reproduces the golden history (as tests/test_goldens.py);
- seamount 16^3: solve p, u, v, w match the JAX NHModel.solve;
- check_nondivergence agrees with the JAX package's on the same velocities;
- a solve on JAX-assembled operators and packs, carried over by
  mgroms_tpu_torch.convert, gives the JAX history.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.convert import operators_from_numpy, pack_from_numpy
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
N = 16
TOL, MAXITER = 1e-11, 12


def _port(n, cfg=None):
    m = NHModel(n, n, n, cfg=cfg or SolverConfig(), device="cpu")
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


@pytest.fixture(scope="module")
def jax_run():
    """One JAX seamount 16^3 solve on the port's numpy case inputs."""
    c = setup_seamount(N, N, N)
    m = JModel(N, N, N, cfg=JConfig())
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = jvel(N, N, N)
    uc, vc, wc, p, info = m.solve(u, v, w, tol=TOL, maxiter=MAXITER)
    return dict(model=m, uvw=tuple(np.asarray(x) for x in (uc, vc, wc)),
                p=np.asarray(p), info=info,
                div=float(m.check_nondivergence(uc, vc, wc)),
                div0=float(np.abs(np.asarray(m.rhs(u, v, w))).max()))


def test_entry_points_default_to_the_card():
    """NHModel, initial_velocities, the converters of JAX state and
    refine.build_pair run on the card unless the caller asks for the CPU (checked on the
    signatures: nothing is built)."""
    import inspect
    from mgroms_tpu_torch.convert import packed_operator_from_numpy
    from mgroms_tpu_torch.convert import (pack_tiles_from_numpy,
                                          tiles_from_numpy)
    from mgroms_tpu_torch.parallel import make_mesh
    from mgroms_tpu_torch.refine import build_pair
    for fn in (NHModel.__init__, initial_velocities, operators_from_numpy,
               pack_from_numpy, packed_operator_from_numpy, tiles_from_numpy,
               pack_tiles_from_numpy, build_pair):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # the mesh takes the visible CUDA devices by default and never falls
    # back to the CPU: here, with no card, it raises
    assert inspect.signature(NHModel.distribute).parameters[
        "devices"].default is None
    assert inspect.signature(make_mesh).parameters["devices"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            make_mesh(2, 2)
        m = _port(16)
        with pytest.raises(ValueError, match="need 4 devices, have 0"):
            m.distribute(2, 2)
        # with four cards visible the default mesh is theirs (no tensor is
        # made, so no card is needed to build it)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "device_count", lambda: 4)
            mesh = make_mesh(2, 2)
        assert mesh.devices == ((torch.device("cuda", 0),
                                 torch.device("cuda", 1)),
                                (torch.device("cuda", 2),
                                 torch.device("cuda", 3)))
        assert mesh.on_card


def test_seamount32_history_matches_golden():
    with open(os.path.join(GOLDEN_DIR, "seamount32_history.json")) as f:
        gold = json.load(f)
    nx, ny, nz = gold["grid"]
    m = _port(nx)
    u, v, w = initial_velocities(nx, ny, nz, device="cpu")
    kt.reset_launches()
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=1e-12, maxiter=30)
    assert info.niter == gold["niter"]
    np.testing.assert_allclose(np.array(info.history),
                               np.array(gold["history"]),
                               rtol=1e-6, atol=1e-15)
    # CPU tensors take the plain versions, never a kernel
    assert all(v == 0 for v in kt.LAUNCHES.values())


def test_solve_matches_jax(jax_run):
    m = _port(N)
    u, v, w = initial_velocities(N, N, N, device="cpu")
    uc, vc, wc, p, info = m.solve(u, v, w, tol=TOL, maxiter=MAXITER)
    assert info.niter == jax_run["info"].niter
    np.testing.assert_allclose(np.array(info.history),
                               np.array(jax_run["info"].history),
                               rtol=1e-6, atol=1e-15)
    for got, want in zip((p, uc, vc, wc), (jax_run["p"],) + jax_run["uvw"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


def test_check_nondivergence_matches_jax(jax_run):
    m = _port(N)
    div = float(m.check_nondivergence(*jax_run["uvw"]))
    assert abs(div - jax_run["div"]) <= 1e-9 * jax_run["div0"]
    assert div < 1e-2 * jax_run["div0"]


def test_solve_on_jax_assembled_operators(jax_run):
    jm = jax_run["model"]
    levels = jm.levels
    ops, metrics = operators_from_numpy(
        levels, [np.asarray(o.cA) for o in jm.ops],
        {f: np.asarray(x) for f, x in jm.metrics._asdict().items()},
        device="cpu")
    jpacks = jm.backend.packs
    packs = [None if pk is None or lev == len(levels) - 1 else
             pack_from_numpy({f: [np.asarray(x) for x in getattr(pk, f)]
                              for f in ("blocks", "d", "ud", "bet",
                                        "rblocks")}, pk.real_matrix,
                             device="cpu")
             for lev, pk in enumerate(jpacks)]
    assert any(pk is not None for pk in packs)
    m = NHModel(N, N, N, cfg=SolverConfig(), device="cpu")
    m.use_operators(ops, metrics, packs=packs)
    u, v, w = initial_velocities(N, N, N, device="cpu")
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=TOL, maxiter=MAXITER)
    assert info.niter == jax_run["info"].niter
    np.testing.assert_allclose(np.array(info.history),
                               np.array(jax_run["info"].history),
                               rtol=1e-6, atol=1e-15)
    np.testing.assert_allclose(p.numpy(), jax_run["p"], rtol=0,
                               atol=1e-10 * np.abs(jax_run["p"]).max())


def test_driver_prints_the_jax_summary_lines(jax_run, tmp_path, capsys):
    """drivers.seamount prints the JAX driver's summary lines (same
    formats) and writes the same residual-history file."""
    from mgroms_tpu_torch.drivers import seamount
    hist = tmp_path / "hist.txt"
    seamount.main(["--nx", str(N), "--ny", str(N), "--nz", str(N),
                   "--device", "cpu", "--tol", str(TOL), "--maxiter",
                   str(MAXITER), "--history", str(hist),
                   "--namelist", str(tmp_path / "absent")])
    out = capsys.readouterr().out
    for pat in (r"time spent to solve : +[0-9.]+ s",
                r"rescaled performance: +[0-9.e+-]+",
                r"max \|div\| after correction: [0-9.e+-]+ "
                r"\(initial [0-9.e+-]+\)"):
        assert re.search(pat, out), pat
    rows = [line.split() for line in hist.read_text().splitlines()]
    assert [int(i) for _, i in rows] == list(range(len(rows)))
    np.testing.assert_allclose([float(r) for r, _ in rows],
                               jax_run["info"].history, rtol=1e-6,
                               atol=1e-15)


def test_cuc_driver_reads_no_grid_file_unless_given(tmp_path, monkeypatch,
                                                    capsys):
    """drivers.cuc takes the synthetic slope by default, even when a grid
    file sits at the reference's relative path ../DATA/cuc_nhgrd.nc."""
    from mgroms_tpu_torch.drivers import cuc
    (tmp_path / "DATA").mkdir()
    (tmp_path / "DATA" / "cuc_nhgrd.nc").write_text("not a grid file")
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")

    def no_load(*a, **k):
        raise AssertionError("load_cuc called without --data")

    monkeypatch.setattr(cuc, "load_cuc", no_load)
    m, info = cuc.main(["--nx", "32", "--ny", "32", "--nz", "8", "--device",
                        "cpu", "--maxiter", "2", "--namelist", "absent"])
    assert "synthetic continental-slope" in capsys.readouterr().out
    assert m.nx == 32 and np.isfinite(info.history).all()
