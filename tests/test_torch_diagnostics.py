"""Diagnostics == JAX in float64, on the CPU: the ``netcdf_output`` stage
dumps (io/diagnostics.py, model.py, solver.solve_p) against the JAX
package's dumps file for file, ``write_field`` / ``read_field``, the
solver diagnostics ``vcycle2``, ``dot`` and ``testgalerkin``, and the
order-exact GS solve (``gs_exact``, the reference-order parity mode; its
sweep: tests/test_torch_solver_modes.py).

Tolerance 1e-12 x max|JAX| unless a test says otherwise; iterates of a
solve 1e-10 x max, as the port's other solve tests.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.io.diagnostics import read_field as jread
import mgroms_tpu.solver as jsolver
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch import solver
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.io.diagnostics import read_field, write_field

torch.set_num_threads(1)

N = 16


def close(got, want, tol=1e-12):
    want = np.asarray(want, dtype=np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _models(n=(N, N, N), jdir=None, tdir=None, **kw):
    nx, ny, nz = n
    c = setup_seamount(nx, ny, nz)
    jkw = dict(kw, output_dir=str(jdir)) if jdir else kw
    tkw = dict(kw, output_dir=str(tdir)) if tdir else kw
    jm = JModel(nx, ny, nz, cfg=JConfig(**jkw))
    jm.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                    theta_s=c.theta_s)
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**tkw), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    return jm, m


def _histories(jm, m, maxiter, n=(N, N, N)):
    nx, ny, nz = n
    *_, jp, jinfo = jm.solve(*jvel(nx, ny, nz, dtype=jnp.float64), tol=0.0,
                             maxiter=maxiter)
    *_, p, info = m.solve(*initial_velocities(nx, ny, nz, device="cpu"),
                          tol=0.0, maxiter=maxiter)
    assert len(info.history) == len(jinfo.history) == maxiter + 1
    assert all(b < a for a, b in zip(info.history, info.history[1:]))
    np.testing.assert_allclose(info.history, jinfo.history, rtol=1e-10,
                               atol=1e-15)
    close(p, jp, 1e-10)
    return info


def test_gs_exact_solve_matches_jax_and_runs_eagerly():
    """Seamount 8^3, relax_method='GS' with gs_exact: history against
    JAX's; such a solve never replays a graph (graph=True refused, the
    default eager, on a backend that is on the card or not)."""
    n = (8, 8, 8)
    jm, m = _models(n, relax_method="GS", gs_exact=True)
    info = _histories(jm, m, 2, n)
    assert info.history[-1] < 1e-3 * info.history[0]
    levels = m.levels
    be = solver.SingleDeviceBackend(levels, [None] * len(levels), m.cfg,
                                    packs=[None] * len(levels), on_card=True)
    assert solver.graph_wanted(be, None) is False
    assert solver.graph_wanted(be, False) is False
    with pytest.raises(ValueError, match="gs_exact"):
        solver.graph_wanted(be, True)
    plain = solver.SingleDeviceBackend(levels, [None] * len(levels),
                                       SolverConfig(relax_method="GS"),
                                       packs=[None] * len(levels),
                                       on_card=True)
    assert solver.graph_wanted(plain, None) is True


def test_netcdf_output_dumps_match_jax(tmp_path):
    """netcdf_output at seamount 8^3 in both packages, each into its own
    directory: the same file set (tests/test_diagnostics.py::
    test_netcdf_output_stage_dumps's files among them), every set-up dump
    (dx, dy, zr, zw, one cA per level) and the RHS to 1e-12 x max, the
    per-iteration and end-of-solve p and r and the divergence to 1e-10 x
    max; p_end equals the returned pressure."""
    n = 8
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jm, m = _models((n, n, n), jdir, tdir, netcdf_output=True)
    *juvw, jp, jinfo = jm.solve(*jvel(n, n, n, dtype=jnp.float64), tol=1e-8,
                                maxiter=10)
    uc, vc, wc, p, info = m.solve(*initial_velocities(n, n, n, device="cpu"),
                                  tol=1e-8, maxiter=10)
    assert info.niter == jinfo.niter
    jm.check_nondivergence(*juvw)
    m.check_nondivergence(uc, vc, wc)
    files = sorted(os.listdir(tdir))
    assert files == sorted(os.listdir(jdir))
    want = ["dx_dx_0000_0001.nc", "dy_dy_0000_0001.nc", "zr_zr_0000_0001.nc",
            "zw_zw_0000_0001.nc", "b_b_0000_0001.nc", "p_end_p_0000.nc",
            "r_end_r_0000.nc", "p_p_0000_0001.nc",
            "check_b_0000_0001.nc"] + [
        f"cA_ca_0000_{lev:04d}.nc" for lev in range(1, len(m.levels) + 1)]
    assert set(want) <= set(files)
    assert len([f for f in files if f.startswith("p_p_")]) == info.niter
    bscale = np.abs(jread(str(jdir / "b_b_0000_0001.nc"), "b")).max()
    for f in files:
        vname = f.split("_")[1] if not f.startswith(("p_end", "r_end")) \
            else f.split("_")[2]
        got, ref = read_field(str(tdir / f), vname), jread(str(jdir / f),
                                                           vname)
        assert got.dtype.kind == "f" and got.dtype.itemsize == 8
        assert got.shape == ref.shape
        if vname in ("r", "b") and f[0] in "rc":
            # residuals and the divergence fall to round-off: held on the
            # scale of b (the history's relative residual is ||r||/||b||)
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-12 * bscale)
            continue
        setup = f.split("_")[0] in ("dx", "dy", "zr", "zw", "cA", "b")
        close(got, ref, 1e-12 if setup else 1e-10)
    np.testing.assert_array_equal(read_field(str(tdir / "p_end_p_0000.nc"),
                                             "p"), p.numpy())


def test_write_field_takes_tensors(tmp_path):
    """A float32 tensor and a float64 array round-trip through the netCDF
    file with the reference's naming, the tensor copied to the host."""
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    path = write_field(x, "q", str(tmp_path / "q.nc"), rank=0, iteration=3)
    assert path.endswith("q_q_0000_0003.nc")
    got = read_field(path, "q")
    assert got.dtype.kind == "f" and got.dtype.itemsize == 4
    np.testing.assert_array_equal(got, x.numpy())
    y = np.random.default_rng(0).standard_normal((5, 6))
    path = write_field(y, "y", str(tmp_path / "y"))
    assert path.endswith("y_y.nc")
    np.testing.assert_array_equal(read_field(path, "y"), y)


def test_vcycle2_dot_and_testgalerkin_match_jax():
    """vcycle2 from level 0 to level 1 on the seamount 16^3 RHS (every
    level in full layout, as the JAX function keeps them) against JAX's
    at 1e-10 x max (the port's full-layout relax and JAX's compact relax
    round in their own orders); dot; testgalerkin's smooth field on level
    1 against JAX's, ratio in (3, 5); the random field (a torch.Generator
    seeded by ``seed``) within the JAX test's band."""
    jm, m = _models()
    jb = jm.rhs(*jvel(N, N, N, dtype=jnp.float64))
    b = m.rhs(*initial_velocities(N, N, N, device="cpu"))
    close(b, jb)
    L = m.backend.nlevs
    jbe, be = jm.backend, m.backend
    jps = [jbe.zeros(lev) for lev in range(L)]
    jbs = [jb] + [None] * (L - 1)
    jps = jax.jit(lambda be_, ps, bs: jsolver.vcycle2(be_, ps, bs, 0, 1,
                                                      jm.cfg))(jbe, jps, jbs)
    ps = [be.zeros(lev) for lev in range(L)]
    bs = [b] + [None] * (L - 1)
    ps = solver.vcycle2(be, ps, bs, 0, 1, m.cfg)
    close(ps[0], jps[0], 1e-10)
    close(ps[1], jps[1], 1e-10)
    r0 = float(torch.linalg.norm(be.residual(0, be.zeros(0), b)))
    r1 = float(torch.linalg.norm(be.residual(0, ps[0], b)))
    assert r1 < 0.1 * r0
    x = t(np.random.default_rng(1).standard_normal((N, N, N)))
    assert float(solver.dot(be, 0, x, x)) == pytest.approx(
        float(jsolver.dot(jbe, 0, jnp.asarray(x.numpy()),
                          jnp.asarray(x.numpy()))), rel=1e-13)
    got = solver.testgalerkin(be, 1, m.cfg)
    want = jsolver.testgalerkin(jbe, 1, jm.cfg)
    np.testing.assert_allclose(got, want, rtol=1e-12)



def test_galerkin_ratio_bands():
    """tests/test_diagnostics.py's bands at its size (seamount 32^3, level
    1), on the port alone: the smooth field's ratio in (3, 5), the random
    field's (a torch.Generator seeded by ``seed``) in (4, 30), the same
    for the same seed."""
    n = 32
    c = setup_seamount(n, n, n)
    m = NHModel(n, n, n, device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    _, _, ratio = solver.testgalerkin(m.backend, 1, m.cfg)
    assert 3.0 < ratio < 5.0, ratio
    _, _, ratio_r = solver.testgalerkin(m.backend, 1, m.cfg, seed=3,
                                        field="random")
    assert 4.0 < ratio_r < 30.0, ratio_r
    assert solver.testgalerkin(m.backend, 1, m.cfg, seed=3,
                               field="random")[2] == ratio_r
