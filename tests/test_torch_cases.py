"""The port's rndtopo case and driver, analytic right-hand sides and
velocity utilities against the JAX package's, in float64 on the CPU
(within 1e-12 x max|JAX| unless stated):

- setup_rndtopo: shape, range [0, 0.2 Htot), the same depth for the same
  seed and another for another seed (its generator is torch's, not JAX's
  PRNG stream, so the solve is compared from JAX's depth);
- a rndtopo 16^3 solve from JAX's depth: the residual history;
- rhs_seamount; the random_patches sum from JAX's draws (the same
  jax.random.split as mgroms_tpu/cases/analytic_rhs.py:60-65); rhs_random
  and random_patches shapes and ranges; a pressure solve of the dipole
  (tests/test_diagnostics.py::test_analytic_rhs_solve, ported);
- velocities_from_interior and fill_velocity_halos equal JAX's exactly.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgroms_tpu.cases.analytic_rhs as jrhs
import mgroms_tpu.velocity as jvelo
from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.rndtopo import setup_rndtopo as jrndtopo
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu_torch import NHModel, SolverConfig, velocity
from mgroms_tpu_torch.cases import analytic_rhs, setup_rndtopo
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount

torch.set_num_threads(1)

N = 16


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_rndtopo_case():
    c = setup_rndtopo(24, 20, 8, Htot=3000.0, seed=3)
    assert c.h.shape == c.dx.shape == (20, 24)
    assert c.h.min() >= 0.0 and c.h.max() < 0.2 * 3000.0
    assert c.h.std() > 0.0
    assert np.all(c.dx == 1.0e4 / 24) and np.all(c.dy == 1.0e4 / 20)
    assert np.all(c.zeta == 0.0)
    assert (c.hc, c.theta_b, c.theta_s) == (4.0e3, 0.0, 0.0)
    assert np.array_equal(setup_rndtopo(24, 20, 8, Htot=3000.0, seed=3).h,
                          c.h)
    assert not np.array_equal(setup_rndtopo(24, 20, 8, Htot=3000.0,
                                            seed=4).h, c.h)


def test_rndtopo_solve_matches_jax():
    """The port's model on JAX's random depth: JAX's residual history."""
    jc = jrndtopo(N, N, N)
    j = JModel(N, N, N, cfg=JConfig())
    j.set_matrices(jc.dx, jc.dy, jc.zeta, jc.h, hc=jc.hc,
                   theta_b=jc.theta_b, theta_s=jc.theta_s)
    _, jinfo = j.pressure_solve(j.rhs(*jvel(N, N, N)), tol=1e-10,
                                maxiter=12)
    c = setup_rndtopo(N, N, N)._replace(h=np.asarray(jc.h))
    m = NHModel(N, N, N, device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    _, info = m.pressure_solve(
        m.rhs(*initial_velocities(N, N, N, device="cpu")), tol=1e-10,
        maxiter=12)
    assert info.niter == jinfo.niter and info.res <= 1e-10
    close(info.history, jinfo.history)


def test_rhs_seamount_matches_jax():
    close(analytic_rhs.rhs_seamount(24, 20, 12, device="cpu"),
          jrhs.rhs_seamount(24, 20, 12))
    close(analytic_rhs.rhs_seamount(16, 16, 8, Lx=3e3, Ly=5e3, Htot=1e3,
                                    device="cpu"),
          jrhs.rhs_seamount(16, 16, 8, Lx=3e3, Ly=5e3, Htot=1e3))


def test_patch_sum_from_jax_draws():
    nx, ny, nz, npatches, seed = 20, 16, 12, 30, 7
    kc, ka, kw = jax.random.split(jax.random.PRNGKey(seed), 3)
    centers = jax.random.uniform(kc, (npatches, 3), dtype=jnp.float64)
    amps = 2.0 * jax.random.uniform(ka, (npatches,), dtype=jnp.float64) - 1.0
    widths = jax.random.uniform(kw, (npatches,), dtype=jnp.float64,
                                minval=0.02, maxval=0.15)
    t = lambda a: torch.tensor(np.asarray(a))
    got = analytic_rhs.patch_sum(nx, ny, nz, t(centers), t(amps), t(widths))
    close(got, jrhs.random_patches(nx, ny, nz, npatches=npatches,
                                   seed=seed))


def test_random_generators():
    r = analytic_rhs.rhs_random(6, 5, 4, device="cpu")
    assert r.shape == (4, 5, 6) and r.dtype == torch.float64
    assert float(r.min()) >= -1.0 and float(r.max()) < 1.0
    assert torch.equal(r, analytic_rhs.rhs_random(6, 5, 4, device="cpu"))
    g = torch.Generator().manual_seed(1)
    assert not torch.equal(r, analytic_rhs.rhs_random(6, 5, 4, device="cpu",
                                                      generator=g))
    p = analytic_rhs.random_patches(6, 5, 4, npatches=5, device="cpu")
    assert p.shape == (4, 5, 6) and bool(torch.isfinite(p).all())
    # each blob's amplitude lies in [-1, 1)
    assert float(p.abs().max()) < 5.0


def test_analytic_rhs_solve():
    """Solver-only path with the dipole RHS (rhs_seamount,
    mg_define_rhs.f90:12-63)."""
    m = NHModel(N, N, N, cfg=SolverConfig(), device="cpu")
    c = setup_seamount(N, N, N)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    b = analytic_rhs.rhs_seamount(N, N, N, device="cpu")
    p, info = m.pressure_solve(b, tol=1e-9, maxiter=25)
    assert info.res <= 1e-9
    assert analytic_rhs.rhs_random(4, 4, 4, device="cpu").shape == (4, 4, 4)
    assert analytic_rhs.random_patches(4, 4, 4, npatches=5,
                                       device="cpu").shape == (4, 4, 4)


def test_generators_default_to_the_card():
    for fn in (analytic_rhs.rhs_seamount, analytic_rhs.rhs_random,
               analytic_rhs.random_patches):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("n", [(5, 4, 3), (8, 6, 2)])
def test_velocity_matches_jax(n):
    nx, ny, nz = n
    rng = np.random.default_rng(2)
    ui = rng.standard_normal((nz, ny, nx + 1))
    vi = rng.standard_normal((nz, ny + 1, nx))
    wi = rng.standard_normal((nz + 1, ny, nx))
    got = velocity.velocities_from_interior(
        *(torch.tensor(a) for a in (ui, vi, wi)))
    want = jvelo.velocities_from_interior(ui, vi, wi)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    u, v, w = (rng.standard_normal(x.shape)
               for x in jvel(nx, ny, nz))
    args = tuple(torch.tensor(a) for a in (u, v, w))
    got = velocity.fill_velocity_halos(*args)
    want = jvelo.fill_velocity_halos(*(jnp.asarray(a) for a in (u, v, w)))
    for g, w_, a, x in zip(got, want, args, (u, v, w)):
        assert np.array_equal(g.numpy(), np.asarray(w_))
        assert np.array_equal(a.numpy(), x)          # inputs untouched
    again = velocity.fill_velocity_halos(
        *velocity.velocities_from_interior(
            *(torch.tensor(a) for a in (ui, vi, wi))))
    for g, w in zip(again, velocity.velocities_from_interior(
            *(torch.tensor(a) for a in (ui, vi, wi)))):
        assert torch.equal(g, w)
