"""The solver modes off the default path == JAX in float64, on the CPU:
``coarsest='direct'`` (dense_inverse), ``tridiag='pcr'``, the order-exact
GS sweep (``gs_exact``), the aggressive 8:1 z-transfers and the 2-D
transfer forms, and the legacy 'sigma' s-coordinate (the order-exact GS
solve and the diagnostics ``vcycle2``, ``dot`` and ``testgalerkin``:
tests/test_torch_diagnostics.py).

Inputs are numpy arrays from a seed, or the seamount case.  Tolerance
1e-12 x max|JAX| unless a test says otherwise; solve histories at rel
1e-10 over the float64 floor (atol 1e-15), as the port's other history
tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.bc import extend_h1 as jext
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.grids import setup_zr_zw_croco as jzrzw
from mgroms_tpu.levels import build_level_plan
import mgroms_tpu.ops.relax as jrelax
import mgroms_tpu.ops.transfer as jtransfer
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch import solver
from mgroms_tpu_torch.bc import extend_h1
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.convert import operators_from_numpy
from mgroms_tpu_torch.grids import setup_zr_zw_croco
from mgroms_tpu_torch.ops import relax, stencil, transfer
from mgroms_tpu_torch.ops.relax_compact import QuadField
from test_gs_exact import _np_gs_sweep

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


def _models(n=(N, N, N), **kw):
    nx, ny, nz = n
    c = setup_seamount(nx, ny, nz)
    jm = JModel(nx, ny, nz, cfg=JConfig(**kw))
    jm.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                    theta_s=c.theta_s)
    return jm, _port(n, **kw)


def _port(n=(N, N, N), **kw):
    nx, ny, nz = n
    c = setup_seamount(nx, ny, nz)
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**kw), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    return m


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


# ------------------------------------------------------- coarsest='direct'

def test_dense_inverse_and_direct_solve_match_jax():
    """The coarsest level's dense inverse (A built from the stencil on
    every unit vector in one batch, inverted in the operator's float64)
    against JAX's to
    1e-10 x max (two LU inversions; A itself is exact in both), A^-1 A = I,
    only the coarsest level carries one; then the seamount 16^3 history of
    the direct-coarsest solve against JAX's, also on JAX's operators and
    inverse carried over (convert.operators_from_numpy)."""
    jm, m = _models(coarsest="direct")
    ops, jops = m.backend.ops, jm.backend.ops
    assert all(op.Ainv is None for op in ops[:-1])
    Ainv, jAinv = ops[-1].Ainv, jops[-1].Ainv
    close(Ainv, jAinv, 1e-10)
    s = m.levels[-1]
    n = s.nzg * s.nyg * s.nxg
    eye = torch.eye(n, dtype=torch.float64).reshape(n, s.nzg, s.nyg, s.nxg)
    A = torch.stack([-stencil.residual(
        extend_h1(e), torch.zeros_like(e), ops[-1].cA, True).reshape(n)
        for e in eye], dim=1)
    close(Ainv @ A, np.eye(n), 1e-10)
    info = _histories(jm, m, 3)
    assert info.history[-1] < 1e-6
    # JAX's operators carried over with their inverse solve as JAX's do
    cops, fm = operators_from_numpy(
        m.levels, [np.asarray(o.cA) for o in jops],
        {f: np.asarray(x) for f, x in jm.metrics._asdict().items()},
        device="cpu", Ainv=[None if o.Ainv is None else np.asarray(o.Ainv)
                            for o in jops])
    assert [o.Ainv is None for o in cops] == [o.Ainv is None for o in ops]
    close(cops[-1].Ainv, jAinv, 0)
    m.use_operators(cops, fm)
    _histories(jm, m, 2)


def test_refine_pair_carries_the_inverse():
    """refine.build_pair with coarsest='direct' (the refine script's
    default, as the JAX script's): the float32 model's coarsest level
    carries its inverse, the float64 model relaxes (its config takes no
    ``coarsest``, as the JAX package's); the refined solve reaches 1e-12."""
    from mgroms_tpu_torch.refine import build_pair, refined_pressure_solve
    c = setup_seamount(N, N, N)
    m32, m64 = build_pair(N, N, N, c, SolverConfig(dtype="float32",
                                                  coarsest="direct"),
                          device="cpu")
    assert m32.ops[-1].Ainv is not None
    assert m32.ops[-1].Ainv.dtype == torch.float32
    assert all(op.Ainv is None for op in m64.ops)
    b64 = m64.rhs(*initial_velocities(N, N, N, device="cpu"))
    _, info = refined_pressure_solve(m32, m64, b64, tol=1e-12)
    assert info.res <= 1e-12


# ------------------------------------------------------------ tridiag='pcr'

@pytest.mark.parametrize("nz", range(1, 10))
def test_tridiag_pcr_matches_jax_and_thomas(nz):
    rng = np.random.default_rng(nz)
    d = -4.0 + rng.uniform(-0.5, 0.5, (nz, 3, 5))
    dd = rng.uniform(-1.0, 1.0, (max(nz - 1, 0), 3, 5))
    b = rng.standard_normal((nz, 3, 5))
    got = relax.tridiag_pcr(t(d), t(dd), t(b))
    close(got, jrelax.tridiag_pcr(jnp.asarray(d), jnp.asarray(dd),
                                  jnp.asarray(b)))
    close(got, relax.tridiag(t(d), t(dd), t(b)), 1e-12)


def _pcr_spy(monkeypatch):
    """Record the shape of every system tridiag_pcr solves."""
    from mgroms_tpu_torch.ops import relax_compact as trc
    seen = set()
    pcr = relax.tridiag_pcr

    def spy(d, dd, b):
        seen.add(tuple(b.shape))
        return pcr(d, dd, b)

    monkeypatch.setattr(relax, "tridiag_pcr", spy)
    monkeypatch.setattr(trc, "tridiag_pcr", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pcr_solve_matches_jax(monkeypatch, dtype):
    """Seamount 16^3 with tridiag='pcr' on the card's route: the quad
    levels smoothed by K4 (its plain version here) on Thomas, only the
    coarsest level's masked relax by PCR; held to the JAX package run
    with pallas_interpret=True (its K4 in interpret mode, PCR on its
    plain coarsest level), which takes the same mix.  Float64: the history
    at rel 1e-8 over the float64 floor (atol 1e-15), as
    test_torch_sweep_fused's interpret-route test (the routes differ in
    rounding only).  Float32: the first cycle's residual within rel 1e-3
    of JAX's and of the port's own Thomas solve, so float32 PCR at the
    coarsest level costs the cycle nothing; the later cycles sit at the
    float32 floor of the relative residual (about 1e-5 here), where the
    three differ in rounding, and all three stay below 1e-4."""
    seen = _pcr_spy(monkeypatch)
    kw = dict(dtype=dtype, tridiag="pcr", pallas_interpret=True)
    jm, m = _models(**kw)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jinfo = jm.solve(*jvel(N, N, N, dtype=jd), tol=0.0, maxiter=3)[-1]
    vel = initial_velocities(N, N, N, dtype=td, device="cpu")
    info = m.solve(*vel, tol=0.0, maxiter=3)[-1]
    s = m.levels[-1]
    assert seen == {(s.nzg, s.nyg, s.nxg)}
    assert all(b < a for a, b in zip(info.history, info.history[1:]))
    if dtype == "float64":
        np.testing.assert_allclose(info.history, jinfo.history, rtol=1e-8,
                                   atol=1e-15)
        return
    np.testing.assert_allclose(info.history[:2], jinfo.history[:2],
                               rtol=1e-3)
    tinfo = _port(**{**kw, "tridiag": "thomas"}).solve(*vel, tol=0.0, maxiter=3)[-1]
    np.testing.assert_allclose(info.history[:2], tinfo.history[:2],
                               rtol=1e-3)
    assert all(max(h[2:]) < 1e-4
               for h in (info.history, jinfo.history, tinfo.history))


def test_pcr_routing_keeps_the_kernels_on_thomas(monkeypatch):
    """Without pallas_interpret the quad levels run K1-K2 (their plain
    versions here) on Thomas as on the card, and PCR only the coarsest
    level's masked relax: the history equals the Thomas solve's to float64
    rounding.  (The JAX package on the CPU without pallas_interpret
    solves every quad level by PCR; its accelerator route, which the port
    mirrors on either device, keeps its kernels on Thomas.)"""
    seen = _pcr_spy(monkeypatch)
    info = _port(tridiag="pcr").solve(*initial_velocities(N, N, N, device="cpu"), tol=0.0,
                   maxiter=3)[-1]
    s = build_level_plan(N, N, N)[-1]
    assert seen == {(s.nzg, s.nyg, s.nxg)}
    tinfo = _port().solve(*initial_velocities(N, N, N, device="cpu"), tol=0.0,
                     maxiter=3)[-1]
    np.testing.assert_allclose(info.history, tinfo.history, rtol=1e-10,
                               atol=1e-15)


# ---------------------------------------------------------------- gs_exact

@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("nsweeps", [1, 2])
def test_gs_exact_matches_jax_and_fortran(real, nsweeps):
    """relax_gs_exact against JAX's and against the numpy transliteration
    of relax_3D_8_GS (tests/test_gs_exact.py), at 5 x 6 x 7 (the JAX
    test's tolerance against the transliteration)."""
    rng = np.random.default_rng(7 + nsweeps)
    nz, ny, nx = 5, 6, 7
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    p = rng.standard_normal((nz, ny, nx))
    b = rng.standard_normal((nz, ny, nx))
    got = relax.relax_gs_exact(t(p), t(b), t(cA), nsweeps, real, extend_h1)
    want = jrelax.relax_gs_exact(jnp.asarray(p), jnp.asarray(b),
                                 jnp.asarray(cA), nsweeps, real, jext)
    close(got, want)
    ref = p
    for _ in range(nsweeps):
        ref = _np_gs_sweep(ref, b, cA, real)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-14)


# --------------------------------------------------- aggressive and 2-D

def test_aggressive_and_2d_transfers_match_jax():
    rng = np.random.default_rng(5)
    r = rng.standard_normal((16, 6, 8))
    close(transfer.restrict(t(r), aggressive=True),
          jtransfer.restrict(jnp.asarray(r), aggressive=True))
    close(transfer.restrict_aggressive(t(r)),
          jtransfer.restrict_aggressive(jnp.asarray(r)))
    r2 = rng.standard_normal((1, 6, 8))
    close(transfer.restrict(t(r2)), jtransfer.restrict(jnp.asarray(r2)))
    xce = rng.standard_normal((1, 5, 7))
    for interp in ("linear", "nearest"):
        close(transfer.prolong(t(xce), 1, interp),
              jtransfer.prolong(jnp.asarray(xce), 1, interp))
    with pytest.raises(NotImplementedError, match="aggressive"):
        transfer.prolong(t(rng.standard_normal((2, 5, 7))), 16, "linear",
                         aggressive=True)
    with pytest.raises(NotImplementedError, match="aggressive"):
        jtransfer.prolong(jnp.asarray(rng.standard_normal((2, 5, 7))), 16,
                          "linear", aggressive=True)


def test_aggressive_solver_transfers():
    """The backend's routing on an aggressive plan (level 1 coarsened 8:1
    in z): restrict takes the z-only form, in quad layout per quad, equal
    to the full-layout one; the fused down-leg and K3 are not used there;
    prolong refuses, as the JAX package does."""
    levels = build_level_plan(16, 16, 16, aggressive=True)
    assert levels[1].aggressive_from_prev and levels[1].nzg == 2
    L = len(levels)
    be = solver.SingleDeviceBackend(levels, [None] * L, SolverConfig(
        aggressive=True), packs=[object()] + [None] * (L - 1),
        on_card=False)
    assert not be.supports_fused_rr(0)
    r = t(np.random.default_rng(2).standard_normal((16, 16, 16)))
    want = transfer.restrict_aggressive(r)
    close(be.restrict(0, r), want.numpy(), 0)
    close(be.restrict(0, QuadField.split(r)), want.numpy(), 0)
    out = be.restrict(0, QuadField.split(r), as_quads=True)
    close(out.merge(), want.numpy(), 0)
    with pytest.raises(NotImplementedError, match="aggressive"):
        be.prolong(0, want)


# ------------------------------------------------------------------ sigma

@pytest.mark.parametrize("theta", [(0.0, 5.0), (0.4, 6.0)])
def test_sigma_coordinate_matches_jax(theta):
    theta_b, theta_s = theta
    rng = np.random.default_rng(4)
    h = rng.uniform(100.0, 4000.0, (6, 7))
    zeta = rng.uniform(-1.0, 1.0, (6, 7))
    zr, zw = setup_zr_zw_croco(250.0, theta_b, theta_s, t(zeta), t(h), 9,
                               coord_type="sigma")
    jzr, jzw = jzrzw(250.0, theta_b, theta_s, jnp.asarray(zeta),
                     jnp.asarray(h), 9, coord_type="sigma")
    close(zr, jzr)
    close(zw, jzw)
    assert float(zw[-1].abs().max()) == 0.0
    with pytest.raises(ValueError):
        setup_zr_zw_croco(250.0, theta_b, theta_s, t(zeta), t(h), 9,
                          coord_type="z")
