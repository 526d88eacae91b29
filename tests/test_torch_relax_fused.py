"""K6 ``fused_relax`` on the CPU: its plain version against the JAX
package's Pallas kernel (interpret mode), the routing of the port's
backend to it, and the ``use_pallas=True`` solve against JAX's.

The operators are the JAX package's seamount 16^3 levels, carried over
through mgroms_tpu_torch.convert; states and RHS come from a numpy seed.
The CUDA kernel itself is held to this plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.ops.pallas import fused_relax as jfused_relax
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.convert import operators_from_numpy
from mgroms_tpu_torch.ops.kernels import relax_fused as kf

torch.set_num_threads(1)

N = 16


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX package's seamount 16^3 level plan and band stacks (f64),
    and the port's operators made from them."""
    c = setup_seamount(N, N, N)
    m = JModel(N, N, N, cfg=JConfig())
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    cA = [np.asarray(o.cA) for o in m.ops]
    ops, _ = operators_from_numpy(
        m.levels, cA, {f: np.asarray(x)
                       for f, x in m.metrics._asdict().items()},
        device="cpu")
    return m.levels, cA, ops


@pytest.mark.parametrize("nsweeps", [2, 40])
@pytest.mark.parametrize("lev", [0, -1])
def test_plain_matches_jax_kernel(jax_levels, lev, nsweeps):
    """Level 0 (16^3) and the coarsest (4, 4, 4), f64, to 1e-12."""
    levels, cA, ops = jax_levels
    s = levels[lev]
    rng = np.random.default_rng(nsweeps - lev)
    p = rng.standard_normal((s.nzg, s.nyg, s.nxg))
    b = rng.standard_normal((s.nzg, s.nyg, s.nxg))
    want = np.asarray(jfused_relax(jnp.asarray(p), jnp.asarray(b),
                                   jnp.asarray(cA[lev]), nsweeps, "RB", True,
                                   interpret=True))
    kf.reset_launches()
    tp, tb = torch.from_numpy(p), torch.from_numpy(b)
    got = kf.fused_relax_plain(tp, tb, ops[lev].cA, nsweeps, "RB", True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # on CPU tensors the wrapper is the plain version and launches nothing
    assert torch.equal(kf.fused_relax(tp, tb, ops[lev].cA, nsweeps, "RB",
                                      True), got)
    assert all(v == 0 for v in kf.LAUNCHES.values())


@pytest.mark.parametrize("lev,nsweeps", [(0, 2), (-1, 40)])
@pytest.mark.parametrize("kind", ["FC", "GS"])
def test_orderings_plain_match_jax_kernel(jax_levels, kind, lev, nsweeps):
    """The four-colour and column-Jacobi GS orderings (RB: the test
    above), f64, to 1e-12, with and without the 'real' couplings; the
    wrapper on CPU tensors is the plain version and counts nothing."""
    levels, cA, ops = jax_levels
    s = levels[lev]
    rng = np.random.default_rng(7 + nsweeps)
    p = rng.standard_normal((s.nzg, s.nyg, s.nxg))
    b = rng.standard_normal((s.nzg, s.nyg, s.nxg))
    tp, tb = torch.from_numpy(p), torch.from_numpy(b)
    kf.reset_launches()
    for real in (True, False):
        want = np.asarray(jfused_relax(jnp.asarray(p), jnp.asarray(b),
                                       jnp.asarray(cA[lev]), nsweeps, kind,
                                       real, interpret=True))
        got = kf.fused_relax_plain(tp, tb, ops[lev].cA, nsweeps, kind, real)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        assert torch.equal(kf.fused_relax(tp, tb, ops[lev].cA, nsweeps,
                                          kind, real), got)
    assert all(v == 0 for v in kf.LAUNCHES.values())


def test_launch_names_and_unknown_kind():
    """Each ordering and form counts under its own name; an unknown
    ordering raises."""
    small, big = torch.zeros((2, 4, 4)), torch.zeros((64, 64, 64))
    assert [kf.launch_name(small, k) for k in ("RB", "FC", "GS")] == [
        "fused_relax", "fused_relax_fc", "fused_relax_gs"]
    assert [kf.launch_name(big, k) for k in ("RB", "FC", "GS")] == [
        "fused_relax_step", "fused_relax_step_fc", "fused_relax_step_gs"]
    assert sorted(kf.LAUNCHES) == sorted(
        kf.launch_name(x, k) for x in (small, big) for k in kf.KINDS)
    with pytest.raises(ValueError, match="unknown relax kind"):
        kf.fused_relax(small, small, torch.zeros((8, 2, 6, 6)), 1, "XY",
                       True)


def _port(dtype="float32", **kw):
    m = NHModel(N, N, N, cfg=SolverConfig(dtype=dtype, **kw), device="cpu")
    c = setup_seamount(N, N, N)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def _record_k6(monkeypatch):
    """Shapes of every p the backend hands the K6 wrapper."""
    calls = []
    wrapped = kf.fused_relax

    def record(p, *args):
        calls.append(tuple(p.shape))
        return wrapped(p, *args)

    monkeypatch.setattr(kf, "fused_relax", record)
    return calls


def _one_fcycle(m):
    u, v, w = initial_velocities(N, N, N, dtype=m.dtype, device="cpu")
    m.pressure_solve(m.rhs(u, v, w), tol=0.0, maxiter=1)


def test_use_pallas_runs_k6_on_the_coarsest_level_only(monkeypatch):
    calls = _record_k6(monkeypatch)
    m = _port(use_pallas=True)
    _one_fcycle(m)
    s = m.levels[-1]
    # once in the F-cycle, once in each of its L-1 V-cycles
    assert calls == [(s.nzg, s.nyg, s.nxg)] * len(m.levels)


def test_use_pallas_compact_false_runs_k6_on_every_level(monkeypatch):
    calls = _record_k6(monkeypatch)
    _one_fcycle(_port(use_pallas=True, compact=False))
    assert sorted(set(calls)) == [(4, 4, 4), (8, 8, 8), (16, 16, 16)]


def test_float64_does_not_use_k6(monkeypatch):
    """itemsize <= 4, the JAX package's rule: f64 keeps the masked relax."""
    calls = _record_k6(monkeypatch)
    _one_fcycle(_port(dtype="float64", use_pallas=True))
    assert calls == []


@pytest.mark.parametrize("compact", [True, False])
def test_use_pallas_history_matches_jax(compact):
    """The port's use_pallas=True seamount 16^3 f32 history over 3
    F-cycles: equal to the port's masked-relax history (the plain K6 is
    the masked relax), and against JAX's (Pallas kernels in interpret
    mode) to rtol 1e-3 on the first cycle.  Cycles 2-3 sit at the f32
    residual floor, which the rounding order of the f32 sums sets (XLA and
    torch order them differently; the port's default path shows the same
    floor, ~4.3e-6 against JAX's ~3.5e-6): held to rtol 0.3, and the
    measured deviation is printed."""
    cfg = dict(dtype="float32", compact=compact)
    c = setup_seamount(N, N, N)
    jm = JModel(N, N, N, cfg=JConfig(use_pallas=True, **cfg))
    jm.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    *_, jinfo = jm.solve(*jvel(N, N, N, dtype=jnp.float32), tol=0.0,
                         maxiter=3)
    hist = []
    for use_pallas in (True, False):
        m = _port(use_pallas=use_pallas, **cfg)
        *_, info = m.solve(*initial_velocities(N, N, N, dtype=m.dtype,
                                               device="cpu"),
                           tol=0.0, maxiter=3)
        hist.append(np.array(info.history))
    got, want = hist[0], np.array(jinfo.history)
    np.testing.assert_array_equal(got, hist[1])
    assert len(got) == len(want) == 4
    print(f"compact={compact}: rel deviation from JAX per cycle "
          f"{np.abs(got / want - 1)}")
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0.3, atol=0)
