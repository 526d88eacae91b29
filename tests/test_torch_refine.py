"""Mixed-precision defect correction (mgroms_tpu_torch/refine.py) == JAX's
(mgroms_tpu/refine.py), on the CPU.

Seamount 16^3, both packages' default float32 inner solve; JAX's refined
solve runs once per module.  The two assertions of tests/test_refine.py
are applied to the port, then the port is held to JAX's run:

- the float64 residual operator: round 0's relative residual equal to
  1e-12, and the residual of JAX's own p64 equal to 1e-12 x max|JAX b|
  (at a converged p64 the residual is a cancellation of b and A p, so its
  scale is b's); at a seeded random pressure, 1e-12 x max|JAX r|;
- the inner F-cycles of every round equal, the rounds within one;
- each later round's residual within a factor of 2 of JAX's: after a
  round the residual is the float32 inner solve's floor, set by its
  round-off, which the two packages take in another order (measured
  0.97-1.02).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.cases.seamount import setup_seamount as jsetup
from mgroms_tpu.refine import build_pair as jbuild_pair
from mgroms_tpu.refine import refined_pressure_solve as jrefined
from mgroms_tpu_torch import SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.refine import build_pair, refined_pressure_solve

torch.set_num_threads(1)

N = 16
ROUND_FACTOR = 2.0


@pytest.fixture(scope="module")
def jax_run():
    case = jsetup(N, N, N, dtype=jnp.float64)
    m32, m64 = jbuild_pair(N, N, N, case)
    b64 = m64.rhs(*jvel(N, N, N, dtype=jnp.float64))
    p64, info = jrefined(m32, m64, b64, tol=1e-12, max_rounds=10)
    return m64, np.asarray(b64), np.asarray(p64), info


@pytest.fixture(scope="module")
def port_pair():
    m32, m64 = build_pair(N, N, N, setup_seamount(N, N, N), device="cpu")
    return m32, m64, m64.rhs(*initial_velocities(N, N, N, device="cpu"))


def test_refined_solve_reaches_f64_accuracy(port_pair):
    """tests/test_refine.py's first test on the port, at its tolerance."""
    m32, m64, b64 = port_pair
    assert m32.dtype == torch.float32 and m64.dtype == torch.float64
    p64, info = refined_pressure_solve(m32, m64, b64, tol=1e-11,
                                       max_rounds=8)
    assert info.res <= 1e-11, info
    assert info.history[1] < 1e-3
    assert info.rounds <= 8
    r = m64.backend.residual(0, p64, b64)
    assert float(torch.sqrt(torch.sum(r * r) / torch.sum(b64 * b64))) \
        <= 1e-11


def test_refined_beats_pure_f32_floor(port_pair):
    """tests/test_refine.py's second test on the port."""
    m32, m64, b64 = port_pair
    u, v, w = initial_velocities(N, N, N, dtype=torch.float32, device="cpu")
    _, info32 = m32.pressure_solve(m32.rhs(u, v, w), tol=1e-12, maxiter=12)
    _, info = refined_pressure_solve(m32, m64, b64, tol=1e-12,
                                     max_rounds=10)
    assert info.res < max(info32.res, 1e-7) * 1e-2


def test_refine_matches_jax(jax_run, port_pair):
    jm64, jb, jp, jinfo = jax_run
    m32, m64, b64 = port_pair
    np.testing.assert_allclose(b64.numpy(), jb, rtol=0,
                               atol=1e-12 * np.abs(jb).max())
    _, info = refined_pressure_solve(m32, m64, b64, tol=1e-12,
                                     max_rounds=10)
    assert abs(info.history[0] - jinfo.history[0]) <= 1e-12
    assert info.inner_cycles == jinfo.inner_cycles
    assert abs(info.rounds - jinfo.rounds) <= 1
    assert info.res <= 1e-12
    for got, want in zip(info.history[1:], jinfo.history[1:]):
        assert want / ROUND_FACTOR <= got <= want * ROUND_FACTOR, \
            (info.history, jinfo.history)
    # the float64 residual of the same pressure: JAX's converged p64, and
    # a seeded random one
    rng = np.random.default_rng(30)
    for p, scale in ((jp, np.abs(jb).max()),
                     (rng.standard_normal(jp.shape), None)):
        want = np.asarray(jm64.backend.residual(0, jnp.asarray(p),
                                                jnp.asarray(jb)))
        got = m64.backend.residual(0, torch.from_numpy(np.array(p)), b64)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-12 * (scale or np.abs(want).max()))


def test_perf_mode_inner_solve_reaches_1e_11():
    """A perf-mode float32 inner solve (bfloat16 smoother operator,
    V(1,1)) also takes the refined solve below 1e-11."""
    cfg32 = SolverConfig(dtype="float32", fused_bands_bf16=True, ns_pre=1,
                         ns_post=1)
    m32, m64 = build_pair(N, N, N, setup_seamount(N, N, N), cfg32,
                          device="cpu")
    assert any(pk is not None and pk.lp is not None
               for pk in m32.backend.packs)
    assert all(pk is None or pk.lp is None for pk in m64.backend.packs)
    b64 = m64.rhs(*initial_velocities(N, N, N, device="cpu"))
    _, info = refined_pressure_solve(m32, m64, b64, tol=1e-11,
                                     max_rounds=8)
    assert info.res <= 1e-11, info


def test_build_pair_refuses_a_float64_inner_solve():
    with pytest.raises(ValueError, match="float32"):
        build_pair(N, N, N, setup_seamount(N, N, N),
                   SolverConfig(dtype="float64"), device="cpu")
