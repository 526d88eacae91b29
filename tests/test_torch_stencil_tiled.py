"""K5 ``residual_tiled`` on the CPU: its plain version against the JAX
package's Pallas kernel (interpret mode), and the routing of the port's
backend to it on full-layout levels at least 256 wide.

The operator is the JAX package's seamount level at (8, 32, 64), carried
over through mgroms_tpu_torch.convert; state and RHS come from a numpy
seed.  The CUDA kernel itself is held to this plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.bc import extend_h1 as jextend
from mgroms_tpu.ops.pallas.stencil_tiled import residual_tiled as jresidual
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.bc import extend_h1
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.convert import operators_from_numpy
from mgroms_tpu_torch.levels import build_level_plan
from mgroms_tpu_torch.ops.kernels import stencil_tiled as ks
from mgroms_tpu_torch.solver import SingleDeviceBackend

torch.set_num_threads(1)


NZ, NY, NX = 8, 32, 64


@pytest.fixture(scope="module")
def jax_operator():
    """The JAX package's seamount level-0 band stack at (8, 32, 64), f64,
    and the port's copy of it."""
    c = setup_seamount(NX, NY, NZ)
    m = JModel(NX, NY, NZ, cfg=JConfig())
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    ops, _ = operators_from_numpy(
        m.levels, [np.asarray(o.cA) for o in m.ops],
        {f: np.asarray(x) for f, x in m.metrics._asdict().items()},
        device="cpu")
    return np.asarray(m.ops[0].cA), ops[0].cA


@pytest.mark.parametrize("real", [True, False])
def test_plain_matches_jax_kernel(jax_operator, real):
    cA, tcA = jax_operator
    rng = np.random.default_rng(0)
    p = rng.standard_normal((NZ, NY, NX))
    b = rng.standard_normal((NZ, NY, NX))
    want = np.asarray(jresidual(jextend(jnp.asarray(p)), jnp.asarray(b),
                                jnp.asarray(cA), real, interpret=True))
    ks.reset_launches()
    pe, tb = extend_h1(torch.from_numpy(p)), torch.from_numpy(b)
    got = ks.residual_tiled_plain(pe, tb, tcA, real)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-10)
    # on CPU tensors the wrapper is the plain version and launches nothing
    assert torch.equal(ks.residual_tiled(pe, tb, tcA, real), got)
    assert ks.LAUNCHES["residual_tiled"] == 0


@pytest.mark.parametrize("compact", [True, False])
def test_k5_gate_on_the_cuc_plan(compact):
    """CUC 1024^2 x 64: K5 on the full-layout levels 1024, 512 and 256
    wide (levels 0-2), whatever use_pallas says; never with
    pallas_tiled=False.  The gate reads only the plan and the config."""
    levels = build_level_plan(1024, 1024, 64)
    for use_pallas in (True, False):
        cfg = SolverConfig(dtype="float32", use_pallas=use_pallas,
                           compact=compact)
        be = SingleDeviceBackend(levels, [None] * len(levels), cfg,
                                 packs=[None] * len(levels))
        assert ([be._use_tiled(lev, "residual") for lev in range(6)]
                == [True, True, True, False, False, False])
        assert not any(be._use_tiled(lev, "relax") for lev in range(6))
    cfg = SolverConfig(dtype="float32", compact=compact, pallas_tiled=False)
    be = SingleDeviceBackend(levels, [None] * len(levels), cfg,
                             packs=[None] * len(levels))
    assert not any(be._use_tiled(lev, "residual") for lev in range(6))


def test_compact_false_fcycle_reaches_k5_on_wide_levels(monkeypatch):
    """One F-cycle of a (1024, 32, 16) seamount with use_pallas=True,
    compact=False (levels 1024, 512, 256 and the 128-wide coarsest): the
    K5 wrapper gets level 0 three times (solve_init, the V-cycle from
    level 0, the cycle's final residual), level 1 twice and level 2 three
    times, as on CUC's levels 0-2."""
    calls = []
    wrapped = ks.residual_tiled

    def record(pe, b, *args):
        calls.append(tuple(b.shape))
        return wrapped(pe, b, *args)

    monkeypatch.setattr(ks, "residual_tiled", record)
    nx, ny, nz = 1024, 32, 16
    m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype="float32",
                                             use_pallas=True, compact=False),
                device="cpu")
    c = setup_seamount(nx, ny, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(nx, ny, nz, dtype=m.dtype, device="cpu")
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=0.0, maxiter=1)
    assert info.niter == 1 and np.isfinite(info.history).all()
    shape = [(s.nzg, s.nyg, s.nxg) for s in m.levels]
    assert [s[2] for s in shape] == [1024, 512, 256, 128]
    assert sorted(calls) == sorted([shape[0]] * 3 + [shape[1]] * 2
                                   + [shape[2]] * 3)
