"""The port's convergence-loop modes against the JAX package's, in float64
on the CPU at seamount 16^3 (tests/test_solver.py:117, :184 and :206 on
the port): ``cycles_per_check`` in the host loop, ``device_loop`` (the
plain form: the same body and condition in a Python loop), both together
with a maxiter that ``cycles_per_check`` does not divide, and b == 0.
Each compares ``niter`` and the history's length exactly, the history
within rtol 1e-12 and atol 1e-15 and the pressure within 1e-12 x max|p|;
the port's device loop also equals its host loop exactly (the same
operations).  JAX compiles each configuration's step once (its solves are
cached here): the two-cycle checks are held to its host loop, which its
own tests/test_solver.py:184 holds to its device loop.  The loop's
condition (ops/kernels/device_loop.py) is held to numpy at a NaN residual,
at i == maxiter and at res == tol.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.solver import solve_p as jsolve_p
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import setup_seamount
from mgroms_tpu_torch.ops.kernels import device_loop as dl
from mgroms_tpu_torch.solver import graph_wanted, solve_p

torch.set_num_threads(1)

N = 16
TOL = 1e-10


@pytest.fixture(scope="module")
def runs():
    """One JAX model and one port model of the same numpy case, the
    right-hand side, and both configurations (the backends read no
    ``cycles_per_check``: solve_p takes it from the config it is given)."""
    c = setup_seamount(N, N, N)
    jm = JModel(N, N, N, cfg=JConfig())
    tm = NHModel(N, N, N, cfg=SolverConfig(), device="cpu")
    for m in (jm, tm):
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
    b = np.array(jm.rhs(*jvel(N, N, N)))
    return {cpc: dict(jm=jm, tm=tm, b=b,
                      jcfg=JConfig(cycles_per_check=cpc),
                      tcfg=SolverConfig(cycles_per_check=cpc))
            for cpc in (1, 2)}


_JAX = {}


def _solve_both(run, tol, maxiter, device_loop, b=None, jax_loop=None):
    """JAX's solve (its ``device_loop`` is ``jax_loop``, by default the
    port's) and the port's, on the same right-hand side."""
    zero = b is not None
    b = run["b"] if b is None else b
    jax_loop = device_loop if jax_loop is None else jax_loop
    key = (run["jcfg"], tol, maxiter, jax_loop, zero)
    if key not in _JAX:
        jp, ji = jsolve_p(run["jm"].backend, jnp.asarray(b), run["jcfg"],
                          tol=tol, maxiter=maxiter, device_loop=jax_loop)
        _JAX[key] = (np.asarray(jp), ji)
    tp, ti = solve_p(run["tm"].backend, torch.from_numpy(b), run["tcfg"],
                     tol=tol, maxiter=maxiter, device_loop=device_loop)
    return _JAX[key], (tp.numpy(), ti)


def _match(jax_run, port_run):
    (jp, ji), (tp, ti) = jax_run, port_run
    assert ti.niter == ji.niter
    assert len(ti.history) == len(ji.history)
    np.testing.assert_allclose(np.array(ti.history), np.array(ji.history),
                               rtol=1e-12, atol=1e-15)
    assert ti.res == ti.history[-1]
    assert np.abs(tp - jp).max() <= 1e-12 * np.abs(jp).max()


def test_cycles_per_check_host_loop(runs):
    """Two F-cycles a check in the host loop (tests/test_solver.py:184's
    config): a history entry a check, niter += 2, past maxiter 5."""
    jax_run, port_run = _solve_both(runs[2], TOL, 5, device_loop=False)
    _match(jax_run, port_run)
    assert port_run[1].niter == 6
    assert len(port_run[1].history) == port_run[1].niter // 2 + 1


def test_device_loop_matches_jax_and_host_loop(runs):
    """tests/test_solver.py:117 on the port: the device loop gives JAX's
    device loop, and the port's own host loop to every digit."""
    jax_run, port_run = _solve_both(runs[1], TOL, 20, device_loop=True)
    _match(jax_run, port_run)
    tm = runs[1]["tm"]
    hp, hi = solve_p(tm.backend, torch.from_numpy(runs[1]["b"]),
                     runs[1]["tcfg"],
                     tol=TOL, maxiter=20, device_loop=False)
    assert hi.niter == port_run[1].niter
    assert hi.history == port_run[1].history
    assert torch.equal(hp, torch.from_numpy(port_run[0]))


def test_device_loop_cycles_per_check_not_dividing_maxiter(runs):
    """tests/test_solver.py:184 on the port: maxiter 5, two F-cycles a
    check, so the last check lands at 6, past maxiter, and its residual is
    in the history."""
    jax_run, port_run = _solve_both(runs[2], TOL, 5, device_loop=True,
                                    jax_loop=False)
    _match(jax_run, port_run)
    assert port_run[1].niter == 6
    tm = runs[2]["tm"]
    _, hi = solve_p(tm.backend, torch.from_numpy(runs[2]["b"]),
                    runs[2]["tcfg"],
                    tol=TOL, maxiter=5, device_loop=False)
    assert hi.niter == 6 and hi.history == port_run[1].history


def test_zero_rhs_degenerates_like_jax(runs):
    """tests/test_solver.py:206 on the port: b == 0 gives niter 0, the
    history (nan,) and p == 0 in both loop forms."""
    b = np.zeros((N, N, N))
    for device_loop in (False, True):
        (jp, ji), (tp, ti) = _solve_both(runs[1], TOL, 20, device_loop,
                                         b=b)
        assert ji.niter == 0 and ti.niter == 0
        assert len(ti.history) == len(ji.history) == 1
        assert np.isnan(ti.history).all() and np.isnan(ji.history).all()
        assert np.abs(tp).max() == 0.0 and np.abs(jp).max() == 0.0


def _np_condition(rsq, bnorm, it, maxiter, tol, cpc, init, dtype):
    """The condition in numpy: the root in the state's type, the division
    in it (prologue) or in float64 (a check)."""
    s = np.sqrt(dtype(rsq))
    with np.errstate(invalid="ignore", divide="ignore"):
        if init:
            return 0, float(s / dtype(bnorm)), None
        i = it + cpc
        res = float(np.float64(s) / np.float64(dtype(bnorm)))
    return i, res, bool(i < maxiter and res > tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_loop_condition_plain_against_numpy(dtype):
    """The plain condition at a NaN residual (0/0, as b == 0 gives), at
    i == maxiter, at res == tol, inside the loop, and in the prologue."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    maxiter, cpc = 6, 2
    cases = [  # (rsq, bnorm, it, init, tol)
        (0.0, 0.0, 0, False, 1e-4),          # NaN: ends the loop
        (0.0, 0.0, 0, True, 1e-4),           # NaN in the prologue
        (4e-6, 1.0, 4, False, 1e-4),         # i == maxiter: ends
        (1e-4, 1.0, 0, False, None),         # res == tol: ends
        (2.5e-7, 3.0, 2, False, 1e-4),       # res > tol, i < maxiter
        (2.5e-7, 3.0, 3, True, 1e-4),        # prologue: i = 0
    ]
    for rsq, bnorm, it0, init, tol in cases:
        if tol is None:              # tol set to the residual itself
            tol = float(np.sqrt(npt(rsq))) / float(npt(bnorm))
        it = torch.tensor(it0, dtype=torch.int32)
        cont = torch.tensor(7, dtype=torch.int32)
        runs = torch.tensor(3, dtype=torch.int32)
        hist = torch.full((maxiter + cpc,), float("nan"),
                          dtype=torch.float64)
        lim = torch.tensor([float(maxiter), tol], dtype=torch.float64)
        dl.loop_condition(torch.tensor(rsq, dtype=dtype),
                          torch.tensor(bnorm, dtype=dtype), it, hist, lim,
                          cpc, init, cont, runs)
        i, res, go = _np_condition(rsq, bnorm, it0, maxiter, tol, cpc, init,
                                   npt)
        if init:
            go = bool(maxiter > 0 and res > tol)
        assert int(it) == i
        got = float(hist[i])
        assert (np.isnan(got) and np.isnan(res)) or got == res
        assert bool(cont) == go
        assert int(runs) == 4
        others = torch.cat([hist[:i], hist[i + 1:]])
        assert torch.isnan(others).all()
    # the three ends of the loop: a NaN residual, i == maxiter, res == tol
    assert not _np_condition(0.0, 0.0, 0, maxiter, 1e-4, cpc, False, npt)[2]
    assert not _np_condition(4e-6, 1.0, 4, maxiter, 1e-4, cpc, False,
                             npt)[2]


def test_graph_is_refused_off_the_card(runs):
    """``graph`` (the counterpart of jax.disable_jit): on the CPU the
    loop is eager, and asking for a graph raises."""
    tm = runs[1]["tm"]
    assert not graph_wanted(tm.backend, None)
    assert not graph_wanted(tm.backend, False)
    with pytest.raises(ValueError, match="CUDA graph"):
        solve_p(tm.backend, torch.from_numpy(runs[1]["b"]), tm.cfg,
                tol=TOL, maxiter=2, graph=True)


def test_kernel_key_names_every_counted_kernel():
    """A CUDA graph's kernel nodes, by demangled function name (as the card
    shows them), map to the LAUNCHES key of the wrapper that launches
    them; a PyTorch kernel maps to none."""
    from mgroms_tpu_torch.ops import kernels
    ns = "(anonymous namespace)::"
    cases = {
        "colour_kernel<float, float, true, false, 0, 2>": "color_update",
        "colour_kernel<float, float, true, true, 1, 2>": "color_update_emit",
        "colour_kernel<float, __nv_bfloat16, true, false, 0, 1>":
            "color_update_bf16",
        "rr_kernel<float, true, 0>": "residual_restrict",
        "rr_kernel<double, false, 1>": "residual_restrict",
        "rr_kernel<float, true, 2>": "residual_quads",
        "residual_kernel<float>": "residual_tiled",
        "sweep_kernel<float, float>": "relax_fused_sweep",
        "sweep_kernel<double, double>": "relax_fused_sweep",
        "sweep_kernel<float, __nv_bfloat16>": "relax_fused_sweep_bf16",
        "sweep_kernel<double, __nv_bfloat16>": "relax_fused_sweep_bf16_f64",
        # K4's kernel of each ring depth lives in a namespace of its own
        "ahead2::sweep_kernel<float, float>": "relax_fused_sweep",
        "ahead7::sweep_kernel<float, __nv_bfloat16>": "relax_fused_sweep_bf16",
        "ahead7::sweep_kernel<double, __nv_bfloat16>":
            "relax_fused_sweep_bf16_f64",
        "ahead13::sweep_kernel<float, float>": "relax_fused_sweep",
        "relax_resident<float, 0, 2, false>": "fused_relax",
        "relax_resident<float, 1, 4, true>": "fused_relax_cluster_fc",
        "relax_resident<double, 2, 0, false>": "fused_relax_gs",
        "relax_step<float, 0>": "fused_relax_step",
        "relax_step<float, 1>": "fused_relax_step_fc",
        "relax_step<double, 2>": "fused_relax_step_gs",
        "loop_condition_kernel<float>": "loop_condition",
    }
    counted = kernels.launches()
    for name, key in cases.items():
        assert key in counted
        assert kernels.kernel_key(ns + name + "(Params)") == key, name
    for name in ("void at::native::vectorized_elementwise_kernel<4, "
                 "at::native::FillFunctor<float>>(int, float)",
                 "mirr_kernel<float, true, 2>"):
        assert kernels.kernel_key(name) is None
