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


# the form the gate gives every level of seamount 64^3 and CUC 1024^2 x
# 64, in float32 and float64: RB and FC, then GS where it differs (PERF.md
# gives the card's timings behind it)
GATE = {
    (64, 64, 64): ("step", "step"),
    (32, 32, 32): ("step", "step"),
    (16, 16, 16): ("step", "step"),
    (8, 8, 8): ("block", "block"),
    (4, 4, 4): ("block", "block"),
    (64, 1024, 1024): ("step", "step"),
    (32, 512, 512): ("step", "step"),
    (16, 256, 256): ("step", "step"),
    (8, 128, 128): ("step", "step"),
    (4, 64, 64): ("cluster", "step"),
    (2, 32, 32): ("block", "block"),
}
GATE_GS = {(8, 8, 8): ("step", "step"), (4, 64, 64): ("step", "step")}


@pytest.mark.parametrize("case", ["seamount", "cuc"])
def test_launch_names_and_unknown_kind(case):
    """The gate is a function of shape, dtype and ordering: each level of
    the case's plan takes the form GATE (GS: GATE_GS) pins, in float32 and
    float64; each ordering and form counts under its own name; an unknown
    ordering or form raises."""
    from mgroms_tpu_torch.levels import build_level_plan
    grid = (64, 64, 64) if case == "seamount" else (1024, 1024, 64)
    shapes = [(s.nzg, s.nyg, s.nxg) for s in build_level_plan(*grid)]
    assert len(shapes) == (5 if case == "seamount" else 6)
    for shape in shapes:
        for kind in ("RB", "FC", "GS"):
            want = (GATE_GS.get(shape, GATE[shape]) if kind == "GS"
                    else GATE[shape])
            got = tuple(kf.form(shape, dt, kind) for dt in (torch.float32,
                                                            torch.float64))
            assert got == want, (shape, kind, got)
            for dt, f in zip((torch.float32, torch.float64), got):
                x = torch.zeros(shape, dtype=dt)
                assert kf.launch_name(x, kind) == kf.KINDS[kind].name(f)
    # the cluster form takes float32 levels of nz 2 or 4 only
    assert kf.cluster_takes((4, 64, 64), torch.float32)
    assert kf.cluster_takes((2, 17, 9), torch.float32)
    assert not any(kf.cluster_takes(s, dt) for s, dt in (
        ((4, 64, 64), torch.float64), ((8, 128, 128), torch.float32),
        ((1, 17, 5), torch.float32), ((3, 2, 9), torch.float32)))
    small = torch.zeros((2, 4, 4))
    assert [kf.launch_name(small, k) for k in ("RB", "FC", "GS")] == [
        "fused_relax", "fused_relax_fc", "fused_relax_gs"]
    assert sorted(kf.LAUNCHES) == sorted(
        kf.KINDS[k].name(f) for f in kf.FORMS for k in kf.KINDS)
    with pytest.raises(ValueError, match="unknown relax kind"):
        kf.fused_relax(small, small, torch.zeros((8, 2, 6, 6)), 1, "XY",
                       True)
    with pytest.raises(ValueError, match="unknown form"):
        kf.fused_relax_form(small, small, torch.zeros((8, 2, 6, 6)), 1,
                            "RB", True, "grid")


def np_resident(p, b, cA, nsweeps, kind, real, nblocks):
    """The one-launch forms' recipe (csrc/relax_fused.cu relax_resident)
    in float64 scalars: ``nblocks`` blocks (1: the one-block form) each
    hold a band of rows r * ny // nblocks .. in their own buffers and read
    the rows next to it from the neighbour block's (asserted: no other);
    each thread's two slots (one column of each RB colour, GS's two parity
    classes; FC's two thread groups, colours 0-1 and 2-3) hold records
    computed once (the Thomas factors with the
    plain version's divisions); a step solves its columns in reverse
    thread order, each written the moment it is solved (RB and FC in
    place; GS into the other buffer), RB's 'real' diagonals read from the
    plane-0 snapshot, which takes a column's new value a step later."""
    nz, ny, nx = p.shape
    hx = (nx + 1) // 2
    ncolor = {"RB": 2, "FC": 4, "GS": 1}[kind]
    rows_max = -(-ny // nblocks)
    # FC: two groups of threads, group g owning colours 2g and 2g + 1
    nt0 = ((rows_max + 1) // 2 if kind == "FC" else rows_max) * hx
    nt = 2 * nt0 if kind == "FC" else nt0
    slots = lambda t: (2 * (t // nt0) + ls for ls in (0, 1))
    lo = [r * ny // nblocks for r in range(nblocks + 1)]
    owner = [next(r for r in range(nblocks) if lo[r] <= j < lo[r + 1])
             for j in range(ny)]
    A = [p[:, lo[r]:lo[r + 1]].tolist() for r in range(nblocks)]
    B = [p[:, lo[r]:lo[r + 1]].tolist() for r in range(nblocks)]
    S0 = [[row[:] for row in A[r][0]] for r in range(nblocks)]

    def band(n, kk, j, i, dj=0, di=0):
        if kk < 0 or kk >= nz:
            return 0.0
        return float(cA[n, kk, j + 1 + dj, i + 1 + di])

    def column(r, t, s):
        lr, m = divmod(t % nt0, hx)
        if kind == "FC":
            j = lo[r] + ((lo[r] + (s & 1)) & 1) + 2 * lr
            i = 2 * m + (s >> 1)
        else:
            j = lo[r] + lr
            i = 2 * m + ((j + s) & 1)
        return (j, i) if j < lo[r + 1] and i < nx else None

    def read(bufs, r, k, jj, ii):
        """plane k (0 outside the column) of row jj, as block r sees it"""
        if k < 0 or k >= nz:
            return 0.0
        o = owner[jj]
        assert abs(o - r) <= 1
        return bufs[o][k][jj - lo[o]][ii]

    rec = {}
    for r in range(nblocks):
        for t in range(nt):
            for s in slots(t):
                col = column(r, t, s)
                if col is None:
                    continue
                j, i = col
                planes, bet = [], 0.0
                for k in range(nz):
                    v = [band(2, k, j, i), band(2, k - 1, j, i, 1, 0),
                         band(3, k, j, i), band(3, k, j, i, 1, 0),
                         band(4, k, j, i), band(4, k + 1, j, i, 1, 0),
                         band(5, k, j, i), band(5, k - 1, j, i, 0, 1),
                         band(6, k, j, i), band(6, k, j, i, 0, 1),
                         band(7, k, j, i), band(7, k + 1, j, i, 0, 1)]
                    dd = band(1, k, j, i) if k > 0 else 0.0
                    if nz == 1:
                        bet = band(0, 0, j, i)
                    elif k == 0:
                        bet = 1.0 / band(0, 0, j, i)
                    else:
                        gm = dd * bet
                        planes[k - 1][14] = gm
                        bet = 1.0 / (band(0, k, j, i) - dd * gm)
                    planes.append(v + [dd, bet, 0.0, float(b[k, j, i])])
                rec[r, t, s] = (planes, band(4, 0, j, i, -1, 1),
                                band(7, 0, j, i, 1, 1))

    def solve(r, t, s, rd, wr):
        col = column(r, t, s)
        if col is None:
            return None
        j, i = col
        planes, r0, r1 = rec[r, t, s]
        cl = lambda jj, ii: (min(max(jj, 0), ny - 1), min(max(ii, 0), nx - 1))
        nbr = [cl(j - 1, i), cl(j + 1, i), cl(j, i - 1), cl(j, i + 1)]
        st = lambda k, d: read(rd, r, k, *nbr[d])
        xf, x = [], 0.0
        for k in range(nz):
            v = planes[k]
            s_ = v[0] * st(k + 1, 0)
            s_ = s_ + v[1] * st(k - 1, 1)
            s_ = s_ + v[2] * st(k, 0)
            s_ = s_ + v[3] * st(k, 1)
            s_ = s_ + v[4] * st(k - 1, 0)
            s_ = s_ + v[5] * st(k + 1, 1)
            s_ = s_ + v[6] * st(k + 1, 2)
            s_ = s_ + v[7] * st(k - 1, 3)
            s_ = s_ + v[8] * st(k, 2)
            s_ = s_ + v[9] * st(k, 3)
            s_ = s_ + v[10] * st(k - 1, 2)
            s_ = s_ + v[11] * st(k + 1, 3)
            if real and k == 0:
                def diag(jj, ii):
                    jj, ii = cl(jj, ii)
                    same = (jj + ii + j + i) % 2 == 0
                    return read([[pl] for pl in S0] if kind == "RB"
                                and same else rd, r, 0, jj, ii)
                x0 = v[4] * diag(j + 1, i - 1)
                x0 = x0 + r0 * diag(j - 1, i + 1)
                x0 = x0 + v[10] * diag(j - 1, i - 1)
                x0 = x0 + r1 * diag(j + 1, i + 1)
                s_ = s_ + x0
            rhs = v[15] - s_
            if nz == 1:
                x = rhs / v[13]
            elif k == 0:
                x = rhs * v[13]
            else:
                x = (rhs - v[12] * x) * v[13]
            xf.append(x)
        mine = rd[r]
        for k in range(nz - 1, -1, -1):
            if k < nz - 1:
                x = xf[k] - planes[k][14] * x
            po = mine[k][j - lo[r]][i]
            wr[r][k][j - lo[r]][i] = po + (x - po)
        return j, i, wr[r][0][j - lo[r]][i]

    pend = []
    rd, wr = A, (B if kind == "GS" else A)
    for _ in range(nsweeps):
        for c in range(ncolor):
            for r, j, i, v in pend:
                S0[r][j - lo[r]][i] = v
            pend = []
            for r in reversed(range(nblocks)):
                for t in reversed(range(nt)):
                    for s in ((0, 1) if kind == "GS" else (c,)):
                        if s not in slots(t):
                            continue
                        got = solve(r, t, s, rd, wr)
                        if got and kind == "RB" and real:
                            pend.append((r, *got))
            if kind == "GS":
                rd, wr = wr, rd
    return np.concatenate([np.array(rd[r]) for r in range(nblocks)], axis=1)


@pytest.mark.parametrize("nblocks", [1, 3])
@pytest.mark.parametrize("shape", [(1, 7, 5), (2, 7, 5), (4, 7, 5),
                                   (1, 4, 6), (2, 4, 6), (4, 4, 6)])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("kind", ["RB", "FC", "GS"])
def test_one_launch_recipe_matches_plain(kind, real, shape, nblocks):
    """The one-launch forms' recipe (np_resident; nblocks 3: a cluster
    whose band count divides neither ny = 7 nor ny = 4) equals
    fused_relax_plain bit for bit in float64, nz 1, 2 and 4, ragged widths,
    with and without 'real', over 3 sweeps."""
    rng = np.random.default_rng(sum(shape) + nblocks)
    nz, ny, nx = shape
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    p = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    want = kf.fused_relax_plain(torch.from_numpy(p), torch.from_numpy(b),
                                torch.from_numpy(cA), 3, kind, real).numpy()
    got = np_resident(p, b, cA, 3, kind, real, nblocks)
    assert np.array_equal(got, want), np.abs(got - want).max()


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
