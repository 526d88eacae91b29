"""The hand-written CUDA kernels == their plain torch versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
no CUDA device is present (the CPU test host).  Run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which a GPU host
need not have.)

Built with -fmad=false, the kernels round like the plain versions' separate
torch ops, so the solution outputs (K1 with either block type, K2, K4,
K6 in every ordering), K3's and K5's residuals and K11's sums are held to
0 ulp; the raw residual output of K2, a cancellation, is held to
1e-6 x max|bq| (f32).
"""

import ctypes

import numpy as np
import pytest
import torch

from mgroms_tpu_torch.bc import extend_h1
from mgroms_tpu_torch.ops import relax_compact as rc
from mgroms_tpu_torch.ops.kernels import relax_fused as kf
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt
from mgroms_tpu_torch.ops.kernels import stencil_tiled as ks
from mgroms_tpu_torch.ops.kernels import sweep_fused as ksf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(nz, H, W, dtype, device, real, seed, layout="blocks"):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, 2 * H + 2, 2 * W + 2))
    cA[0] -= 4.0
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    build = (rc.build_band_pack if layout == "bands"
             else rc.build_compact_pack)
    pack = build(t(cA), real)
    e = rc.extend_quads(rc.split_quads(t(rng.standard_normal(
        (nz, 2 * H, 2 * W)))))
    bq = rc.split_quads(t(rng.standard_normal((nz, 2 * H, 2 * W))))
    return pack, e, bq


def _maxdiff(a, b):
    return float((a - b).abs().max())


# K1 and K2 a colour a launch: ragged quads, nz 2 with H = W = 1, widths
# 7, 33 and 70 against the 64-column tile, a level of many tiles, and nz
# 880, whose multipliers do not fit an FC colour's shared memory in either
# type (it recomputes them, as an RB colour always does)
SHAPES = [(6, 5, 7), (2, 3, 4), (2, 1, 1), (4, 3, 70), (8, 16, 33),
          (64, 8, 128), (880, 1, 3)]
# every colour of both orderings: the RB pairs, then the FC single targets
COLOURS = rc.colour_targets("RB") + rc.colour_targets("FC")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("layout", ["bands", "blocks"])
def test_kernels_match_plain(cuda, shape, dtype, real, layout):
    """K1 on every colour of both orderings (one launch each: the two
    targets of an RB colour, one of FC) and K2 on the RB colours, on
    either operator layout: 0 ulp from the plain versions, one launch a
    colour, the inputs unwritten."""
    nz, H, W = shape
    pack, e, bq = _inputs(nz, H, W, dtype, cuda, real, sum(shape), layout)
    assert kt.colour_operator(pack, dtype)[0] == layout
    e0 = {k: x.clone() for k, x in e.items()}
    for colour in COLOURS:
        before = dict(kt.LAUNCHES)
        got = kt.color_update(e, bq, pack, colour)
        want = kt.color_update_plain(e, bq, pack, colour)
        torch.cuda.synchronize()
        assert sorted(got) == sorted(colour)
        for t in colour:
            assert torch.equal(got[t], want[t]), (colour, t)
        key = ["color_update"]
        if len(colour) == 2:
            gs, gr = kt.color_update_emit(e, bq, pack, colour)
            ws, wr = kt.color_update_emit_plain(e, bq, pack, colour)
            torch.cuda.synchronize()
            for t in colour:
                assert torch.equal(gs[t], ws[t]), (colour, t)
                assert torch.equal(gr[t], wr[t]), (colour, t)
            key.append("color_update_emit")
        assert {k: v - before[k] for k, v in kt.LAUNCHES.items()} \
            == {k: int(k in key) for k in kt.LAUNCHES}
    assert all(torch.equal(e[k], e0[k]) for k in e)


# K3: widths that are not a multiple of its 64-column tile, one quad row
# and column with nz 2, the seamount 64^3 level-0 quads, and a ragged one
RR_SHAPES = [(6, 5, 7), (2, 1, 1), (4, 3, 33), (8, 16, 70), (3, 5, 33),
             (64, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", RR_SHAPES)
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("layout", ["bands", "blocks"])
def test_residual_restrict_matches_plain(cuda, shape, dtype, real, layout):
    """K3 in both operator layouts and all three modes (the coarse RHS,
    two targets' z-pair sums, the residual of all four targets and of
    one): 0 ulp from its plain version, one launch each, counted under
    its mode's name; odd nz takes the residual mode only."""
    nz, H, W = shape
    rng = np.random.default_rng(sum(shape))
    cA = rng.uniform(-0.1, 0.1, (8, nz, 2 * H + 2, 2 * W + 2))
    cA[0] -= 4.0
    cA = torch.tensor(cA, dtype=dtype, device=cuda)
    build = (rc.build_band_pack if layout == "bands"
             else rc.build_compact_pack)
    pack = build(cA, real)
    assert kt.rr_operator(pack) == layout
    q = rc.split_quads(torch.tensor(rng.standard_normal((nz, 2 * H, 2 * W)),
                                    dtype=dtype, device=cuda))
    bq = rc.split_quads(torch.tensor(rng.standard_normal((nz, 2 * H, 2 * W)),
                                     dtype=dtype, device=cuda))
    e = rc.extend_quads(q)
    e4 = tuple(e[k] for k in rc._TKEYS)
    cases = [("residual", rc._TKEYS), ("residual", ((1, 0),))]
    if nz % 2 == 0:
        cases += [("coarse", rc._TKEYS), ("zsum", ((0, 0), (1, 1)))]
    for mode, targets in cases:
        before = dict(kt.LAUNCHES)
        got = kt.residual_restrict(e4, bq, pack, mode, targets)
        want = kt.residual_restrict_plain(e4, bq, pack, mode, targets)
        torch.cuda.synchronize()
        key = "residual_quads" if mode == "residual" else "residual_restrict"
        assert {k: v - before[k] for k, v in kt.LAUNCHES.items()} == {
            k: int(k == key) for k in kt.LAUNCHES}
        if mode == "coarse":
            assert torch.equal(got, want)
        else:
            assert sorted(got) == sorted(targets)
            assert all(torch.equal(got[t], want[t]) for t in targets)


def test_residual_restrict_rejects_bad_input(cuda):
    pack, e, bq = _inputs(4, 3, 5, torch.float32, cuda, True, seed=0)
    e4 = tuple(e[k] for k in rc._TKEYS)
    cA = torch.rand((8, 4, 8, 12), device=cuda)
    cA[0] -= 4.0
    band = rc.build_band_pack(cA, True)
    for bad_e4, bad_bq, bad_pack, mode in (
            (e4[:3] + (e4[3].double(),), bq, pack, "coarse"),      # dtype
            (e4, {**bq, (0, 1): bq[(0, 1)].cpu()}, pack, "coarse"),  # device
            (e4, bq, pack._replace(rblocks=None), "coarse"),   # no 'real' pair
            (tuple(x[:3] for x in e4), bq, pack, "zsum"),      # odd nz
            (e4, bq, band._replace(ebands=band.ebands.contiguous()),
             "coarse")):                                       # stack pitch
        with pytest.raises(ValueError):
            kt.residual_restrict(bad_e4, bad_bq, bad_pack, mode)
    with pytest.raises(ValueError):                    # coarse needs all four
        kt.residual_restrict(e4, bq, pack, "coarse", ((0, 0),))


def test_wrapper_rejects_bad_input(cuda):
    pack, e, bq = _inputs(4, 3, 5, torch.float32, cuda, True, seed=0)
    nc = torch.empty((4, 5, 3), device=cuda).transpose(1, 2)
    colour = ((0, 0), (1, 1))
    bet = pack.bet
    for bad_e, bad_bq, bad_pack, targets in (
            (e, bq, pack._replace(bet=(bet[0].double(),) + bet[1:]),
             colour),                                         # dtype
            (e, bq, pack._replace(blocks=(pack.blocks[0].cpu(),)
                                  + pack.blocks[1:]), colour),  # device
            (e, bq, pack._replace(rblocks=None), colour),   # no 'real' pair
            (e, bq, pack._replace(bet=(nc,) + bet[1:]), colour),  # layout
            ({**e, (0, 1): e[(0, 1)][:, 1:]}, bq, pack, colour),  # shape
            (e, bq, pack, ((0, 0), (0, 1))),                # not a colour
            (e, bq, pack, ((0, 0), (1, 1), (0, 1)))):       # three targets
        with pytest.raises(ValueError):
            kt.color_update(bad_e, bad_bq, bad_pack, targets)
    with pytest.raises(ValueError):                   # K2: the RB colours
        kt.color_update_emit(e, bq, pack, ((0, 0),))
    # the band stack: wrong pitch (a contiguous copy), type or device
    cA = torch.rand((8, 4, 8, 12), device=cuda)
    cA[0] -= 4.0
    band = rc.build_band_pack(cA, True)
    for bad in (band.ebands.contiguous(),
                rc.band_quads(cA.double()),
                band.ebands.cpu()):
        with pytest.raises(ValueError):
            kt.color_update(e, bq, band._replace(ebands=bad), colour)
        with pytest.raises(ValueError):
            kt.color_update_emit(e, bq, band._replace(ebands=bad), colour)
    # the bfloat16 stack of the smoother operator
    lp = rc.attach_lp(band)
    for bad in (lp.lp.ebands.contiguous(), lp.lp.ebands.float()):
        with pytest.raises(ValueError):
            kt.color_update(e, bq, lp._replace(
                lp=lp.lp._replace(ebands=bad)), colour)


@pytest.mark.parametrize("route", ["K1-K2", "FC", "perf K4 off", "tiles"])
def test_card_packs_hold_the_band_stack_only(cuda, route):
    """On the card every quad level holds its operator as the band stack
    only, on the K1-K2 route too (pallas_fused_sweep=False, FC, perf mode
    with K4 off, the tiles of a distributed level): no gather blocks of
    either precision; in perf mode the bfloat16 stack beside the float32
    one."""
    from mgroms_tpu_torch import NHModel, SolverConfig
    from mgroms_tpu_torch.cases.seamount import setup_seamount
    n = 16
    cfg = {"K1-K2": dict(pallas_fused_sweep=False),
           "FC": dict(relax_method="FC"),
           "perf K4 off": dict(dtype="float32", fused_bands_bf16=True,
                               ns_pre=1, ns_post=1,
                               pallas_fused_sweep=False),
           "tiles": dict(pallas_fused_sweep=False)}[route]
    m = NHModel(n, n, n, cfg=SolverConfig(**cfg), device=cuda)
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    if route == "tiles":
        m.distribute(2, 2, devices=[cuda] * 4, comm="shard_map")
    packs = [pk for pk in m.backend.packs if pk is not None]
    assert packs and not m.backend.fused_sweep
    tiles = [t for pk in packs
             for t in (pk.flat() if hasattr(pk, "flat") else (pk,))]
    assert any(hasattr(pk, "flat") for pk in packs) == (route == "tiles")
    for pk in tiles:
        assert pk.blocks is None and pk.rblocks is None
        assert pk.ebands is not None and pk.ebands.is_cuda
        if route.startswith("perf"):
            assert pk.lp.blocks is None
            assert pk.lp.ebands.dtype == torch.bfloat16


@pytest.mark.parametrize("fused_sweep", [True, False])
def test_seamount16_solve_runs_the_kernels(cuda, fused_sweep):
    """The default solve on the card smooths the quad levels with K4 and
    restricts with K3; with pallas_fused_sweep=False with K1, K2 (the
    fused residual) and K3.  Either history equals the CPU solve's."""
    from mgroms_tpu_torch import NHModel, SolverConfig
    from mgroms_tpu_torch.cases.seamount import (initial_velocities,
                                                 setup_seamount)
    n = 16
    m = NHModel(n, n, n, cfg=SolverConfig(pallas_fused_sweep=fused_sweep),
                device=cuda)
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(n, n, n, device=cuda)
    kt.reset_launches()
    ksf.reset_launches()
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-11, maxiter=12)
    k1_k2 = ("color_update", "color_update_emit")
    assert kt.LAUNCHES["residual_restrict"] > 0, kt.LAUNCHES
    # every quad level on the card holds the band stack: its level-0
    # residual is K3 in its residual mode on either route
    assert kt.LAUNCHES["residual_quads"] > 0, kt.LAUNCHES
    assert all((kt.LAUNCHES[k] > 0) != fused_sweep for k in k1_k2), \
        kt.LAUNCHES
    assert (ksf.LAUNCHES["relax_fused_sweep"] > 0) == fused_sweep, \
        ksf.LAUNCHES
    assert kt.LAUNCHES["color_update_bf16"] == 0
    assert ksf.LAUNCHES["relax_fused_sweep_bf16"] == 0
    assert info.res <= 1e-11
    # the same solve on the CPU (plain versions) gives the same history
    mc = NHModel(n, n, n, cfg=SolverConfig(), device="cpu")
    mc.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    _, _, _, pc, ic = mc.solve(*initial_velocities(n, n, n, device="cpu"),
                               tol=1e-11, maxiter=12)
    np.testing.assert_allclose(info.history, ic.history, rtol=1e-6,
                               atol=1e-15)
    if fused_sweep:
        # one K4 launch per sweep: as many as the sweeps the CPU takes on
        # the same route (pallas_interpret=True, K4's plain version)
        sweeps = []
        plain = ksf.relax_fused_sweep_plain

        def count(q0, bq, pack, nsweeps):
            sweeps.append(nsweeps)
            return plain(q0, bq, pack, nsweeps)

        ksf.relax_fused_sweep_plain = count
        try:
            mi = NHModel(n, n, n, cfg=SolverConfig(pallas_interpret=True),
                         device="cpu")
            mi.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                            theta_b=c.theta_b, theta_s=c.theta_s)
            _, _, _, _, ii = mi.solve(*initial_velocities(n, n, n,
                                                          device="cpu"),
                                      tol=1e-11, maxiter=12)
        finally:
            ksf.relax_fused_sweep_plain = plain
        assert ii.niter == info.niter
        assert ksf.LAUNCHES["relax_fused_sweep"] == sum(sweeps), sweeps


def _full_inputs(nz, ny, nx, dtype, device, seed):
    """Random bands with a dominant diagonal (a well-conditioned Thomas
    solve), state and RHS of a full-layout level."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda *sh: torch.rand(sh, generator=g, device=device, dtype=dtype)
    cA = 0.2 * u(8, nz, ny + 2, nx + 2) - 0.1
    cA[0] -= 4.0
    return cA, 2 * u(nz, ny, nx) - 1, 2 * u(nz, ny, nx) - 1


# (shape, sweeps): the coarsest levels of seamount 64^3 and CUC in the
# one-block form, seamount level 3 (RB, FC one block; GS the step form),
# CUC level 4 in the cluster form (GS and float64: the step form), CUC
# level 3 and a 64^3 level in the per-colour-step form, ragged ones
K6_CASES = [((4, 4, 4), 40), ((2, 32, 32), 40), ((8, 8, 8), 3),
            ((4, 64, 64), 3), ((8, 128, 128), 3), ((64, 64, 64), 3),
            ((3, 5, 7), 3), ((1, 6, 5), 2)]


def _k6_launches(p, kind, ns):
    """The LAUNCHES key and count one gated K6 call of ``p`` adds."""
    key = kf.launch_name(p, kind)
    return key, (kf.KINDS[kind].ncolor * ns
                 if kf.form(p.shape, p.dtype, kind) == "step" else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", K6_CASES)
@pytest.mark.parametrize("real", [True, False])
def test_fused_relax_matches_plain(cuda, case, dtype, real):
    """K6 RB in the form the gate names: 0 ulp, p unwritten, counted under
    the form's name."""
    shape, ns = case
    cA, p, b = _full_inputs(*shape, dtype, cuda, seed=sum(shape))
    p0 = p.clone()
    before = dict(kf.LAUNCHES)
    got = kf.fused_relax(p, b, cA, ns, "RB", real)
    want = kf.fused_relax_plain(p, b, cA, ns, "RB", real)
    torch.cuda.synchronize()
    assert torch.equal(p, p0)
    assert _maxdiff(got, want) == 0.0
    key, n = _k6_launches(p, "RB", ns)
    assert {k: v - before[k] for k, v in kf.LAUNCHES.items()} == {
        k: (n if k == key else 0) for k in kf.LAUNCHES}


# the CUC level-0 shape in float32, two ragged shapes in both types
K5_CASES = ([((64, 1024, 1024), torch.float32)]
            + [(s, t) for s in ((3, 5, 7), (8, 16, 33))
               for t in (torch.float32, torch.float64)])


@pytest.mark.parametrize("case", K5_CASES)
@pytest.mark.parametrize("real", [True, False])
def test_residual_tiled_matches_plain(cuda, case, real):
    shape, dtype = case
    cA, p, b = _full_inputs(*shape, dtype, cuda, seed=sum(shape))
    pe = extend_h1(p).contiguous()
    before = ks.LAUNCHES["residual_tiled"]
    got = ks.residual_tiled(pe, b, cA, real)
    want = ks.residual_tiled_plain(pe, b, cA, real)
    torch.cuda.synchronize()
    assert _maxdiff(got, want) == 0.0
    assert ks.LAUNCHES["residual_tiled"] == before + 1


def test_full_layout_wrappers_reject_bad_input(cuda):
    cA, p, b = _full_inputs(3, 4, 5, torch.float32, cuda, seed=0)
    pe = extend_h1(p).contiguous()
    for bad in (dict(b=b.double()), dict(cA=cA.cpu()), dict(cA=cA[:, :, 1:]),
                dict(b=torch.empty((3, 5, 4), device=cuda).transpose(1, 2))):
        args = {"p": p, "b": b, "cA": cA, **bad}
        with pytest.raises(ValueError):
            kf.fused_relax(args["p"], args["b"], args["cA"], 1, "RB", True)
        with pytest.raises(ValueError):
            ks.residual_tiled(pe, args["b"], args["cA"], True)
    with pytest.raises(ValueError, match="unknown relax kind"):
        kf.fused_relax(p, b, cA, 1, "XY", True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", K6_CASES)
@pytest.mark.parametrize("kind", ["FC", "GS"])
def test_fused_relax_orderings_match_plain(cuda, case, kind, dtype):
    """K6's four-colour and column-Jacobi orderings in the form the gate
    names, with and without 'real': 0 ulp, the inputs unwritten, each
    counted under its own name (ncolor launches a sweep in the
    per-colour-step form, one a call in the others)."""
    shape, ns = case
    cA, p, b = _full_inputs(*shape, dtype, cuda, seed=sum(shape) + 1)
    p0 = p.clone()
    for real in (True, False):
        before = dict(kf.LAUNCHES)
        got = kf.fused_relax(p, b, cA, ns, kind, real)
        want = kf.fused_relax_plain(p, b, cA, ns, kind, real)
        torch.cuda.synchronize()
        assert torch.equal(p, p0)
        assert _maxdiff(got, want) == 0.0
        key, n = _k6_launches(p, kind, ns)
        assert {k: v - before[k] for k, v in kf.LAUNCHES.items()} == {
            k: (n if k == key else 0) for k in kf.LAUNCHES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 5, 33), (4, 9, 70), (2, 1, 1),
                                   (5, 2, 3), (1, 6, 5)])
@pytest.mark.parametrize("kind", ["RB", "FC", "GS"])
@pytest.mark.parametrize("form", ["step", "block", "cluster"])
def test_fused_relax_step_form_matches_plain(cuda, form, shape, kind,
                                             dtype):
    """Each of K6's forms (forced at every shape, whatever the gate says)
    in each ordering, with and without 'real', at widths that are not a
    multiple of the step form's 32-column rows and on levels whose every
    column is an edge or a corner (the edge-copy halo reads the column
    itself): 0 ulp, p, b and cA unwritten, ncolor launches a sweep in the
    per-colour-step form, one a call in the others; a cluster the kernel
    does not take (not float32 at nz 2 or 4) raises, nothing launched."""
    cA, p, b = _full_inputs(*shape, dtype, cuda, seed=sum(shape) + 2)
    inputs = tuple(x.clone() for x in (p, b, cA))
    name = kf.KINDS[kind].name(form)
    for real in (True, False):
        before = kf.LAUNCHES[name]
        if form == "cluster" and not kf.cluster_takes(shape, dtype):
            with pytest.raises(RuntimeError, match="launch failed"):
                kf.fused_relax_form(p, b, cA, 3, kind, real, form)
            assert kf.LAUNCHES[name] == before
            continue
        got = kf.fused_relax_form(p, b, cA, 3, kind, real, form)
        want = kf.fused_relax_plain(p, b, cA, 3, kind, real)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(inputs, (p, b, cA)))
        assert torch.equal(got, want)
        assert kf.LAUNCHES[name] == before + (
            3 * kf.KINDS[kind].ncolor if form == "step" else 1)


# the one-launch forms at the gate's edges, forced: the largest one-block
# shapes (1024 threads; the last shared-memory plane), nz 1; the cluster
# form at the smallest clusters (two rows), CUC level 4 (16 blocks) and
# ragged widths, and where it refuses the level (records not in
# registers: nz 1 or 3, CUC level 3, seamount levels 2 and 1; every
# float64 level)
K6_EDGES = [("block", (2, 32, 32)), ("block", (1, 32, 63)),
            ("block", (5, 16, 31)), ("block", (8, 8, 8)),
            ("cluster", (3, 2, 9)), ("cluster", (1, 17, 5)),
            ("cluster", (4, 64, 64)), ("cluster", (8, 128, 128)),
            ("cluster", (16, 16, 16)), ("cluster", (32, 32, 32)),
            ("cluster", (2, 40, 33)), ("cluster", (4, 2, 9)),
            ("cluster", (2, 17, 5))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", K6_EDGES)
@pytest.mark.parametrize("kind", ["RB", "FC", "GS"])
def test_fused_relax_one_launch_edges(cuda, case, kind, dtype):
    """K6's one-launch forms at the gate's edges, every ordering, with
    and without 'real', 2 sweeps: 0 ulp from the plain version, one launch
    a call; the cluster form runs 16 blocks (8 where 16 cannot be
    resident), or ny where fewer rows, and a level it does not take
    raises with nothing launched."""
    form, shape = case
    cA, p, b = _full_inputs(*shape, dtype, cuda, seed=sum(shape) + 3)
    for real in (True, False):
        plan = {}
        if form == "cluster" and not kf.cluster_takes(shape, dtype):
            before = dict(kf.LAUNCHES)
            with pytest.raises(RuntimeError, match="launch failed"):
                kf.fused_relax_form(p, b, cA, 2, kind, real, form, plan)
            assert kf.LAUNCHES == before and plan == {}
            continue
        got = kf.fused_relax_form(p, b, cA, 2, kind, real, form, plan)
        want = kf.fused_relax_plain(p, b, cA, 2, kind, real)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (plan, _maxdiff(got, want))
        want_blocks = (1,) if form == "block" else (min(16, shape[1]),
                                                    min(8, shape[1]))
        assert plan["blocks"] in want_blocks, plan


def test_fused_relax_refused_launch_raises(cuda):
    """A one-launch form that cannot hold the level raises (no fallback
    to the step form): the CUC level-0 shape in a cluster, a 64^3 level
    in one block, and the cluster form where its records would not sit in
    registers: CUC level 3, and level 4 in float64."""
    for form, shape, dtype in (("cluster", (64, 1024, 1024), torch.float32),
                               ("block", (64, 64, 64), torch.float32),
                               ("cluster", (8, 128, 128), torch.float32),
                               ("cluster", (4, 64, 64), torch.float64)):
        cA, p, b = _full_inputs(*shape, dtype, cuda, seed=5)
        before = dict(kf.LAUNCHES)
        for kind in kf.KINDS:
            with pytest.raises(RuntimeError, match="launch failed"):
                kf.fused_relax_form(p, b, cA, 1, kind, True, form)
        assert kf.LAUNCHES == before
        del cA, p, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(6, 5, 7), (2, 1, 1), (3, 5, 33),
                                   (4, 3, 70), (64, 8, 128)])
@pytest.mark.parametrize("layout", ["bands", "blocks"])
def test_fc_sweep_of_single_targets_matches_plain(cuda, shape, dtype,
                                                  layout):
    """The FC route: K1 on one target quad a colour, four colours a sweep,
    equals the plain FC quad sweep bit for bit, on either operator
    layout; the RB route (a launch per colour of two targets) too."""
    nz, H, W = shape
    pack, e, bq = _inputs(nz, H, W, dtype, cuda, True, sum(shape), layout)
    q = {k: v[:, 1:-1, 1:-1].contiguous() for k, v in e.items()}
    for kind, per_sweep in (("FC", 4), ("RB", 2)):
        before = kt.LAUNCHES["color_update"]
        got = kt.relax_compact_tiled_quads(q, bq, pack, 2, kind=kind)
        want = rc.relax_compact_quads(q, bq, pack, 2, kind, True)
        torch.cuda.synchronize()
        assert kt.LAUNCHES["color_update"] == before + 2 * per_sweep
        for k in rc._TKEYS:
            assert torch.equal(got[k], want[k]), (kind, k)


@pytest.mark.parametrize("compact", [True, False])
def test_use_pallas_solve_equals_default(cuda, compact):
    """use_pallas=True on the card: K6 runs (on every level with
    compact=False, where K1-K3 do not), and the history equals the
    default solve's on the card."""
    from mgroms_tpu_torch import NHModel, SolverConfig
    from mgroms_tpu_torch.cases.seamount import (initial_velocities,
                                                 setup_seamount)
    n = 16
    c = setup_seamount(n, n, n)
    hist = []
    for use_pallas in (False, True):
        m = NHModel(n, n, n, cfg=SolverConfig(dtype="float32",
                                              use_pallas=use_pallas,
                                              compact=compact), device=cuda)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        kf.reset_launches()
        kt.reset_launches()
        *_, info = m.solve(*initial_velocities(n, n, n, dtype=m.dtype,
                                               device=cuda),
                           tol=1e-5, maxiter=4)
        hist.append(info.history)
        k6 = sum(kf.LAUNCHES.values())
        assert (k6 > 0) == use_pallas, kf.LAUNCHES
        assert (kf.LAUNCHES["fused_relax"] > 0) == use_pallas, kf.LAUNCHES
        if not compact:
            assert sum(kt.LAUNCHES.values()) == 0, kt.LAUNCHES
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-6, atol=0)


def _sweep_inputs(nz, H, W, dtype, device, real, seed, lp):
    """A random pack (with the low-precision operator when ``lp``: on
    float32 state beside the gather blocks, on float64 state as a float64
    K4 level holds it, the band stack and its bfloat16 copy only), raw
    state quads and RHS quads."""
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, 2 * H + 2, 2 * W + 2))
    cA[0] -= 4.0
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    if lp and dtype == torch.float64:
        pack = rc.attach_lp(rc.build_band_pack(t(cA), real))
    else:
        pack = rc.build_compact_pack(t(cA), real)
        if lp:
            pack = rc.attach_lp(pack)
        pack = rc.attach_bands(pack, t(cA))
    q = rc.split_quads(t(rng.standard_normal((nz, 2 * H, 2 * W))))
    bq = rc.split_quads(t(rng.standard_normal((nz, 2 * H, 2 * W))))
    return pack, q, bq


# quads: ragged, nz = 2, one column, the smallest the wrapper takes
# (nz 2, H = W = 1), a one-block grid, a W that is not a multiple of the
# 32-column tile (33, 70; 520 over many tiles), the full 64 planes a block's
# shared memory is sized for, and a level whose tiles outnumber the
# resident blocks (the grid-stride loops wrap)
K4_SHAPES = [(6, 5, 7), (2, 3, 4), (3, 1, 1), (2, 1, 1), (8, 16, 33),
             (64, 8, 128), (64, 13, 70), (2, 512, 520)]
# (state dtype, low-precision bands): K8's instances; K4 has a (float64,
# bfloat16) one too
BANDS = [(torch.float32, False), (torch.float64, False),
         (torch.float32, True)]
K4_BANDS = BANDS + [(torch.float64, True)]


@pytest.mark.parametrize("band", K4_BANDS, ids=["f32", "f64", "bf16",
                                                "f64-bf16"])
@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("real", [True, False])
def test_sweep_fused_matches_plain(cuda, shape, band, real):
    """K4 == its plain version to 0 ulp, one launch per sweep counted under
    its instance's key, its inputs untouched."""
    dtype, lp = band
    pack, q, bq = _sweep_inputs(*shape, dtype, cuda, real, sum(shape), lp)
    q0 = {k: x.clone() for k, x in q.items()}
    key = ksf.ENTRIES[(dtype, torch.bfloat16 if lp else dtype)][1]
    before = ksf.LAUNCHES[key]
    got = ksf.relax_fused_sweep(q, bq, pack, 2)
    want = ksf.relax_fused_sweep_plain(q, bq, pack, 2)
    torch.cuda.synchronize()
    assert ksf.LAUNCHES[key] == before + 2
    for t in rc._TKEYS:
        assert torch.equal(q[t], q0[t])
        assert _maxdiff(got[t], want[t]) == 0.0


def test_sweep_term_recipe_matches_python(cuda):
    """K4's compiled term recipe equals sweep_fused.band_term_table, which
    the CPU tests hold to the gather blocks and to JAX's band reads."""
    for t in rc._TKEYS:
        assert ksf.compiled_term_table(t) == ksf.band_term_table(t), t


@pytest.mark.parametrize("shape", [(6, 5, 7), (2, 1, 1), (3, 5, 33),
                                   (4, 3, 70), (64, 8, 128), (64, 32, 32),
                                   (880, 1, 3)])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("layout", ["bands", "blocks"])
def test_bf16_color_update_matches_plain(cuda, shape, real, layout):
    """K1 reading the low-precision operator (the bfloat16 band stack or
    bfloat16 blocks) == its plain version to 0 ulp, a colour a launch,
    and over two sweeps of the K1 orchestration."""
    pack, q, bq = _sweep_inputs(*shape, torch.float32, cuda, real,
                                sum(shape), True)
    if layout == "blocks":
        pack = pack._replace(ebands=None, lp=pack.lp._replace(ebands=None))
    else:
        pack = pack._replace(blocks=None, rblocks=None, lp=pack.lp._replace(
            blocks=None, rblocks=None))
    assert kt.colour_operator(pack, torch.float32)[0] == layout
    e = rc.extend_quads(q)
    for colour in COLOURS:
        before = kt.LAUNCHES["color_update_bf16"]
        got = kt.color_update(e, bq, pack, colour)
        want = kt.color_update_plain(e, bq, pack, colour)
        torch.cuda.synchronize()
        assert kt.LAUNCHES["color_update_bf16"] == before + 1
        for t in colour:
            assert torch.equal(got[t], want[t]), (colour, t)
    got = kt.relax_compact_tiled_quads(q, bq, pack, 2)
    want = rc.relax_compact_quads(q, bq, pack, 2, "RB", real)
    for t in rc._TKEYS:
        assert torch.equal(got[t], want[t])


def test_no_instance_raises_before_launch(cuda):
    """K1 has no (float64, bfloat16) instance: on a float64 K4 level's
    pack (the bfloat16 stack and float64 pivots) it raises, nothing
    launched, where K4 takes the same pack."""
    pack, q, bq = _sweep_inputs(4, 3, 70, torch.float64, cuda, True, 0,
                                True)
    before = dict(kt.LAUNCHES)
    with pytest.raises(ValueError, match="no instance"):
        kt.color_update(rc.extend_quads(q), bq, pack, ((0, 0), (1, 1)))
    assert kt.LAUNCHES == before
    ksf.relax_fused_sweep(q, bq, pack, 1)
    torch.cuda.synchronize()


def test_sweep_wrapper_rejects_bad_input(cuda):
    pack, q, bq = _sweep_inputs(4, 3, 5, torch.float32, cuda, True, 0, True)
    nc = torch.empty((4, 5, 3), device=cuda).transpose(1, 2)
    bad_q = ({**q, (0, 1): q[(0, 1)].double()},      # dtype
             {**q, (1, 0): q[(1, 0)].cpu()},         # device
             {**q, (1, 1): nc})                      # not contiguous
    for qb in bad_q:
        with pytest.raises(ValueError):
            ksf.relax_fused_sweep(qb, bq, pack, 1)
    # low-precision blocks in the pack's full-precision slots come without
    # their consistent pivots
    no_pivots = pack._replace(blocks=pack.lp.blocks,
                              rblocks=pack.lp.rblocks, lp=None)
    for bad in (no_pivots, pack._replace(lp=pack.lp._replace(bet=None))):
        with pytest.raises(ValueError):
            ksf.relax_fused_sweep(q, bq, bad, 1)
        with pytest.raises(ValueError):
            kt.relax_compact_tiled_quads(q, bq, bad, 1)
    # K4 reads the band stack: a pack without it, with bands of the
    # full-precision type beside the low-precision pivots, or with rows
    # not at the stack's padded pitch, is refused
    for bad in (pack._replace(lp=pack.lp._replace(ebands=None)),
                pack._replace(lp=pack.lp._replace(
                    ebands=pack.lp.ebands.float())),
                pack._replace(lp=pack.lp._replace(
                    ebands=pack.lp.ebands.contiguous()))):
        with pytest.raises(ValueError):
            ksf.relax_fused_sweep(q, bq, bad, 1)
    # K2, the emitting form, reads the true operator: low-precision blocks
    # in the pack's full-precision slots are refused
    e = rc.extend_quads(q)
    with pytest.raises(ValueError):
        kt.color_update_emit(e, bq, no_pivots._replace(ebands=None),
                             ((0, 0), (1, 1)))


# ------------------------------------------------------- K8, K9 and K10

from mgroms_tpu_torch.ops.kernels import roofline as rl          # noqa: E402
from mgroms_tpu_torch.ops.kernels import sweep_packed as sp      # noqa: E402

# (quad shape, tj, nchunks): ragged plans with several tiles, column
# windows and chunks, one-row tiles, one-column chunks, nz = 2, chunks
# wider than one window with a ragged last window (Wc 50 and 70 against
# the 16-column window, 70 against float64's 8, and two chunks of 20)
K8_PLANS = [((3, 6, 18), 2, 3), ((2, 4, 6), 1, 6), ((5, 8, 8), 8, 1),
            ((4, 12, 100), 3, 2), ((64, 16, 70), 8, 1),
            ((16, 16, 40), 8, 2)]


@pytest.mark.parametrize("band", BANDS, ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("case", K8_PLANS)
@pytest.mark.parametrize("real", [True, False])
def test_sweep_packed_matches_plain(cuda, case, band, real):
    """K9 (both modes) and K8 == their plain versions to 0 ulp on every
    chunk; two sweeps of relax_packed_sweep == the plain RB sweep."""
    dtype, lp = band
    (nz, H, W), tj, C = case
    pack, q, bq = _sweep_inputs(nz, H, W, dtype, cuda, real, sum(case[0]),
                                False)
    rng = np.random.default_rng(sum(case[0]))
    cA = torch.tensor(rng.uniform(-0.1, 0.1, (8, nz, 2 * H + 2, 2 * W + 2)),
                      dtype=dtype, device=cuda)
    cA[0] -= 4.0
    pack = rc.build_compact_pack(cA, real)
    sop = sp.build_sweep_operator(cA, pack, nz, H, W, tj=tj, nchunks=C,
                                  band_dtype=torch.bfloat16 if lp else None)
    before = dict(sp.LAUNCHES)
    pbq, pqs = sp.pack_rhs(bq, tj, C)
    psts = sp.pack_state(q, tj, C)
    full = tuple(sp._pad_rows(bq[t], 1, H + 2) for t in sp._PTARGETS)
    for got, want in zip(pbq, sp.pack_streams_plain(full, tj, tj + 2, W // C,
                                                    0, C)):
        assert torch.equal(got, want)
    se = tuple(sp._pad_cols(sp._pad_rows(bq[t], 1, H + 2), 1)
               for t in sp._COLOR0)
    for got, want in zip(pqs, sp.pack_streams_plain(se, tj, tj + 2, W // C,
                                                    -2, C)):
        assert torch.equal(got, want)
    for c in range(C):
        args = (psts[c], sop.pband[c], sop.ppiv[c], sop.pseam[c], pbq[c],
                pqs[c], tj, nz, real, c == 0, c == C - 1)
        got = sp.sweep_chunk(*args)
        want = sp.sweep_chunk_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _maxdiff(g, w) == 0.0
    key = "sweep_packed_bf16" if lp else "sweep_packed"
    assert sp.LAUNCHES[key] == before[key] + C
    assert sp.LAUNCHES["pack_streams"] == before["pack_streams"] + 3
    got = sp.relax_packed_sweep(q, bq, pack, sop, 2)
    want = rc.relax_compact_quads(q, bq, rc.attach_lp(pack) if lp else pack,
                                  2, "RB", real)
    for t in rc._TKEYS:
        assert _maxdiff(got[t], want[t]) == 0.0


def test_sweep_packed_wrappers_reject_bad_input(cuda):
    nz, H, W, tj, C = 3, 4, 6, 2, 2
    pack, q, bq = _sweep_inputs(nz, H, W, torch.float32, cuda, True, 0, False)
    cA = torch.rand((8, nz, 2 * H + 2, 2 * W + 2), device=cuda) - 4.0
    sop = sp.build_sweep_operator(cA, pack, nz, H, W, tj=tj, nchunks=C)
    pbq, pqs = sp.pack_rhs(bq, tj, C)
    psts = sp.pack_state(q, tj, C)
    args = [psts[0], sop.pband[0], sop.ppiv[0], sop.pseam[0], pbq[0], pqs[0]]
    nc = lambda x: x.transpose(2, 3).contiguous().transpose(2, 3)
    for i, bad in ((0, lambda x: x.double()),          # dtype
                   (1, lambda x: x.to(torch.bfloat16).double()),
                   (2, nc),                            # not contiguous
                   (4, lambda x: x[:, :, 1:]),         # shape
                   (3, lambda x: x.cpu())):            # device
        a = list(args)
        a[i] = bad(a[i])
        with pytest.raises((ValueError, TypeError)):
            sp.sweep_chunk(*a, tj, nz, True, True, False)
    with pytest.raises(ValueError):                    # H % tj != 0
        sp.build_sweep_operator(cA, pack, nz, H, W, tj=3, nchunks=C)
    q3 = {k: v[:, :3].contiguous() for k, v in q.items()}
    with pytest.raises(ValueError):
        sp.relax_packed_sweep(q3, q3, pack, sop, 1)
    with pytest.raises(ValueError):
        sp.pack_streams((bq[(0, 0)], bq[(0, 1)].double()), 2, 3, 3, 0, 2)
    with pytest.raises(ValueError):
        sp.pack_streams((nc(psts[0]),), 2, 3, 3, 0, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["main", "seam"])
def test_pack_streams_vector_edges(cuda, dtype, mode):
    """K9 with 3 chunks of an odd width over rows whose pitch (Wp = 3 Wc +
    7 values) breaks 16-byte alignment: every output row meets the vector
    copies' misaligned head and tail, or none; exactly its plain version
    in both modes."""
    nz, tj, Wc, C = 3, 2, 13, 3
    rows = tj + 4 if mode == "main" else tj + 2
    wpad = 4 if mode == "main" else -2
    g = torch.Generator(device=cuda).manual_seed(7)
    arrs = tuple(torch.rand((nz, 4 * tj + rows - tj, C * Wc + 7),
                            generator=g, device=cuda, dtype=dtype)
                 for _ in range(3))
    before = sp.LAUNCHES["pack_streams"]
    got = sp.pack_streams(arrs, tj, rows, Wc, wpad, C)
    want = sp.pack_streams_plain(arrs, tj, rows, Wc, wpad, C)
    torch.cuda.synchronize()
    assert sp.LAUNCHES["pack_streams"] == before + 1
    assert len(got) == C
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("band", BANDS, ids=["f32", "f64", "bf16"])
def test_sweep_packed_launch_plan_matches_window_plan(cuda, band):
    """The launcher's plan (mg_sweep_packed_plan) at the window
    sweep_packed.window_plan chooses has the threads and the shared
    memory window_plan reckons, at the CUC level-0 and level-1 default
    plans and at small ones, with at least one block resident per SM."""
    dtype, lp = band
    bd = torch.bfloat16 if lp else dtype
    isz, bsz = torch.empty((), dtype=dtype).element_size(), \
        torch.empty((), dtype=bd).element_size()
    for nz, tj, Wc in ((64, 8, 512), (32, 8, 256), (64, 8, 70), (2, 1, 1),
                       (5, 3, 50)):
        got = sp.launch_plan(nz, tj, Wc, dtype, bd)
        want = sp.window_plan(nz, tj, Wc, isz, bsz)
        assert (got["window"], got["threads"], got["smem_bytes"]) == \
            (want["window"], want["threads"], want["smem_bytes"])
        assert got["blocks_per_sm"] >= 1


@pytest.mark.parametrize("band", BANDS, ids=["f32", "f64", "bf16"])
def test_sweep_packed_launcher_refuses_another_layout(cuda, band):
    """The launcher refuses a shared-memory size other than its own
    layout's at the chosen window, a window wider than the chunk and one
    that does not fit, and takes the chosen pair."""
    from mgroms_tpu_torch.ops.kernels import _build
    dtype, lp = band
    bd = torch.bfloat16 if lp else dtype
    isz, bsz = torch.empty((), dtype=dtype).element_size(), \
        torch.empty((), dtype=bd).element_size()
    inst = list(sp.PACKED_ENTRIES).index((dtype, bd))
    nz, tj, Wc = 64, 8, 512
    plan = sp.window_plan(nz, tj, Wc, isz, bsz)
    wn, smem = plan["window"], plan["smem_bytes"]
    big = sp.window_layout(nz, tj, 2 * wn, isz, bsz)["smem_bytes"]
    fn = _build.load().mg_sweep_packed_plan
    out = (ctypes.c_int * 3)()
    assert fn(inst, nz, tj, Wc, wn, smem, out) == 0
    for w, b in ((wn, smem + 16), (wn, smem - 16), (Wc + 1, smem),
                 (2 * wn, big)):
        assert fn(inst, nz, tj, Wc, w, b, out) != 0, (w, b)


def test_sweep_packed_refuses_a_plan_no_window_holds(cuda):
    """nz 8000: the colour-0 columns overflow shared memory even one
    column wide, so sweep_chunk raises ValueError before any launch."""
    nz, tj, Wc = 8000, 1, 1
    z = lambda *s: torch.zeros(s, device=cuda)
    args = (z(1, 4 * nz, tj + 4, Wc + 4), z(1, 24 * nz, tj + 4, Wc + 3),
            z(1, 12 * nz, tj + 2, Wc), z(1, 6 * nz, tj + 2, 2),
            z(1, 4 * nz, tj + 2, Wc), z(1, 2 * nz, tj + 2, 2))
    before = dict(sp.LAUNCHES)
    with pytest.raises(ValueError, match="no window"):
        sp.sweep_chunk(*args, tj, nz, True, True, True)
    assert sp.LAUNCHES == before


# ragged (H, W) against the windows' 8 x 32 block tile, nz 1 and 2
@pytest.mark.parametrize("shape", [(5, 6, 40), (64, 512, 512), (2, 9, 33),
                                   (3, 17, 70), (1, 5, 7), (2, 1, 1)])
@pytest.mark.parametrize("which", rl.WHICH)
def test_dma_only_matches_plain(cuda, shape, which):
    """dma_only == its plain version exactly, with and without gam and
    the 'real' pair, and on bfloat16 blocks (float32 and bfloat16
    ``all`` and ``windows`` stage the windows through the ring)."""
    nz, H, W = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    f = lambda *s: torch.rand(s, generator=g, device=cuda) + 0.5
    e3 = tuple(f(nz, H + 2, W + 2) for _ in range(3))
    ops = (f(nz, H, W), f(nz, H, 12 * W), f(nz - 1, H, W), f(nz, H, W))
    gam, rb = f(nz - 1, H, W), f(1, H, 2 * W)
    b16 = ops[1].to(torch.bfloat16)
    for gm, r, blk in ((None, None, ops[1]), (gam, rb, ops[1]),
                       (None, rb.to(torch.bfloat16), b16)):
        a = (e3, ops[0], blk, *ops[2:], gm, which, r)
        before = rl.LAUNCHES["dma_only"]
        got = rl.dma_only(*a)
        want = rl.dma_only_plain(*a)
        torch.cuda.synchronize()
        assert rl.LAUNCHES["dma_only"] == before + 1
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        rl.dma_only(e3, ops[0].double(), *ops[1:], None, which)


@pytest.mark.parametrize("shape", [(6, 5, 7), (2, 1, 1), (3, 5, 70),
                                   (64, 32, 32)])
@pytest.mark.parametrize("lp", [False, True])
def test_dma_only_bands_matches_plain(cuda, shape, lp):
    """dma_only_bands == its plain version exactly on both RB colours, on
    the float32 and the bfloat16 band stack, one launch each; it refuses
    a pack without the stack and an FC colour."""
    from mgroms_tpu_torch.scripts import micro_colour_update as mcu
    pack, e, bq = mcu.inputs(cuda, *shape, lp=lp, seed=sum(shape))
    for colour in rc.colour_targets("RB"):
        before = rl.LAUNCHES["dma_only"]
        got = rl.dma_only_bands(e, bq, pack, colour)
        want = rl.dma_only_bands_plain(e, bq, pack, colour)
        torch.cuda.synchronize()
        assert rl.LAUNCHES["dma_only"] == before + 1
        for t in colour:
            assert torch.equal(got[t], want[t]), (colour, t)
    with pytest.raises(ValueError):
        rl.dma_only_bands(e, bq, pack, rc.colour_targets("FC")[0])
    nob = pack._replace(ebands=None, lp=pack.lp._replace(ebands=None)
                        if lp else None)
    with pytest.raises(ValueError):
        rl.dma_only_bands(e, bq, nob, rc.colour_targets("RB")[0])


def test_fma_run_within_tolerance(cuda):
    """fma_run (one rounding per FMA) against its float64 plain version
    within roofline.FMA_RTOL x max|plain|."""
    x = torch.rand(rl.FMA_BLOCK, device=cuda) + 0.5
    got = rl.fma_run(x)
    want = rl.fma_run_plain(x)
    torch.cuda.synchronize()
    assert _maxdiff(got, want) <= rl.FMA_RTOL * float(want.abs().max())
    with pytest.raises(ValueError):
        rl.fma_run(x.double())


# ---------------------------------------------- K7 and the distributed path

def _k7_run(mesh, p, b, cA, real, fn):
    from mgroms_tpu_torch.parallel import mesh as tmesh
    npx = mesh.shape[1]
    tl = lambda a, extra=(0, 0): tmesh.split_tiles(a, (1, npx),
                                                   mesh.devices, extra)
    r = tmesh.shard_map(lambda p_l, b_l, c_l: fn(p_l, b_l, c_l, real),
                        mesh)(tl(p), tl(b), tl(cA, (2, 2)))
    return tmesh.join_tiles(r, p.device)


# (nz, ny, npx, nx): down to two columns a tile; ragged tiles against
# K7's 16 x 32 block tile (33 and 70 columns a tile, 7, 9 and 17 rows, nz
# 1 and 2); (3, 9, 3, 96): each tile exactly one block wide, the middle
# one staging both seam columns in the same block
K7_SHAPES = [(5, 7, 1, 8), (5, 7, 2, 4), (5, 7, 3, 6), (5, 7, 4, 8),
             (5, 7, 4, 64), (2, 7, 2, 66), (1, 9, 2, 140), (2, 9, 3, 99),
             (1, 7, 1, 70), (2, 9, 4, 280), (3, 9, 3, 96), (2, 17, 2, 66),
             (1, 33, 3, 210)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,ny,npx,nx", K7_SHAPES)
@pytest.mark.parametrize("real", [True, False])
def test_overlap_residual_matches_plain(cuda, nz, ny, npx, nx, dtype, real):
    """K7 on a virtual (1, npx) mesh on one card, down to two columns a
    tile and at ragged tiles: 0 ulp from its plain version and from K5 on
    the whole grid."""
    from mgroms_tpu_torch.ops.kernels import rdma_halo as k7
    from mgroms_tpu_torch.parallel import mesh as tmesh
    cA, p, b = _full_inputs(nz, ny, nx, dtype, cuda, seed=nx + npx)
    mesh = tmesh.make_mesh(npx, 1, [cuda] * npx)
    k7.reset_launches()
    got = _k7_run(mesh, p, b, cA, real, k7.residual_overlap_x)
    assert k7.LAUNCHES["residual_overlap_x"] == npx
    want = _k7_run(mesh, p, b, cA, real, k7.residual_overlap_x_plain)
    assert torch.equal(got, want)
    assert torch.equal(got, ks.residual_tiled(extend_h1(p).contiguous(), b,
                                              cA, real))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_overlap_plan_matches_python(cuda, dtype):
    """K7's compiled tile and ring are rdma_halo.TILE and RING, its blocks
    those of block_order, and shared memory lets 2 float32 blocks (1,024
    threads; 1 float64) share an SM."""
    from mgroms_tpu_torch.ops.kernels import rdma_halo as k7
    plan = k7.launch_plan(1024, 256, dtype)
    assert plan["tile"] == k7.TILE and plan["ring"] == k7.RING
    assert plan["blocks"] == len(k7.block_order(1024, 256))
    assert plan["per_sm"] >= (2 if dtype == torch.float32 else 1), plan


def test_overlap_residual_refuses_missing_peer_access(cuda, monkeypatch):
    """A neighbour tile on another card without peer access raises (no
    staging through the host); on the CPU it is refused outright."""
    from mgroms_tpu_torch.ops.kernels import rdma_halo as k7
    cA, p, b = _full_inputs(2, 3, 4, torch.float32, cuda, seed=1)
    with pytest.raises(ValueError, match="CUDA tiles"):
        k7.residual_overlap_tile(p, b, cA, True, p_west=p.cpu())
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card for a neighbour on another device")
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    with pytest.raises(RuntimeError, match="no peer access"):
        k7.residual_overlap_tile(p, b, cA, True,
                                 p_east=p.to("cuda:1"))


def test_distributed_solve_on_a_virtual_mesh(cuda):
    """Seamount 512 x 32 x 8 f32 on a virtual 2x2 mesh on one card gives
    the single-device iterates (the K1-K3 route) to f32 round-off over 3
    F-cycles.  The sharded levels' tiles are even, so they take the
    single-device compact rule and run K1-K3 per tile.  (This flat grid
    barely converges on one device either; the contract is agreement.)"""
    from mgroms_tpu_torch import NHModel, SolverConfig
    from mgroms_tpu_torch.cases.seamount import (initial_velocities,
                                                 setup_seamount)
    nx, ny, nz = 512, 32, 8
    c = setup_seamount(nx, ny, nz)
    out = []
    for mesh in (None, (2, 2)):
        m = NHModel(nx, ny, nz, cfg=SolverConfig(
            dtype="float32", pallas_fused_sweep=False), device=cuda)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        if mesh:
            m.distribute(*mesh, devices=[cuda] * 4, comm="shard_map")
        kt.reset_launches()
        u, v, w = initial_velocities(nx, ny, nz, dtype=m.dtype, device=cuda)
        uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-6, maxiter=3)
        out.append((p, info, dict(kt.LAUNCHES),
                    float(m.check_nondivergence(uc, vc, wc))))
    (p1, i1, l1, d1), (p2, i2, l2, d2) = out
    assert i2.niter == i1.niter == 3
    assert l2["color_update"] > 0 and l2["color_update_emit"] > 0
    assert l2["residual_restrict"] > 0
    np.testing.assert_allclose(i2.history, i1.history, rtol=1e-3)
    assert float((p2 - p1).abs().max()) <= 1e-4 * float(p1.abs().max())
    assert abs(d2 - d1) <= 1e-3 * d1


# ------------------------------------------------- K11, the load-rate probes

@pytest.mark.parametrize("geom", [(2, 16, 8, 12), (4, 32, 16, 24),
                                  (64, 512, 16, 24)])
def test_dma_probes_match_plain(cuda, geom):
    """Every row of both JAX probe sets, at two small shapes and at the
    JAX script's: 0 ulp from the plain version (the same left-to-right
    sums), one launch each; the library call within 1e-6 relative."""
    from mgroms_tpu_torch.ops.kernels import dma_probe as dp
    from mgroms_tpu_torch.scripts import micro_dma_probe as mdp
    nz, H, tj, ws = geom
    for k, (label, probe, shape, _) in enumerate(mdp.cases(*geom)):
        X = mdp.inputs(shape, cuda, k)
        kern, plain, lib = mdp.calls(probe, X, tj, ws, H)
        before = dict(dp.LAUNCHES)
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), label
        assert sum(dp.LAUNCHES.values()) == sum(before.values()) + 1
        assert _maxdiff(lib(), want) <= 1e-6 * float(want.abs().max())


def test_dma_probes_reject_bad_input(cuda):
    from mgroms_tpu_torch.ops.kernels import dma_probe as dp
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((3, 2, 20, 132), generator=g, device=cuda)
    xs = list(x.unbind(0))
    for bad in ([xs[0], xs[1].double()], [xs[0], xs[1][:, :19]],
                [xs[0], x[1, :, :, :131]]):
        with pytest.raises(ValueError):
            dp.probe_windows(bad, 8, 12, 16)
    with pytest.raises(ValueError):                 # H not a multiple of tj
        dp.probe_windows(xs, 6, 12, 14)
    with pytest.raises(ValueError):                 # window too narrow
        dp.probe_windows([v[:, :, :128].contiguous() for v in xs], 8, 12, 16)
    with pytest.raises(RuntimeError):               # over the kernel's 64
        dp.probe_blocks([torch.rand((2, 16, 128), device=cuda)] * 65, 8)
    with pytest.raises(ValueError):                 # W not 128 lanes wide
        dp.probe_wide_stream(torch.rand((2, 16, 200), device=cuda), 8)


@pytest.mark.parametrize("shape,nsteps", [((2, 32, 32), 80), ((4, 4, 4), 80),
                                          ((4, 64, 64), 6), ((3, 17, 9), 5)])
@pytest.mark.parametrize("cluster", [False, True])
def test_step_floor_matches_plain(cuda, shape, nsteps, cluster):
    """K10's step-floor probe in one block and in a cluster: 0 ulp from
    its plain version, one launch; the cluster of min(16, ny) blocks (8
    where 16 cannot be resident)."""
    from mgroms_tpu_torch.ops.kernels import roofline as rl
    if not cluster and shape[1] * ((shape[2] + 1) // 2) > 1024:
        pytest.skip("one block holds at most 1024 columns of a colour")
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.rand(shape, generator=g, device=cuda) + 0.5
    before = rl.LAUNCHES["step_floor"]
    got, blocks = rl.step_floor(x, nsteps, cluster)
    want = rl.step_floor_plain(x.cpu(), nsteps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert rl.LAUNCHES["step_floor"] == before + 1
    assert blocks in ((min(16, shape[1]), min(8, shape[1])) if cluster
                      else (1,))


# ---- the convergence step as a CUDA graph (capture.py) -----------------

GRAPH_CFGS = {"default": {}, "use_pallas": dict(use_pallas=True),
              "perf": dict(fused_bands_bf16=True, ns_pre=1, ns_post=1)}


def _graph_model(cuda, n=32, **cfg):
    from mgroms_tpu_torch import NHModel, SolverConfig
    from mgroms_tpu_torch.cases.seamount import (initial_velocities,
                                                 setup_seamount)
    m = NHModel(n, n, n, cfg=SolverConfig(dtype="float32", **cfg),
                device=cuda)
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    b = m.rhs(*initial_velocities(n, n, n, dtype=m.dtype, device=cuda))
    return m, b


def _counts():
    from mgroms_tpu_torch.ops.kernels import launches
    return launches()


def _reset_counts():
    from mgroms_tpu_torch.ops.kernels import reset_launches
    reset_launches()


@pytest.mark.parametrize("name", list(GRAPH_CFGS))
def test_replayed_solve_equals_eager(cuda, name):
    """Seamount 32^3 float32 in the default config, with use_pallas and in
    perf mode: the solve that replays its captured step (the first one
    captures it, the second reuses it) equals the eager solve
    (graph=False) bit for bit, history and pressure, and leaves the same
    LAUNCHES counts."""
    m, b = _graph_model(cuda, **GRAPH_CFGS[name])
    _reset_counts()
    pe, ie = m.pressure_solve(b, tol=0.0, maxiter=4, graph=False)
    eager = _counts()
    assert not m.backend.graphs
    for rep in range(2):
        _reset_counts()
        pg, ig = m.pressure_solve(b, tol=0.0, maxiter=4)
        assert len(m.backend.graphs) == 1
        assert ig.niter == ie.niter == 4
        assert ig.history == ie.history, (rep, ig.history, ie.history)
        assert torch.equal(pg, pe), rep
        assert _counts() == eager, rep


@pytest.mark.parametrize("cpc", [1, 2])
def test_device_loop_graph_equals_host_loop(cuda, cpc):
    """device_loop on the card (one graph: a WHILE node around the
    captured step and the condition kernel) and its eager form give the
    host loop's niter, history and pressure, the condition kernel
    launched once a check and once in the prologue."""
    from mgroms_tpu_torch import SolverConfig
    from mgroms_tpu_torch.ops.kernels import device_loop as dl
    from mgroms_tpu_torch.solver import solve_p
    m, b = _graph_model(cuda)
    cfg = SolverConfig(dtype="float32", cycles_per_check=cpc)
    runs = {}
    for key, kw in (("host", dict(device_loop=False)),
                    ("graph", dict(device_loop=True)),
                    ("eager", dict(device_loop=True, graph=False))):
        _reset_counts()
        runs[key] = solve_p(m.backend, b, cfg, tol=1e-5, maxiter=5, **kw)
        runs[key] += (_counts(),)
    p0, i0, c0 = runs["host"]
    assert c0["loop_condition"] == 0
    for key in ("graph", "eager"):
        p, i, c = runs[key]
        assert i.niter == i0.niter and i.history == i0.history, key
        assert torch.equal(p, p0), key
        assert c["loop_condition"] == 1 + i.niter // cpc, (key, c)
        c["loop_condition"] = 0
        assert c == c0, key
    assert dl.LAUNCHES["loop_condition"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_loop_condition_matches_plain(cuda, dtype):
    """The condition kernel == its plain version, exactly: the counter,
    the history slot and the decision, at a NaN residual, at i ==
    maxiter, at res == tol, inside the loop and in the prologue."""
    from mgroms_tpu_torch.ops.kernels import device_loop as dl
    maxiter, cpc = 6, 2
    rsq0 = torch.tensor(1e-8, dtype=dtype)
    res_eq = float(torch.sqrt(rsq0).double())
    for rsq, bnorm, it0, init, tol in (
            (0.0, 0.0, 0, False, 1e-4), (0.0, 0.0, 0, True, 1e-4),
            (4e-6, 1.0, 4, False, 1e-4), (1e-8, 1.0, 0, False, res_eq),
            (2.5e-7, 3.0, 2, False, 1e-4), (2.5e-7, 3.0, 3, True, 1e-4),
            (7.3e-3, 0.37, 1, False, 1e-6)):
        out = []
        for dev in (cuda, torch.device("cpu")):
            t = dict(it=torch.tensor(it0, dtype=torch.int32, device=dev),
                     cont=torch.tensor(9, dtype=torch.int32, device=dev),
                     runs=torch.tensor(3, dtype=torch.int32, device=dev),
                     hist=torch.full((maxiter + cpc,), float("nan"),
                                     dtype=torch.float64, device=dev),
                     lim=torch.tensor([float(maxiter), tol],
                                      dtype=torch.float64, device=dev))
            before = dl.LAUNCHES["loop_condition"]
            dl.loop_condition(torch.tensor(rsq, dtype=dtype, device=dev),
                              torch.tensor(bnorm, dtype=dtype, device=dev),
                              t["it"], t["hist"], t["lim"], cpc, init,
                              t["cont"], t["runs"])
            assert dl.LAUNCHES["loop_condition"] == before + (dev == cuda)
            out.append({k: v.cpu() for k, v in t.items()})
        got, want = out
        assert torch.equal(got["it"], want["it"])
        assert torch.equal(got["cont"], want["cont"])
        assert torch.equal(got["runs"], want["runs"]) and int(got["runs"]) == 4
        assert torch.equal(got["hist"].nan_to_num(-1.0),
                           want["hist"].nan_to_num(-1.0))


def test_use_operators_recaptures(cuda):
    """A backend rebuilt by use_operators captures its own step: the
    solve on it equals the eager solve again."""
    m, b = _graph_model(cuda)
    p0, i0 = m.pressure_solve(b, tol=0.0, maxiter=2)
    old = m.backend
    m.use_operators(m.ops, m.metrics)
    assert m.backend is not old and not m.backend.graphs
    p1, i1 = m.pressure_solve(b, tol=0.0, maxiter=2)
    pe, ie = m.pressure_solve(b, tol=0.0, maxiter=2, graph=False)
    assert len(m.backend.graphs) == 1
    assert i1.history == i0.history == ie.history
    assert torch.equal(p1, pe) and torch.equal(p0, pe)


def test_capture_failure_raises(cuda, monkeypatch):
    """A step that cannot be captured (here: one that reads a value on the
    host) makes the solve raise; nothing falls back to the eager loop."""
    from mgroms_tpu_torch import solver
    m, b = _graph_model(cuda, n=16)
    step_norm = solver.step_norm

    def reads_the_host(be, p, bb, r, cfg):
        out = step_norm(be, p, bb, r, cfg)
        float(out[2])
        return out

    monkeypatch.setattr(solver, "step_norm", reads_the_host)
    with pytest.raises(RuntimeError):
        m.pressure_solve(b, tol=0.0, maxiter=2)
    assert not m.backend.graphs
