"""K3, the residual + restriction of a quad level in one launch, and the
levels that hold their operator only as the band stack, on the CPU.

K3's plain version (ops/kernels/relax_tiled.residual_restrict_plain) is
held to the JAX package's residual_restrict_tiled_quads (its Pallas
``_rr_one`` per target, interpret mode) and to relax_compact.residual_quads
in float64, in both operator layouts; the band-stack plain path is held to
the gather-block one bit for bit; the solver's pack building and K3's
routing are checked on seamount 16^3.  The CUDA kernel (csrc/rr_fused.cu)
is held to this plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerance: 1e-12 x max|JAX| (same term order in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgroms_tpu.ops.pallas.relax_tiled as jtiled
import mgroms_tpu.ops.relax_compact as jrc
from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu_torch import NHModel, SolverConfig, convert
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops import relax_compact as trc
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt

torch.set_num_threads(1)

N = 16


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def problem(nz, ny, nx, seed):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    return (cA, rng.standard_normal((nz, ny, nx)),
            rng.standard_normal((nz, ny, nx)))


def tquads(x):
    return trc.split_quads(torch.from_numpy(x))


def jquads(x):
    return jrc.split_quads(jnp.asarray(x))


BUILD = {"bands": trc.build_band_pack, "blocks": trc.build_compact_pack}


@pytest.mark.parametrize("layout", list(BUILD))
@pytest.mark.parametrize("real", [True, False])
def test_coarse_rhs_matches_pallas(layout, real):
    """The coarse RHS of one launch == JAX's four ``_rr_one`` launches and
    their adds (interpret mode), on two shapes its row tiles take."""
    for shape in ((4, 32, 16), (8, 16, 16)):
        cA, p, b = problem(*shape, seed=sum(shape))
        jp = jrc.build_compact_pack(jnp.asarray(cA), real)
        tp = BUILD[layout](torch.from_numpy(cA), real)
        want = jtiled.residual_restrict_tiled_quads(
            jquads(p), jquads(b), jp, real, interpret=True)
        close(kt.residual_restrict_tiled_quads(tquads(p), tquads(b), tp),
              want)


@pytest.mark.parametrize("layout", list(BUILD))
@pytest.mark.parametrize("real", [True, False])
def test_residual_mode_matches_jax(layout, real):
    """K3's residual mode == JAX's relax_compact.residual_quads, and its
    z-pair mode == one ``_rr_one`` per target (interpret mode)."""
    cA, p, b = problem(8, 16, 16, seed=3)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = BUILD[layout](torch.from_numpy(cA), real)
    want = jrc.residual_quads(jquads(p), jquads(b), jp, real)
    got = kt.residual_tiled_quads(tquads(p), tquads(b), tp)
    assert sorted(got) == sorted(want)
    for t in want:
        close(got[t], want[t])
    je, te = jrc.extend_quads(jquads(p)), trc.extend_quads(tquads(p))
    zs = kt.residual_restrict(tuple(te[k] for k in trc._TKEYS), tquads(b),
                              tp, "zsum", ((0, 0), (1, 1)))
    assert sorted(zs) == [(0, 0), (1, 1)]
    for m, t in enumerate(trc._TKEYS):
        if t in zs:
            close(zs[t], jtiled._rr_one(
                tuple(je[k] for k in jrc._TKEYS), jquads(b)[t], jp.blocks[m],
                jp.d[m], jp.ud[m], t, real, interpret=True,
                rb_t=jp.rblocks[m] if real else None))


@pytest.mark.parametrize("mode", list(kt.RR_MODES))
@pytest.mark.parametrize("real", [True, False])
def test_band_stack_plain_equals_gather_blocks(mode, real):
    """On a band-stack pack every plain path reads the same values in the
    same order as on the gather blocks: the per-key views, the consistent
    pivots and K3's plain version in each mode, bit for bit."""
    cA, p, b = problem(6, 10, 14, seed=5)
    tc = torch.from_numpy(cA)
    bp, gp = trc.build_band_pack(tc, real), trc.build_compact_pack(tc, real)
    assert bp.blocks is None and bp.rblocks is None
    for f in ("d", "ud", "bet"):
        assert all(torch.equal(x, y)
                   for x, y in zip(getattr(bp, f), getattr(gp, f)))
    for m in range(4):
        for x, y in zip(trc.block_views(bp, m), trc.block_views(gp, m)):
            assert x.shape == y.shape and torch.equal(x, y)
    for x, y in zip(trc.consistent_pivots(bp, torch.bfloat16),
                    trc.consistent_pivots(gp, torch.bfloat16)):
        assert torch.equal(x, y)
    e = trc.extend_quads(tquads(p))
    e4 = tuple(e[k] for k in trc._TKEYS)
    targets = trc._TKEYS if mode == "coarse" else ((0, 1), (1, 0))
    got = kt.residual_restrict_plain(e4, tquads(b), bp, mode, targets)
    want = kt.residual_restrict_plain(e4, tquads(b), gp, mode, targets)
    if mode == "coarse":
        assert torch.equal(got, want)
    else:
        assert sorted(got) == sorted(targets)
        assert all(torch.equal(got[t], want[t]) for t in targets)


@pytest.mark.parametrize("lp", [False, True])
def test_pack_from_numpy_carries_a_band_stack_level(lp):
    """convert.pack_from_numpy builds a pack without gather blocks from the
    band stack's content (and, with ``lp``, the bfloat16 stack and the
    low-precision pivots): the same stack, pivots and K3 result as the
    band pack it came from."""
    cA, p, b = problem(4, 12, 20, seed=8)
    cA = cA.astype(np.float32)
    bp = trc.build_band_pack(torch.from_numpy(cA), True)
    if lp:
        bp = trc.attach_lp(bp)
    fields = {f: [x.numpy() for x in getattr(bp, f)]
              for f in ("d", "ud", "bet")}
    fields["ebands"] = [x[1:-1].numpy() for x in bp.ebands]
    if lp:
        fields["bet_lp"] = [x.numpy() for x in bp.lp.bet]
        fields["ebands_lp"] = [x[1:-1].float().numpy() for x in bp.lp.ebands]
    cp = convert.pack_from_numpy(fields, True, device="cpu",
                                 dtype=torch.float32)
    assert cp.blocks is None and cp.rblocks is None
    assert torch.equal(cp.ebands, bp.ebands)
    assert cp.ebands.stride() == bp.ebands.stride()
    if lp:
        assert cp.lp.blocks is None and torch.equal(cp.lp.ebands,
                                                    bp.lp.ebands)
        assert all(torch.equal(x, y) for x, y in zip(cp.lp.bet, bp.lp.bet))
    q, bq = tquads(p.astype(np.float32)), tquads(b.astype(np.float32))
    assert torch.equal(kt.residual_restrict_tiled_quads(q, bq, cp),
                       kt.residual_restrict_tiled_quads(q, bq, bp))


def _port(**kw):
    m = NHModel(N, N, N, cfg=SolverConfig(**kw), device="cpu")
    c = setup_seamount(N, N, N)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


@pytest.mark.parametrize("route", ["k4", "k1", "k4 perf", "k1 perf",
                                   "tiles"])
def test_build_relax_packs_layouts(route):
    """The levels K4 smooths (pallas_interpret on the CPU) hold the band
    stack and no gather blocks — in perf mode a float32 stack beside the
    bfloat16 one and the low-precision pivots, no blocks of either
    precision; the K1-K2 route's levels and the tiles of a distributed
    level hold the gather blocks and no stack."""
    perf = dict(dtype="float32", fused_bands_bf16=True, ns_pre=1,
                ns_post=1) if "perf" in route else {}
    m = _port(pallas_interpret=route.startswith("k4"), **perf)
    if route == "tiles":
        m.distribute(2, 2, devices=["cpu"] * 4)
    packs = [pk for pk in m.backend.packs if pk is not None]
    assert packs
    # a distributed level's packs are Tiles (replicated levels: one pack)
    assert any(hasattr(pk, "flat") for pk in packs) == (route == "tiles")
    for pk in packs:
        for tile in (pk.flat() if hasattr(pk, "flat") else (pk,)):
            bands = route.startswith("k4")
            assert (tile.blocks is None) == bands
            assert (tile.ebands is not None) == bands
            if bands:
                assert tile.ebands.dtype == m.dtype
            if perf:
                assert (tile.lp.blocks is None) == bands
                assert (tile.lp.ebands is not None) == bands
                assert tile.lp.bet is not None
                if bands:
                    assert tile.lp.ebands.dtype == torch.bfloat16


def test_k3_routing_on_band_levels(monkeypatch):
    """On band-stack levels each down-leg restriction is one K3 launch
    (L (L - 1) / 2 per F-cycle) and each level-0 residual one K3 launch in
    its residual mode (solve_init's and one per F-cycle)."""
    calls = []
    wrapped = kt.residual_restrict

    def spy(e4, bq, pack, mode="coarse", targets=trc._TKEYS):
        calls.append((mode, pack.ebands is not None))
        return wrapped(e4, bq, pack, mode, targets)

    monkeypatch.setattr(kt, "residual_restrict", spy)
    m = _port(pallas_interpret=True)
    u, v, w = initial_velocities(N, N, N, device="cpu")
    m.pressure_solve(m.rhs(u, v, w), tol=0.0, maxiter=2)
    L = len(m.levels)
    assert calls.count(("coarse", True)) == 2 * L * (L - 1) // 2
    assert calls.count(("residual", True)) == 1 + 2
    assert len(calls) == 2 * L * (L - 1) // 2 + 3


@pytest.mark.parametrize("kind", ["FC", "GS"])
def test_use_pallas_compact_false_history_matches_jax(kind):
    """Seamount 16^3 f32 with use_pallas=True, compact=False in the FC and
    GS orderings (every level in full layout, K6's plain version) over 3
    F-cycles: equal to the port's masked-relax history, and against JAX's
    (Pallas kernels in interpret mode) to rtol 1e-3 on the first cycle;
    the later cycles sit at the f32 residual floor, whose rounding order
    differs between XLA and torch (test_torch_relax_fused's RB history is
    held the same way): rtol 0.3."""
    cfg = dict(dtype="float32", compact=False, relax_method=kind)
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
    print(f"{kind}: rel deviation from JAX per cycle {np.abs(got / want - 1)}")
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0.3, atol=0)
