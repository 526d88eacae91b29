"""The colour-fused sweep (K4) and the low-precision smoother operator ==
JAX, on the CPU.

JAX's K4 runs in Pallas interpret mode, as tests/test_sweep_fused.py runs
it; K1 as tests/test_lp_blocks.py runs it.  The CUDA kernel cannot run
here: its reads (the band stack at the band term table's offsets, the
state windows through the halo map, its two phases and the on-chip
Thomas recurrence) are emulated below with flat addressing and held to the
plain version to the last bit; the band stack is held to JAX's band
quads.

Tolerances: 1e-12 x max|JAX| in float64 (same term order); in float32
the JAX tests' own (2e-5 for K4 with bfloat16 bands, 1e-6 relative for
the pivots); histories as stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgroms_tpu.ops.pallas.relax_tiled as jtiled
import mgroms_tpu.ops.pallas.sweep_fused as jsf
import mgroms_tpu.ops.relax_compact as jrc
import mgroms_tpu_torch.ops.kernels.relax_tiled as kt
import mgroms_tpu_torch.ops.kernels.sweep_fused as ksf
import mgroms_tpu_torch.ops.relax_compact as trc
from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.convert import pack_from_numpy

torch.set_num_threads(1)


def close(got, want, tol=1e-12):
    want = np.asarray(want, dtype=np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def problem(nz, ny, nx, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    return tuple(x.astype(dtype) for x in (
        cA, rng.standard_normal((nz, ny, nx)),
        rng.standard_normal((nz, ny, nx))))


def jquads(x):
    return jrc.split_quads(jnp.asarray(x))


def tquads(x):
    return trc.split_quads(torch.from_numpy(x))


def jax_sweep_pack(cA, real, band_dtype=None):
    nz, ny, nx = cA.shape[1], cA.shape[2] - 2, cA.shape[3] - 2
    pack = jrc.build_compact_pack(jnp.asarray(cA), real)
    sop = jsf.build_sweep_operator(jnp.asarray(cA), pack, nz, ny // 2,
                                   nx // 2, band_dtype=band_dtype)
    assert sop is not None
    return pack._replace(sweep=sop)


# ---------------------------------------------------------------- (a) (c)

@pytest.mark.parametrize("nsweeps", [1, 3])
@pytest.mark.parametrize("real", [True, False])
def test_plain_sweep_matches_jax_kernel(real, nsweeps):
    """K4's plain version == JAX's K4 (interpret) in float64 at quads
    (5, 16, 16): two row tiles of the TPU kernel."""
    cA, p, b = problem(5, 32, 32, seed=0)
    jp = jax_sweep_pack(cA, real)
    want = jsf.relax_fused_sweep(jquads(p), jquads(b), jp, nsweeps, real,
                                 interpret=True)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    got = ksf.relax_fused_sweep(tquads(p), tquads(b), tp, nsweeps)
    for t in trc._TKEYS:
        close(got[t], want[t])


def test_bf16_plain_sweep_matches_jax_kernel():
    """K4's plain version on the port's attach_lp pack == JAX's K4 with
    bfloat16 bands (interpret) in float32, to the JAX test's 2e-5."""
    cA, p, b = problem(4, 32, 32, seed=5, dtype=np.float32)
    jp = jax_sweep_pack(cA, True, band_dtype=jnp.bfloat16)
    want = jsf.relax_fused_sweep(jquads(p), jquads(b), jp, 1, True,
                                 interpret=True)
    tp = trc.attach_lp(trc.build_compact_pack(torch.from_numpy(cA), True))
    got = ksf.relax_fused_sweep(tquads(p), tquads(b), tp, 1)
    for t in trc._TKEYS:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=2e-5, atol=2e-5)


# -------------------------------------------------------------------- (b)

@pytest.mark.parametrize("real", [True, False])
def test_attach_lp_matches_jax(real):
    """attach_lp: the rounded blocks equal JAX's, the consistent pivots
    agree to rtol 1e-6 (float32), and A'.1 == A.1 (the row sums, as
    tests/test_lp_blocks.py checks them)."""
    cA, _, _ = problem(6, 8, 10, seed=1, dtype=np.float32)
    jp = jrc.attach_lp(jrc.build_compact_pack(jnp.asarray(cA), real))
    tp = trc.attach_lp(trc.build_compact_pack(torch.from_numpy(cA), real))
    jblocks, jrb, jbet, _ = jp.lp
    jbet2, _ = jsf.consistent_pivots(jp, jnp.bfloat16)
    for m, (a, b) in enumerate(trc._TKEYS):
        assert tp.lp.blocks[m].dtype == torch.bfloat16
        close(tp.lp.blocks[m], np.asarray(jblocks[m], np.float32), 0)
        if real:
            close(tp.lp.rblocks[m], np.asarray(jrb[m], np.float32), 0)
        np.testing.assert_allclose(tp.lp.bet[m].numpy(), np.asarray(jbet[m]),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            trc.consistent_pivots(tp, torch.bfloat16)[m].numpy(),
            np.asarray(jbet2[m]), rtol=1e-6)
        nz, H, W = tp.d[m].shape
        ones = {t: torch.ones((nz, H + 2, W + 2)) for t in trc._TKEYS}
        g = trc.gather_blocks(ones, trc.block_views(tp, m), a, b, real)
        g_lp = trc.gather_blocks(
            ones, tuple(v.float() for v in trc.block_views(tp, m, lp=True)),
            a, b, real)
        np.testing.assert_allclose((1.0 / tp.lp.bet[m][0] + g_lp[0]).numpy(),
                                   (tp.d[m][0] + g[0]).numpy(),
                                   rtol=2e-6, atol=2e-6)


# -------------------------------------------------------------------- (d)

def lp_fields(jp):
    """A JAX pack with attach_lp as pack_from_numpy fields (bfloat16 as
    float32 arrays)."""
    f32 = lambda xs: [np.asarray(x, np.float32) for x in xs]
    fields = {f: f32(getattr(jp, f)) for f in ("blocks", "d", "ud", "bet")}
    fields.update(blocks_lp=f32(jp.lp[0]), bet_lp=f32(jp.lp[2]))
    if jp.real_matrix:
        fields.update(rblocks=f32(jp.rblocks), rblocks_lp=f32(jp.lp[1]))
    return fields


def test_bf16_color_update_plain_matches_jax_kernel():
    """K1's bfloat16-block plain version == JAX's color_update_tiled
    (interpret) on JAX's own attach_lp pack, carried over by
    pack_from_numpy; and two sweeps of the K1 orchestration == JAX's.
    float32, same term order: 1e-6 x max|JAX|."""
    cA, p, b = problem(4, 32, 32, seed=2, dtype=np.float32)
    jp = jrc.attach_lp(jrc.build_compact_pack(jnp.asarray(cA), True))
    tp = pack_from_numpy(lp_fields(jp), True, device="cpu",
                         dtype=torch.float32)
    assert tp.lp.blocks[0].dtype == torch.bfloat16
    je, te = jrc.extend_quads(jquads(p)), trc.extend_quads(tquads(p))
    jb, tb = jquads(b), tquads(b)
    for m, t in enumerate(trc._TKEYS):
        want = jtiled.color_update_tiled(
            tuple(je[k] for k in jtiled._gather_quads(t)), jb[t], jp.lp[0][m],
            jp.ud[m], jp.lp[2][m], t, True, interpret=True, rb_t=jp.lp[1][m])
        got = kt.color_update(te, tb, tp, (t,))[t]
        close(got, want, 1e-6)
    want = jtiled.relax_compact_tiled_quads(jquads(p), jb, jp, 2, "RB", True,
                                            interpret=True)
    got = kt.relax_compact_tiled_quads(tquads(p), tb, tp, 2)
    for t in trc._TKEYS:
        close(got[t], want[t], 1e-6)


def test_smoothers_refuse_blocks_without_their_pivots():
    """Every smoothing path (K4's and K1's orchestration, the plain sweep)
    takes its operator from smoother_operator, which refuses bfloat16
    blocks beside the full-precision pivots, a low-precision operator
    without pivots, and one under float64 state; the fused relax+residual
    refuses a pack with the low-precision operator (its residual is A's)."""
    cA, p, b = problem(4, 8, 8, seed=3, dtype=np.float32)
    tp = trc.attach_lp(trc.build_compact_pack(torch.from_numpy(cA), True))
    q, bq = tquads(p), tquads(b)
    no_pivots = tp._replace(blocks=tp.lp.blocks, rblocks=tp.lp.rblocks,
                            lp=None)
    bad = (no_pivots, tp._replace(lp=tp.lp._replace(bet=None)))
    smoothers = (lambda pk, x: ksf.relax_fused_sweep(x, bq, pk, 1),
                 lambda pk, x: kt.relax_compact_tiled_quads(x, bq, pk, 1),
                 lambda pk, x: trc.relax_compact_quads(x, bq, pk, 1, "RB",
                                                       True))
    q64 = {t: x.double() for t, x in q.items()}
    for smooth in smoothers:
        for pk in bad:
            with pytest.raises(ValueError, match="consistent pivots"):
                smooth(pk, q)
        with pytest.raises(ValueError, match="float32 state"):
            smooth(tp, q64)
    with pytest.raises(ValueError, match="full-precision"):
        trc.relax_residual_compact_quads(q, bq, tp, 1, True)
    with pytest.raises(ValueError, match="full-precision"):
        kt.relax_residual_tiled_quads(q, bq, tp, 1)


# ------------------------------------------------- the CUDA kernel's recipe

def _halo_map(a, X, n):
    """csrc/sweep_fused.cu halo_map, over index arrays."""
    sa = np.where(X == 0, 0, np.where(X == n + 1, 1, a))
    x = np.where(X == 0, 0, np.where(X == n + 1, n - 1, X - 1))
    return sa, x


def _storage(stack):
    """The band stack's storage as the kernel addresses it: a flat array
    from extended column 0's storage column minus lpad, and the pitch."""
    lpad, pitch = trc.band_layout(stack.shape[3] - 2, stack.element_size())
    assert stack.stride()[2] == pitch
    n = stack.shape[0] * stack.shape[1] * stack.shape[2] * pitch
    flat = torch.as_strided(stack, (n,), (1,), stack.storage_offset() - lpad)
    return flat.float().numpy() if stack.dtype == torch.bfloat16 \
        else flat.numpy(), lpad, pitch


def _emulate_target(src, flat, lpad, pitch, ud, bet, bq, t, real):
    """update_tile for every column of target ``t``: the band values from
    the stack's storage at the band term table's offsets (plane k + bk + 1
    of the stack, zero end planes), the state values from the window
    planes k - 1 .. k + 1 of the two quads of the other colour, staged
    through the halo map (zero planes -1 and nz), the plane-0 'real'
    couplings in place, and the Thomas recurrence kept in xs / cs."""
    nz, H, W = bq.shape
    J, I = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    S = np.stack(src)
    PB = (H + 2) * pitch
    a, b = t
    wq = (2 * (1 - a) + b, 2 * a + (1 - b))
    # the window planes: the two quads' extended planes, by the halo rule
    R, C = np.meshgrid(np.arange(H + 2), np.arange(W + 2), indexing="ij")
    zero = np.zeros((2, H + 2, W + 2), S.dtype)
    win = {-1: zero, nz: zero}
    for kk in range(nz):
        planes = []
        for q in wq:
            sa, r = _halo_map(q >> 1, R, H)
            sb, c = _halo_map(q & 1, C, W)
            planes.append(S[2 * sa + sb, kk, r, c])
        win[kk] = np.stack(planes)
    tt = ksf.band_term_table(t)
    xs, cs = np.empty_like(bq), np.empty_like(bq)
    x = udp = None
    for k in range(nz):
        def term(m):
            band, bk, bj, bi, s_, dk, oj, oi = tt[m]
            bv = flat[((band * (nz + 2) + k + bk + 1) * (H + 2) + J + bj)
                      * pitch + lpad + I + bi]
            return bv * win[k + dk][wq.index(s_), J + oj, I + oi]
        s = term(0)
        for m in range(1, 12):
            s = s + term(m)
        if real and k == 0:
            x0 = None
            for m in range(12, 16):
                band, bk, bj, bi, s_, dk, oj, oi = tt[m]
                sa, r = _halo_map(s_ >> 1, J + oj, H)
                sb, c = _halo_map(s_ & 1, I + oi, W)
                bv = flat[((band * (nz + 2) + bk + 1) * (H + 2) + J + bj)
                          * pitch + lpad + I + bi]
                v = bv * S[2 * sa + sb, dk, r, c]
                x0 = v if x0 is None else x0 + v
            s = s + x0
        rhs = bq[k] - s
        x = rhs * bet[k] if k == 0 else (rhs - udp * x) * bet[k]
        xs[k] = x
        if k < nz - 1:
            udp = ud[k]
            cs[k] = udp * bet[k]
    out = np.empty_like(bq)
    out[nz - 1] = x
    for k in range(nz - 2, -1, -1):
        x = xs[k] - cs[k] * x
        out[k] = x
    return out


def _emulate_sweep(q, bq, pack, real):
    """sweep_kernel: colour 0 from the pre-sweep quads, then colour 1 with
    the colour-0 quads' new values and the colour-1 quads' pre-sweep
    ones."""
    stack, bet, _ = ksf.sweep_bands(pack, q[(0, 0)].dtype)
    flat, lpad, pitch = _storage(stack)
    qs = [q[t].numpy() for t in trc._TKEYS]
    out = [None] * 4
    for phase, targets in ((0, (0, 3)), (1, (1, 2))):
        src = qs if phase == 0 else [out[0], qs[1], qs[2], out[3]]
        for m in targets:
            t = trc._TKEYS[m]
            out[m] = _emulate_target(src, flat, lpad, pitch,
                                     pack.ud[m].numpy(), bet[m].numpy(),
                                     bq[t].numpy(), t, real)
    return dict(zip(trc._TKEYS, out))


BANDS = {"f64": (np.float64, False), "f32": (np.float32, False),
         "bf16": (np.float32, True)}


# quads: ragged, one row, odd both, and even; nz = 2 included
@pytest.mark.parametrize("shape", [(6, 10, 14), (2, 2, 6), (3, 6, 2),
                                   (4, 8, 8)])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("band", list(BANDS))
def test_cuda_recipe_emulation_matches_plain(shape, real, band):
    """The CUDA kernel's reads (emulated in numpy): the band stack at the
    band term table's offsets, the state windows through the halo map, the
    'real' couplings in place, the Thomas recurrence on chip, two colours
    — give the plain sweep's values to the last bit, in float64, float32
    and float32 with bfloat16 bands."""
    dtype, lp = BANDS[band]
    cA, p, b = problem(*shape, seed=sum(shape), dtype=dtype)
    cA = torch.from_numpy(cA)
    tp = trc.build_compact_pack(cA, real)
    if lp:
        tp = trc.attach_lp(tp)
    tp = trc.attach_bands(tp, cA)
    q, bq = tquads(p), tquads(b)
    want = ksf.relax_fused_sweep_plain(q, bq, tp, 1)
    got = _emulate_sweep(q, bq, tp, real)
    for t in trc._TKEYS:
        close(got[t], want[t], 0)


@pytest.mark.parametrize("t", trc._TKEYS)
def test_band_terms_read_the_gather_blocks(t):
    """Every gather term's band read (band_term_table) lands on the value
    its gather block holds: block (n, boff) of target t at (k, J, I) is
    band quad ``band`` at plane k + bk + 1 of the stack, row J + bj,
    column I + bi, for every k (the zero end planes included)."""
    cA, _, _ = problem(4, 10, 14, seed=9)
    cA = torch.from_numpy(cA)
    pack = trc.build_compact_pack(cA, True)
    stack = trc.band_quads(cA)
    views = trc.block_views(pack, trc._TKEYS.index(t))
    keys = trc.gather_keys(True)
    nz, H, W = pack.d[0].shape
    for (n, boff, _), row in zip(trc._BASE_TERMS + trc._REAL_TERMS,
                                 ksf.band_term_table(t)):
        band, bk, bj, bi = row[:4]
        want = views[keys.index((n, boff))]
        got = stack[band, 1 + bk:1 + bk + nz, bj:bj + H, bi:bi + W]
        if want.shape[0] == 1:           # the 'real' pair: plane 0 only
            got = got[:1]
        assert torch.equal(got, want), (t, n, boff)


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_band_quads_match_jax(real, lp):
    """The port's band stack equals JAX's quad_ext_bands(cA[n]) for
    n = 2..7 and the content of JAX's SweepOperator.ebands (one chunk)
    without its padding, bit for bit, float32 and bfloat16 (attach_lp's
    rounding); planes 0 and nz+1 are zero; pack_from_numpy carries JAX's
    bands into the same stack."""
    nz, ny, nx = 4, 32, 32
    cA, _, _ = problem(nz, ny, nx, seed=7, dtype=np.float32)
    bd = jnp.bfloat16 if lp else None
    jp = jax_sweep_pack(cA, real, band_dtype=bd)
    tc = torch.from_numpy(cA)
    tp = trc.build_compact_pack(tc, real)
    if lp:
        tp = trc.attach_lp(tp)
    tp = trc.attach_bands(tp, tc)
    stack, _, band = ksf.sweep_bands(tp, torch.float32)
    assert stack.dtype == (torch.bfloat16 if lp else torch.float32)
    H, W = ny // 2, nx // 2
    f32 = lambda x: np.asarray(x, np.float32)
    jb = [f32(jnp.asarray(jrc.quad_ext_bands(jnp.asarray(cA[n]))[t])
              .astype(bd or jnp.float32))
          for n in range(2, 8) for t in trc._TKEYS]
    jsweep = [f32(x)[:, 1:H + 3, 1:W + 3] for x in jp.sweep.ebands[0]]
    assert len(jp.sweep.ebands) == 1 and len(jsweep) == trc.NBANDS
    for i in range(trc.NBANDS):
        got = stack[i].float().numpy()
        np.testing.assert_array_equal(got[1:-1], jb[i])
        np.testing.assert_array_equal(got[1:-1], jsweep[i])
        assert not got[0].any() and not got[-1].any()
    key = "ebands_lp" if lp else "ebands"
    fields = lp_fields(jrc.attach_lp(jp)) if lp else {
        f: [np.asarray(x) for x in getattr(jp, f)]
        for f in ("blocks", "d", "ud", "bet", "rblocks")
        if real or f != "rblocks"}
    fields[key] = jsweep
    cp = pack_from_numpy(fields, real, device="cpu", dtype=torch.float32)
    cstack = ksf.sweep_bands(cp, torch.float32)[0]
    assert cstack.dtype == stack.dtype
    assert cstack.stride() == stack.stride()
    assert torch.equal(cstack, stack)


# -------------------------------------------------------------------- (e)

N = 16


def _port(cfg, n=N):
    m = NHModel(n, n, n, cfg=cfg, device="cpu")
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


@pytest.mark.parametrize("interpret", [True, False])
def test_k4_route(monkeypatch, interpret):
    """With pallas_interpret=True the K4 wrapper smooths every quad level
    (every level but the coarsest) and K1's orchestration none, and those
    levels' packs carry the band stack; without it K4 never runs (the JAX
    package's CPU route) and no band stack is built."""
    seen = {"k4": set(), "k1": set()}

    def spy(name, fn):
        def wrapped(q0, bq, pack, nsweeps, **kw):
            seen[name].add(tuple(q0[(0, 0)].shape))
            return fn(q0, bq, pack, nsweeps, **kw)
        return wrapped

    monkeypatch.setattr(ksf, "relax_fused_sweep",
                        spy("k4", ksf.relax_fused_sweep))
    monkeypatch.setattr(kt, "relax_compact_tiled_quads",
                        spy("k1", kt.relax_compact_tiled_quads))
    m = _port(SolverConfig(pallas_interpret=interpret))
    u, v, w = initial_velocities(N, N, N, device="cpu")
    m.pressure_solve(m.rhs(u, v, w), tol=1e-30, maxiter=1)
    quads = {(s.nzg, s.nyg // 2, s.nxg // 2) for s in m.levels[:-1]}
    assert seen["k4"] == (quads if interpret else set())
    assert seen["k1"] == (set() if interpret else quads)
    # the band stack is built exactly on the levels K4 smooths
    packs = m.backend.packs[:-1]
    assert all((pk.ebands is not None) == interpret for pk in packs)


# -------------------------------------------------------------------- (f)

def _jax_solve(cfg, dtype, tol, maxiter):
    c = setup_seamount(N, N, N)
    m = JModel(N, N, N, cfg=cfg)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = jvel(N, N, N, dtype=dtype)
    return m.solve(u, v, w, tol=tol, maxiter=maxiter)[-1]


def test_interpret_route_history_matches_jax():
    """Seamount 16^3, float64, pallas_interpret=True on both sides (JAX's
    K4 in interpret mode; the port's K4 plain version): histories within
    rel 1e-8 above the float64 floor of the relative residual (atol 1e-15,
    as the port's other history tests).  The routes differ in rounding
    only: JAX keeps the fused residual on the level its K4 tile cannot
    take and smooths the coarsest level in quad layout."""
    jinfo = _jax_solve(JConfig(pallas_interpret=True), jnp.float64, 1e-11,
                       12)
    m = _port(SolverConfig(pallas_interpret=True))
    u, v, w = initial_velocities(N, N, N, device="cpu")
    info = m.solve(u, v, w, tol=1e-11, maxiter=12)[-1]
    assert info.niter == jinfo.niter
    np.testing.assert_allclose(info.history, jinfo.history, rtol=1e-8,
                               atol=1e-15)


def test_perf_mode_matches_jax():
    """Seamount 16^3, float32, perf mode (bfloat16 smoother operator,
    V(1,1), defect-form step) on the CPU route: the first cycle within
    rel 1e-3 of JAX's, both solves <= 1e-4, iteration counts within one.
    The two differ on the coarsest level, which the JAX package on the CPU
    smooths in quad layout with bfloat16 blocks and the port (as the JAX
    package on the accelerator) in full layout with the true operator."""
    kw = dict(dtype="float32", fused_bands_bf16=True, ns_pre=1, ns_post=1)
    jinfo = _jax_solve(JConfig(**kw), jnp.float32, 1e-4, 12)
    m = _port(SolverConfig(**kw))
    assert all(pk is None or pk.lp is not None for pk in m.backend.packs)
    u, v, w = initial_velocities(N, N, N, dtype=torch.float32, device="cpu")
    info = m.solve(u, v, w, tol=1e-4, maxiter=12)[-1]
    assert abs(info.history[1] / jinfo.history[1] - 1) <= 1e-3
    assert info.res <= 1e-4 and jinfo.res <= 1e-4
    assert abs(info.niter - jinfo.niter) <= 1


# -------------------------------------------------------------------- (g)

def test_defect_form_step_matches_jax():
    """One cycle_step in defect form (fused_bands_bf16 in float64: no
    low-precision blocks, p += Fcycle(0, r, r)) == JAX's, CPU route, to
    rel 1e-10."""
    from mgroms_tpu.solver import cycle_step as jstep
    from mgroms_tpu.solver import solve_init as jinit
    from mgroms_tpu_torch.solver import cycle_step, solve_init
    jcfg = JConfig(fused_bands_bf16=True)
    c = setup_seamount(N, N, N)
    jm = JModel(N, N, N, cfg=jcfg)
    jm.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                    theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = jvel(N, N, N)
    jp, jb, jr, _, _ = jinit(jm.backend, jm.rhs(u, v, w))
    jp, jr = jax.jit(jstep, static_argnames=("cfg",))(jm.backend, jp, jb, jr,
                                                     jcfg)
    m = _port(SolverConfig(fused_bands_bf16=True))
    assert all(pk is None or pk.lp is None for pk in m.backend.packs)
    be = m.backend
    p, b, r, _, _ = solve_init(be, m.rhs(*initial_velocities(N, N, N,
                                                              device="cpu")))
    p, r = cycle_step(be, p, b, r, m.cfg)
    close(be.to_full(0, p), np.asarray(jm.backend.to_full(0, jp)), 1e-10)
    close(be.to_full(0, r), np.asarray(jm.backend.to_full(0, jr)), 1e-10)
