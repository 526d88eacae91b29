"""Quad-parity layer and the kernels' plain versions == JAX, in float64.

The plain versions of K1-K3 are held to the Pallas kernels run in
interpret mode (as tests/test_pallas_tiled.py and
tests/test_fused_residual.py run them).  The CUDA kernels cannot run here;
their index recipes (``term_table``, ``band_term_table``) and their loops
are emulated below with flat-array addressing exactly as
csrc/relax_tiled.cu (K1, K2) and csrc/rr_fused.cu (K3, on its staged
window ring) write them, and held to the plain versions.

Tolerance: 1e-12 x max|JAX| unless stated (same term order in f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgroms_tpu.ops.pallas.relax_tiled as jtiled
import mgroms_tpu.ops.relax_compact as jrc
import mgroms_tpu_torch.ops.kernels.relax_tiled as kt
import mgroms_tpu_torch.ops.kernels.sweep_fused as ksf
import mgroms_tpu_torch.ops.relax_compact as trc

torch.set_num_threads(1)


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def problem(nz, ny, nx, seed):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    return (cA, rng.standard_normal((nz, ny, nx)),
            rng.standard_normal((nz, ny, nx)))


def jquads(x):
    return jrc.split_quads(jnp.asarray(x))


def tquads(x):
    return trc.split_quads(torch.from_numpy(x))


def close_quads(tq, jq, tol=1e-12):
    assert sorted(tq) == sorted(jq)
    for k in jq:
        close(tq[k], jq[k], tol)


# a ragged shape (odd quad H and W) and the 16^2 x 8 Pallas-compatible one
SHAPES = [(6, 10, 14), (8, 16, 16)]


@pytest.mark.parametrize("real", [True, False])
def test_build_compact_pack_fields(real):
    cA, _, _ = problem(6, 10, 14, seed=0)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    for f in ("blocks", "d", "ud", "bet"):
        for jx, tx in zip(getattr(jp, f), getattr(tp, f)):
            close(tx, jx)
            assert tx.is_contiguous()
    if real:
        for jx, tx in zip(jp.rblocks, tp.rblocks):
            close(tx, jx)
    else:
        assert tp.rblocks is None


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_relax_residual(shape):
    cA, p, b = problem(*shape, seed=1)
    jp = jrc.build_compact_pack(jnp.asarray(cA), True)
    tp = trc.build_compact_pack(torch.from_numpy(cA), True)
    je, te = jrc.extend_quads(jquads(p)), trc.extend_quads(tquads(p))
    close_quads(te, je, 0)
    for m, (a, bb) in enumerate(trc._TKEYS):
        close(trc.gather_blocks(te, trc.block_views(tp, m), a, bb, True),
              jrc.gather_blocks(je, jrc.block_views(jp, m), a, bb, True))
    close_quads(trc.relax_compact_quads(tquads(p), tquads(b), tp, 2, "RB",
                                        True),
                jrc.relax_compact_quads(jquads(p), jquads(b), jp, 2, "RB",
                                        True))
    close_quads(trc.residual_quads(tquads(p), tquads(b), tp, True),
                jrc.residual_quads(jquads(p), jquads(b), jp, True))
    close(trc.merge_quads(tquads(p)), p, 0)


@pytest.mark.parametrize("real", [True, False])
def test_fused_residual_orchestrators(real):
    cA, p, b = problem(6, 10, 14, seed=2)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    jq, jr = jrc.relax_residual_compact_quads(jquads(p), jquads(b), jp, 2,
                                              real)
    tq, tr = trc.relax_residual_compact_quads(tquads(p), tquads(b), tp, 2,
                                              real)
    close_quads(tq, jq)
    close_quads(tr, jr)
    jq, jcb = jrc.relax_residual_restrict_compact_quads(
        jquads(p), jquads(b), jp, 2, real)
    tq, tcb = trc.relax_residual_restrict_compact_quads(
        tquads(p), tquads(b), tp, 2, real)
    close_quads(tq, jq)
    close(tcb, jcb)
    rq = trc.residual_quads(tquads(p), tquads(b), tp, real)
    close(trc.restrict_quads_to_full(rq),
          jrc.restrict_quads_to_full(jrc.residual_quads(jquads(p),
                                                        jquads(b), jp, real)))


@pytest.mark.parametrize("real", [True, False])
def test_kernel_plain_versions_match_pallas(real):
    """K1/K2 plain versions and K3's plain version in its z-pair mode, one
    target at a time, == the Pallas kernels (interpret mode)."""
    cA, p, b = problem(8, 16, 16, seed=3)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    je, te = jrc.extend_quads(jquads(p)), trc.extend_quads(tquads(p))
    jb, tb = jquads(b), tquads(b)
    for m, t in enumerate(trc._TKEYS):
        jrb = jp.rblocks[m] if real else None
        trb = tp.rblocks[m] if real else None
        je3 = tuple(je[k] for k in jtiled._gather_quads(t))
        te3 = tuple(te[k] for k in kt.gather_quads(t))
        want = jtiled.color_update_tiled(je3, jb[t], jp.blocks[m], jp.ud[m],
                                         jp.bet[m], t, real, interpret=True,
                                         rb_t=jrb)
        close(kt.color_update(te3, tb[t], tp.blocks[m], tp.ud[m], tp.bet[m],
                              t, real, trb), want)
        ws, wr = jtiled.color_update_tiled_emit(
            je3, jb[t], jp.blocks[m], jp.ud[m], jp.bet[m], jp.d[m], t, real,
            interpret=True, rb_t=jrb)
        gs, gr = kt.color_update_emit(te3, tb[t], tp.blocks[m], tp.ud[m],
                                      tp.bet[m], tp.d[m], t, real, trb)
        close(gs, ws)
        close(gr, wr, 1e-12 * np.abs(np.asarray(jb[t])).max()
              / np.abs(np.asarray(wr)).max())
        want = jtiled._rr_one(tuple(je[k] for k in jrc._TKEYS), jb[t],
                              jp.blocks[m], jp.d[m], jp.ud[m], t, real,
                              interpret=True, rb_t=jrb)
        close(kt.residual_restrict(tuple(te[k] for k in trc._TKEYS), tb, tp,
                                   "zsum", (t,))[t], want)


# ---- CPU emulation of csrc/relax_tiled.cu (flat addressing, per column) --

def _emulate_gather(eq, blocks, rb, real, tt, k, nz, H, W):
    """csrc gather(): returns g at plane k for every (J, I) column."""
    J, I = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    eflat = [e.reshape(-1) for e in eq]
    bflat = blocks.reshape(-1)
    wrow = 12 * W

    def state(m):
        kk = k + tt[m][1]
        if kk < 0 or kk >= nz:
            return np.zeros((H, W))
        return eflat[tt[m][0]][kk * (H + 2) * (W + 2)
                               + (J + tt[m][2]) * (W + 2) + (I + tt[m][3])]

    s = bflat[(k * H + J) * wrow + I] * state(0)
    for m in range(1, 12):
        s = s + bflat[(k * H + J) * wrow + m * W + I] * state(m)
    if real and k == 0:
        x0 = None
        for m in range(12, 16):
            blk = tt[m][4]
            bv = (bflat[J * wrow + blk * W + I] if blk < 12
                  else rb.reshape(-1)[J * 2 * W + (blk - 12) * W + I])
            t = bv * state(m)
            x0 = t if x0 is None else x0 + t
        s = s + x0
    return s


def _emulate_color_update(e3, bq, blocks, ud, bet, d, target, real, rb,
                          emit):
    nz, H, W = bq.shape
    tt = kt.term_table(target, kt.gather_quads(target))
    out = np.empty_like(bq)
    res = np.empty_like(bq)
    x = None
    for k in range(nz):
        g = _emulate_gather(e3, blocks, rb, real, tt, k, nz, H, W)
        res[k] = g
        rhs = bq[k] - g
        x = rhs * bet[k] if k == 0 else (rhs - ud[k - 1] * x) * bet[k]
        out[k] = x
    for k in range(nz - 2, -1, -1):
        x = out[k] - (ud[k] * bet[k]) * x
        out[k] = x
    if not emit:
        return out
    z = np.zeros((H, W))
    for k in range(nz):
        lo = ud[k - 1] if k > 0 else z
        xm = out[k - 1] if k > 0 else z
        hi = ud[k] if k < nz - 1 else z
        xp = out[k + 1] if k < nz - 1 else z
        res[k] = bq[k] - d[k] * out[k] - lo * xm - hi * xp - res[k]
    return out, res


# csrc/rr_fused.cu's tile
RR_COLS, RR_ROWS = 64, 4


def _emulate_rr(e4, bq, pack, mode, targets):
    """csrc/rr_fused.cu in numpy: per tile of RR_ROWS x RR_COLS columns and
    plane, the window ring as the kernel stages it (the four extended
    quads' (RR_ROWS + 2) x (RR_COLS + 2) windows, zero planes -1 and nz;
    entries it does not stage are NaN), the operator read in place (the
    band stack's flat storage at the band term table's offsets, or the
    gather blocks), each column's four residuals, then the mode's
    output."""
    bands = pack.ebands is not None
    nz, H, W = bq[(0, 0)].shape
    tt = [ksf.band_term_table(t) for t in trc._TKEYS]
    if bands:
        st = pack.ebands
        lpad, pitch = trc.band_layout(W, st.element_size())
        flat = torch.as_strided(st, (trc.NBANDS * (nz + 2) * (H + 2) * pitch,),
                                (1,), st.storage_offset() - lpad).numpy()
        PB = (H + 2) * pitch
    wr, ww = RR_ROWS + 2, RR_COLS + 2
    ef = [x.numpy() for x in e4]
    out = {t: np.full((nz, H, W), np.nan) for t in trc._TKEYS}
    jj, ii = np.meshgrid(np.arange(RR_ROWS), np.arange(RR_COLS),
                         indexing="ij")
    for J0 in range(0, H, RR_ROWS):
        for I0 in range(0, W, RR_COLS):
            ring = {}
            for kk in range(-1, nz + 1):
                win = np.full((4, wr, ww), np.nan)
                for w in range(4):
                    for r in range(wr):
                        R = J0 + r
                        if R > H + 1:
                            continue
                        C = np.arange(I0, min(I0 + ww, W + 2))
                        win[w, r, :len(C)] = (0.0 if kk in (-1, nz)
                                              else ef[w][kk, R, C])
                ring[kk] = win
            Jg, Ig = J0 + jj, I0 + ii
            act = (Jg < H) & (Ig < W)
            Jc, Ic = np.minimum(Jg, H - 1), np.minimum(Ig, W - 1)

            def band(row, k):
                b, bk, bj, bi = row[:4]
                return flat[(b * (nz + 2) + k + bk + 1) * PB
                            + (Jc + bj) * pitch + lpad + Ic + bi]

            for m, t in enumerate(trc._TKEYS):
                if t not in targets:
                    continue
                views = trc.block_views(pack, m)
                keys = trc.gather_keys(True)
                for k in range(nz):
                    win = ring[k]
                    g = None
                    for n, row in enumerate(tt[m][:12]):
                        src, dk, oj, oi = row[4:]
                        bv = (band(row, k) if bands
                              else pack.blocks[m].numpy()[k, Jc, n * W + Ic])
                        v = bv * ring[k + dk][src, jj + oj, ii + oi]
                        g = v if g is None else g + v
                    if pack.real_matrix and k == 0:
                        x0 = None
                        for (n, boff, _), row in zip(trc._REAL_TERMS,
                                                     tt[m][12:]):
                            src, dk, oj, oi = row[4:]
                            bv = (band(row, 0) if bands else
                                  views[keys.index((n, boff))].numpy()[
                                      0, Jc, Ic])
                            v = bv * win[src, jj + oj, ii + oi]
                            x0 = v if x0 is None else x0 + v
                        g = g + x0
                    own = (m, jj + 1, ii + 1)
                    lo_ = pack.ud[m].numpy()[k - 1, Jc, Ic] if k else 0.0
                    hi = pack.ud[m].numpy()[k, Jc, Ic] if k < nz - 1 else 0.0
                    r = (bq[t].numpy()[k, Jc, Ic]
                         - pack.d[m].numpy()[k, Jc, Ic] * win[own]
                         - lo_ * ring[k - 1][own]
                         - hi * ring[k + 1][own] - g)
                    out[t][k, Jc[act], Ic[act]] = r[act]
    if mode == "residual":
        return {t: out[t] for t in targets}
    zs = {t: out[t][0::2] + out[t][1::2] for t in targets}
    if mode == "zsum":
        return zs
    return (zs[(0, 0)] + zs[(1, 0)]) + (zs[(0, 1)] + zs[(1, 1)])


@pytest.mark.parametrize("shape", [(6, 10, 14), (2, 6, 4)])
@pytest.mark.parametrize("real", [True, False])
def test_cuda_recipe_emulation_matches_plain(shape, real):
    """The CUDA kernels' term tables, flat addressing and loops (emulated
    in numpy: K1 and K2 per target, K3 per tile on its staged window
    ring, on the gather blocks and on the band stack, in its three modes)
    give the plain versions' values to the last bit."""
    cA, p, b = problem(*shape, seed=4)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    te = trc.extend_quads(tquads(p))
    tb = tquads(b)
    n = lambda x: None if x is None else x.numpy()
    for m, t in enumerate(trc._TKEYS):
        rb = tp.rblocks[m] if real else None
        e3 = tuple(te[k] for k in kt.gather_quads(t))
        args = (tp.blocks[m], tp.ud[m], tp.bet[m])
        want = kt.color_update_plain(e3, tb[t], *args, t, real, rb)
        got = _emulate_color_update([x.numpy() for x in e3], tb[t].numpy(),
                                    *(x.numpy() for x in args), None, t,
                                    real, n(rb), emit=False)
        close(got, want, 0)
        ws, wr = kt.color_update_emit_plain(e3, tb[t], *args, tp.d[m], t,
                                            real, rb)
        gs, gr = _emulate_color_update([x.numpy() for x in e3],
                                       tb[t].numpy(),
                                       *(x.numpy() for x in args),
                                       tp.d[m].numpy(), t, real, n(rb),
                                       emit=True)
        close(gs, ws, 0)
        close(gr, wr, 0)
    # K3, all four targets in one launch, on either operator layout
    e4 = tuple(te[k] for k in trc._TKEYS)
    for pack in (tp, trc.build_band_pack(torch.from_numpy(cA), real)):
        for mode in kt.RR_MODES:
            if mode != "residual" and shape[0] % 2:
                continue
            targets = ((0, 0), (1, 1)) if mode == "zsum" else trc._TKEYS
            want = kt.residual_restrict_plain(e4, tb, pack, mode, targets)
            got = _emulate_rr(e4, tb, pack, mode, targets)
            if mode == "coarse":
                close(got, want, 0)
            else:
                assert sorted(got) == sorted(want)
                for t in want:
                    close(got[t], want[t], 0)


def test_tiled_orchestrators_match_plain():
    """The kernel orchestration (plain versions on the CPU) == the plain
    relax_compact orchestrators."""
    cA, p, b = problem(6, 10, 14, seed=5)
    tp = trc.build_compact_pack(torch.from_numpy(cA), True)
    q0, bq = tquads(p), tquads(b)
    close_quads(kt.relax_compact_tiled_quads(q0, bq, tp, 2),
                trc.relax_compact_quads(q0, bq, tp, 2, "RB", True), 0)
    kq, kr = kt.relax_residual_tiled_quads(q0, bq, tp, 3)
    pq, pr = trc.relax_residual_compact_quads(q0, bq, tp, 3, True)
    close_quads(kq, pq, 0)
    close_quads(kr, pr, 0)
    kq, kcb = kt.relax_residual_restrict_tiled_quads(q0, bq, tp, 3)
    pq, pcb = trc.relax_residual_restrict_compact_quads(q0, bq, tp, 3, True)
    close_quads(kq, pq, 0)
    close(kcb, pcb, 0)
    close(kt.residual_restrict_tiled_quads(q0, bq, tp),
          trc.restrict_quads_to_full(trc.residual_quads(q0, bq, tp, True)),
          0)
    close_quads(kt.residual_tiled_quads(q0, bq, tp),
                trc.residual_quads(q0, bq, tp, True), 0)


@pytest.mark.parametrize("real", [True, False])
def test_fc_quads_match_jax(real):
    """Four-colour sweeps in quad-parity form (one target quad a colour,
    the reference order) against JAX's relax_compact_quads and
    relax_compact; the K1 orchestration (plain versions on the CPU) gives
    the plain sweep bit for bit; GS has no quad form."""
    cA, p, b = problem(6, 10, 14, seed=6)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    assert trc.colour_targets("FC") == jrc._FC_TARGETS
    got = trc.relax_compact_quads(tquads(p), tquads(b), tp, 2, "FC", real)
    close_quads(got, jrc.relax_compact_quads(jquads(p), jquads(b), jp, 2,
                                             "FC", real))
    close(trc.relax_compact(torch.from_numpy(p), torch.from_numpy(b), None,
                            2, "FC", real, pack=tp),
          jrc.relax_compact(jnp.asarray(p), jnp.asarray(b), None, 2, "FC",
                            real, pack=jp))
    close_quads(kt.relax_compact_tiled_quads(tquads(p), tquads(b), tp, 2,
                                             "FC"), got, 0)
    with pytest.raises(NotImplementedError, match="RB and FC"):
        trc.relax_compact_quads(tquads(p), tquads(b), tp, 1, "GS", real)


def test_fc_tiled_orchestration_matches_pallas():
    """The K1 orchestration in the FC ordering against JAX's tiled
    orchestration (its Pallas kernel in interpret mode), f64."""
    cA, p, b = problem(8, 16, 16, seed=7)
    jp = jrc.build_compact_pack(jnp.asarray(cA), True)
    tp = trc.build_compact_pack(torch.from_numpy(cA), True)
    close_quads(kt.relax_compact_tiled_quads(tquads(p), tquads(b), tp, 2,
                                             "FC"),
                jtiled.relax_compact_tiled_quads(jquads(p), jquads(b), jp, 2,
                                                 "FC", True, interpret=True))
