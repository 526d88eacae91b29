"""Quad-parity layer and the kernels' plain versions == JAX, in float64.

The plain versions of K1-K3 are held to the Pallas kernels run in
interpret mode (as tests/test_pallas_tiled.py and
tests/test_fused_residual.py run them), on the gather blocks and on the
band stack (equal bit for bit).  The CUDA kernels cannot run here; their
index recipe (``band_term_table``) and their loops are emulated below with
flat-array addressing exactly as csrc/relax_tiled.cu (K1, K2: a colour a
launch, on its staged window ring) and csrc/rr_fused.cu (K3, on its
staged window ring) write them, and held to the plain versions.

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


BUILD = {"blocks": trc.build_compact_pack, "bands": trc.build_band_pack}
# every colour of both orderings: the RB pairs, then the FC single targets
COLOURS = trc.colour_targets("RB") + trc.colour_targets("FC")


@pytest.mark.parametrize("layout", list(BUILD))
@pytest.mark.parametrize("real", [True, False])
def test_kernel_plain_versions_match_pallas(real, layout):
    """K1/K2 plain versions, a colour at a time (the RB pairs and the FC
    single targets; K2 the RB pairs), and K3's plain version in its
    z-pair mode, one target at a time, == the Pallas kernels per target
    (interpret mode), on either operator layout; on the band stack K1 and
    K2 equal their gather-block results bit for bit."""
    cA, p, b = problem(8, 16, 16, seed=3)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = BUILD[layout](torch.from_numpy(cA), real)
    gp = trc.build_compact_pack(torch.from_numpy(cA), real)
    assert (tp.blocks is None) == (layout == "bands")
    je, te = jrc.extend_quads(jquads(p)), trc.extend_quads(tquads(p))
    jb, tb = jquads(b), tquads(b)
    want, wemit = {}, {}
    for m, t in enumerate(trc._TKEYS):
        jrb = jp.rblocks[m] if real else None
        je3 = tuple(je[k] for k in jtiled._gather_quads(t))
        want[t] = jtiled.color_update_tiled(je3, jb[t], jp.blocks[m],
                                            jp.ud[m], jp.bet[m], t, real,
                                            interpret=True, rb_t=jrb)
        wemit[t] = jtiled.color_update_tiled_emit(
            je3, jb[t], jp.blocks[m], jp.ud[m], jp.bet[m], jp.d[m], t, real,
            interpret=True, rb_t=jrb)
        w = jtiled._rr_one(tuple(je[k] for k in jrc._TKEYS), jb[t],
                           jp.blocks[m], jp.d[m], jp.ud[m], t, real,
                           interpret=True, rb_t=jrb)
        close(kt.residual_restrict(tuple(te[k] for k in trc._TKEYS), tb, tp,
                                   "zsum", (t,))[t], w)
    for colour in COLOURS:
        got = kt.color_update(te, tb, tp, colour)
        ref = kt.color_update(te, tb, gp, colour)
        assert sorted(got) == sorted(colour)
        for t in colour:
            close(got[t], want[t])
            assert torch.equal(got[t], ref[t])
        if len(colour) == 1:
            continue
        gs, gr = kt.color_update_emit(te, tb, tp, colour)
        rs, rr = kt.color_update_emit(te, tb, gp, colour)
        for t in colour:
            ws, wr = wemit[t]
            close(gs[t], ws)
            close(gr[t], wr, 1e-12 * np.abs(np.asarray(jb[t])).max()
                  / np.abs(np.asarray(wr)).max())
            assert torch.equal(gs[t], rs[t]) and torch.equal(gr[t], rr[t])


# ---- CPU emulation of csrc/relax_tiled.cu (flat addressing, per tile) ----

# csrc/relax_tiled.cu's tile width (its rows per tile: 1, 2 or 4)
K1_COLS = 64


def _stack_storage(st, nz, H, W):
    """The band stack's flat storage from its first storage column, as
    the kernels address it: (flat, lpad, pitch)."""
    lpad, pitch = trc.band_layout(W, st.element_size())
    flat = torch.as_strided(st, (trc.NBANDS * (nz + 2) * (H + 2) * pitch,),
                            (1,), st.storage_offset() - lpad)
    if flat.dtype == torch.bfloat16:
        flat = flat.float()      # the upcast at read, exact
    return flat.numpy(), lpad, pitch


def _emulate_colour(e4, bq, pack, targets, emit, rows):
    """csrc/relax_tiled.cu in numpy: per tile of rows x K1_COLS columns,
    the window ring of the two sibling quads as the kernel stages it
    (entries it does not stage are NaN, zero planes -1 and nz), the
    operator read in place (the band stack's flat storage at the band term
    table's offsets, or the gather blocks; bfloat16 upcast), the plane-0
    'real' terms from the diagonal sibling in place; the forward pass
    keeps c = ud * bet and g per plane, the back substitution emits
    r_{k+1} once x_k is known, then r_0.  Returns ({t: x}, {t: r})."""
    t0 = targets[0]
    nz, H, W = bq[t0].shape
    layout, holder, bet, _ = kt.colour_operator(pack, bq[t0].dtype, emit)
    a0, b0 = t0
    w0, w1 = 2 * (1 - a0) + b0, 2 * a0 + (1 - b0)
    ef = [x.numpy() for x in e4]
    if layout == "bands":
        flat, lpad, pitch = _stack_storage(holder.ebands, nz, H, W)
        PB = (H + 2) * pitch
    wr, ww = rows + 2, K1_COLS + 2
    out = {t: np.full((nz, H, W), np.nan) for t in targets}
    res = {t: np.full((nz, H, W), np.nan) for t in targets}
    jj, ii = np.meshgrid(np.arange(rows), np.arange(K1_COLS), indexing="ij")
    keys = trc.gather_keys(True)
    for J0 in range(0, H, rows):
        for I0 in range(0, W, K1_COLS):
            ring = {}
            for kk in range(-1, nz + 1):
                win = np.full((wr, 2, ww), np.nan, ef[0].dtype)
                for r in range(wr):
                    R = J0 + r
                    if R > H + 1:
                        continue
                    C = np.arange(I0, min(I0 + ww, W + 2))
                    for w, qd in enumerate((w0, w1)):
                        win[r, w, :len(C)] = (0.0 if kk in (-1, nz)
                                              else ef[qd][kk, R, C])
                ring[kk] = win
            Jg, Ig = J0 + jj, I0 + ii
            act = (Jg < H) & (Ig < W)
            Jc, Ic = np.minimum(Jg, H - 1), np.minimum(Ig, W - 1)
            for t in targets:
                m = trc._TKEYS.index(t)
                col = lambda x: x.float().numpy()[:, Jc, Ic] \
                    if x.dtype == torch.bfloat16 else x.numpy()[:, Jc, Ic]
                bq_, ud_, bet_, d_ = (col(bq[t]), col(pack.ud[m]),
                                      col(bet[m]), col(pack.d[m]))
                if layout == "blocks":
                    views = [col(v) for v in trc.block_views(
                        pack, m, lp=holder is not pack)]

                def band(row, k, n):
                    if layout == "blocks":
                        return views[n][k]
                    bi_, bk, bj, bi = row[:4]
                    return flat[(bi_ * (nz + 2) + k + bk + 1) * PB
                                + (Jc + bj) * pitch + lpad + Ic + bi]

                tt = ksf.band_term_table(t)
                x, xs, cs, gs = None, [], [], []
                for k in range(nz):
                    g = None
                    for n, row in enumerate(tt[:12]):
                        src, dk, oj, oi = row[4:]
                        assert src in (w0, w1)
                        v = band(row, k, n) * ring[k + dk][
                            jj + oj, 0 if src == w0 else 1, ii + oi]
                        g = v if g is None else g + v
                    if pack.real_matrix and k == 0:
                        x0 = None
                        for (nb, boff, _), row in zip(trc._REAL_TERMS,
                                                      tt[12:]):
                            src, dk, oj, oi = row[4:]
                            assert src == 3 - m and dk == 0
                            v = band(row, 0, keys.index((nb, boff))) \
                                * ef[src][0, Jc + oj, Ic + oi]
                            x0 = v if x0 is None else x0 + v
                        g = g + x0
                    rhs = bq_[k] - g
                    x = (rhs * bet_[k] if k == 0
                         else (rhs - ud_[k - 1] * x) * bet_[k])
                    xs.append(x)
                    gs.append(g)
                    if k < nz - 1:
                        cs.append(ud_[k] * bet_[k])
                sol, r = np.empty((nz,) + Jc.shape), np.empty((nz,) + Jc.shape)
                sol[nz - 1] = x1 = x
                x2 = hi = 0.0
                for k in range(nz - 2, -1, -1):
                    x0 = xs[k] - cs[k] * x1
                    sol[k] = x0
                    r[k + 1] = (bq_[k + 1] - d_[k + 1] * x1 - ud_[k] * x0
                                - hi * x2 - gs[k + 1])
                    hi = ud_[k]
                    x2, x1 = x1, x0
                r[0] = bq_[0] - d_[0] * x1 - 0.0 * 0.0 - hi * x2 - gs[0]
                out[t][:, Jc[act], Ic[act]] = sol[:, act]
                res[t][:, Jc[act], Ic[act]] = r[:, act]
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


@pytest.mark.parametrize("layout", ["blocks", "bands", "bands bf16"])
@pytest.mark.parametrize("shape", [(6, 10, 14), (2, 6, 4)])
@pytest.mark.parametrize("real", [True, False])
def test_cuda_recipe_emulation_matches_plain(shape, real, layout):
    """The CUDA kernels' term tables, flat addressing and loops (emulated
    in numpy: K1 a colour a launch, the two targets of an RB colour or one
    of FC, and K2 on the RB colours, on tiles of 1 and 4 rows with their
    staged window ring; K3 per tile on its staged window ring; on the
    gather blocks and on the band stack, K1 also on the bfloat16 stack
    beside float32 state; K3 in its three modes) give the plain versions'
    values to the last bit."""
    cA, p, b = problem(*shape, seed=4)
    lp = layout.endswith("bf16")
    if lp:
        cA, p, b = (x.astype(np.float32) for x in (cA, p, b))
    tp = BUILD[layout.split()[0]](torch.from_numpy(cA), real)
    if lp:
        tp = trc.attach_lp(tp)
    te = trc.extend_quads(tquads(p))
    tb = tquads(b)
    e4 = tuple(te[k] for k in trc._TKEYS)
    for colour in COLOURS:
        want = kt.color_update_plain(te, tb, tp, colour)
        emit = len(colour) == 2 and not lp
        if emit:
            ws, wr = kt.color_update_emit_plain(te, tb, tp, colour)
            assert all(torch.equal(ws[t], want[t]) for t in colour)
        for rows in (1, 4):
            got, res = _emulate_colour(e4, tb, tp, colour, False, rows)
            for t in colour:
                close(got[t], want[t], 0)
            if emit:
                _, res = _emulate_colour(e4, tb, tp, colour, True, rows)
                for t in colour:
                    close(res[t], wr[t], 0)
    if lp:
        return
    # K3, all four targets in one launch, on the pack's operator layout
    for mode in kt.RR_MODES:
        if mode != "residual" and shape[0] % 2:
            continue
        targets = ((0, 0), (1, 1)) if mode == "zsum" else trc._TKEYS
        want = kt.residual_restrict_plain(e4, tb, tp, mode, targets)
        got = _emulate_rr(e4, tb, tp, mode, targets)
        if mode == "coarse":
            close(got, want, 0)
        else:
            assert sorted(got) == sorted(want)
            for t in want:
                close(got[t], want[t], 0)


@pytest.mark.parametrize("layout", list(BUILD))
def test_tiled_orchestrators_match_plain(layout):
    """The kernel orchestration (plain versions on the CPU) == the plain
    relax_compact orchestrators, on either operator layout."""
    cA, p, b = problem(6, 10, 14, seed=5)
    tp = BUILD[layout](torch.from_numpy(cA), True)
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


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_pcr_quads_match_jax(real, lp):
    """``tridiag_method='pcr'`` (parallel cyclic reduction on each colour's
    columns) against JAX's: RB and FC sweeps in quad form and the
    full-layout form, on a gather pack and on one with the low-precision
    operator attached, which PCR ignores (the true operator, as JAX's
    relax_compact.py:448); the emitted-residual and restrict orchestrators
    on the gather pack (both packages refuse them a low-precision
    pack)."""
    cA, p, b = problem(6, 10, 14, seed=7)
    jp = jrc.build_compact_pack(jnp.asarray(cA), real)
    tp = trc.build_compact_pack(torch.from_numpy(cA), real)
    if lp:
        jp, tp = jrc.attach_lp(jp), trc.attach_lp(tp)
    pcr = dict(tridiag_method="pcr")
    for kind in ("RB", "FC"):
        got = trc.relax_compact_quads(tquads(p), tquads(b), tp, 2, kind,
                                      real, **pcr)
        close_quads(got, jrc.relax_compact_quads(jquads(p), jquads(b), jp,
                                                 2, kind, real, **pcr))
        close(trc.relax_compact(torch.from_numpy(p), torch.from_numpy(b),
                                None, 2, kind, real, pack=tp, **pcr),
              jrc.relax_compact(jnp.asarray(p), jnp.asarray(b), None, 2,
                                kind, real, pack=jp, **pcr))
    if lp:
        close_quads(got, trc.relax_compact_quads(
            tquads(p), tquads(b), tp._replace(lp=None), 2, "FC", real,
            **pcr), 0)
        return
    tq, tr = trc.relax_residual_compact_quads(tquads(p), tquads(b), tp, 2,
                                              real, **pcr)
    jq, jr = jrc.relax_residual_compact_quads(jquads(p), jquads(b), jp, 2,
                                              real, **pcr)
    close_quads(tq, jq)
    close_quads(tr, jr)
    tq, tcb = trc.relax_residual_restrict_compact_quads(
        tquads(p), tquads(b), tp, 2, real, **pcr)
    jq, jcb = jrc.relax_residual_restrict_compact_quads(
        jquads(p), jquads(b), jp, 2, real, **pcr)
    close_quads(tq, jq)
    close(tcb, jcb)
