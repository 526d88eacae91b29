"""The roofline probes (K10) on the CPU: their plain versions against numpy
transcriptions of the TPU probes in scripts/micro_roofline.py, and the
micro entry point's check.

The JAX probes are local functions of that script's main() and cannot be
imported; the transcriptions below cite their lines.  ``copy_kernel``
(micro_roofline.py:112-118) adds one element of each streamed block into
the output: on the card a load whose value is unused is dropped, so the
port's ``dma_only`` adds EVERY value it loads, in K1's per-plane order,
over the same streams per variant (:124-134).  ``fma_kernel`` (:251-260)
is transcribed in float32 with the multiply and the add rounded apart, as
XLA writes them; the port's kernel rounds each FMA once, so the two agree
within roofline.FMA_RTOL.
"""

import numpy as np
import pytest
import torch

import mgroms_tpu_torch.ops.kernels.roofline as rl
from mgroms_tpu_torch.ops import relax_compact as rc
from mgroms_tpu_torch.ops.kernels.relax_tiled import gather_quads, term_table

torch.set_num_threads(1)


def operands(nz, H, W, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0.5, 1.5, s).astype(np.float32)
    return dict(e3=[f(nz, H + 2, W + 2) for _ in range(3)], bq=f(nz, H, W),
                blocks=f(nz, H, 12 * W), ud=f(nz - 1, H, W),
                bet=f(nz, H, W), gam=f(nz - 1, H, W), rb=f(1, H, 2 * W))


def np_dma_only(o, which, gam, real):
    """micro_roofline.py:123-144's streams per variant ("all": the three
    state windows, the wide blocks, ud, bet, gam and bq; "windows": the
    windows and bq; "blocks": the blocks and bq), every value K1 loads
    from them added in K1's per-plane order (relax_tiled.cu gather, then
    the Thomas operands)."""
    e3, bq = o["e3"], o["bq"]
    nz, H, W = bq.shape
    tt = term_table(rl.TARGET, gather_quads(rl.TARGET))
    out = np.empty_like(bq)
    for k in range(nz):
        acc = bq[k].copy()
        if which != "blocks":
            for m, (src, dk, oj, oi, _) in enumerate(tt):
                if m >= 12 and not (real and k == 0):
                    break
                kk = k + dk
                v = (e3[src][kk, oj: oj + H, oi: oi + W] if 0 <= kk < nz
                     else np.zeros((H, W), np.float32))
                acc = acc + v
        if which != "windows":
            for m in range(12):
                acc = acc + o["blocks"][k, :, m * W: (m + 1) * W]
            if real and k == 0:
                acc = acc + o["rb"][0, :, :W]
                acc = acc + o["rb"][0, :, W:]
        if which == "all":
            if k > 0:
                acc = acc + o["ud"][k - 1]
            acc = acc + o["bet"][k]
            if gam and k < nz - 1:
                acc = acc + o["gam"][k]
        out[k] = acc
    return out


@pytest.mark.parametrize("which", rl.WHICH)
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("gam", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_dma_only_plain_matches_numpy(which, real, gam, lp):
    """dma_only_plain (and the CPU wrapper) == the numpy transcription,
    bit for bit, at a ragged quad shape (nz = 5, 6 x 40), with float32 or
    (lp) bfloat16 blocks."""
    o = operands(5, 6, 40, seed=len(which) + 2 * real + 4 * gam)
    t = {k: (tuple(torch.from_numpy(x) for x in v) if k == "e3"
             else torch.from_numpy(v)) for k, v in o.items()}
    if lp:
        for k in ("blocks", "rb"):
            t[k] = t[k].to(torch.bfloat16)
            o[k] = t[k].float().numpy()
    args = (t["e3"], t["bq"], t["blocks"], t["ud"], t["bet"],
            t["gam"] if gam else None, which, t["rb"] if real else None)
    want = np_dma_only(o, which, gam, real)
    np.testing.assert_array_equal(rl.dma_only_plain(*args).numpy(), want)
    np.testing.assert_array_equal(rl.dma_only(*args).numpy(), want)


def test_dma_only_rejects_unknown_variant():
    o = operands(3, 2, 4, seed=0)
    t = {k: (tuple(torch.from_numpy(x) for x in v) if k == "e3"
             else torch.from_numpy(v)) for k, v in o.items()}
    with pytest.raises(ValueError):
        rl.dma_only(t["e3"], t["bq"], t["blocks"], t["ud"], t["bet"], None,
                    "state")


def np_dma_only_bands(cp, e, bq, colour):
    """dma_only_bands's sums from the gather-block pack ``cp`` (numpy):
    per target of the RB colour, the RHS, its 12 base-term blocks in
    gather-key order (upcast), for the first target the two sibling
    quads' own values, ud below the top plane, then bet."""
    lp = cp.lp is not None
    blocks = cp.lp.blocks if lp else cp.blocks
    bet = cp.lp.bet if lp else cp.bet
    out = {}
    for s, t in enumerate(colour):
        m = rc._TKEYS.index(t)
        nz, H, W = bq[t].shape
        blk = blocks[m].float().numpy()
        acc = bq[t].numpy().copy()
        for k in range(12):
            acc = acc + blk[:, :, k * W:(k + 1) * W]
        if s == 0:
            for q in gather_quads(t)[:2]:
                acc = acc + e[q].numpy()[:, 1:-1, 1:-1]
        acc[:-1] = acc[:-1] + cp.ud[m].numpy()
        out[t] = acc + bet[m].numpy()
    return out


@pytest.mark.parametrize("colour", [0, 1])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_dma_only_bands_plain_matches_numpy(colour, real, lp):
    """dma_only_bands_plain (and the CPU wrapper) on the band stack == the
    numpy sums over the same level's gather blocks, bit for bit, for each
    RB colour at a ragged quad shape (nz = 5, 3 x 7), with the float32 or
    (lp) the bfloat16 operator."""
    rng = np.random.default_rng(colour + 2 * real + 4 * lp)
    nz, H, W = 5, 3, 7
    cA = torch.from_numpy(rng.uniform(-0.1, 0.1, (8, nz, 2 * H + 2,
                                                 2 * W + 2)).astype(
        np.float32))
    cA[0] -= 4.0
    bp, cp = rc.build_band_pack(cA, real), rc.build_compact_pack(cA, real)
    if lp:
        bp, cp = rc.attach_lp(bp), rc.attach_lp(cp)
    assert bp.blocks is None and (not lp or bp.lp.blocks is None)
    f = lambda: torch.from_numpy(rng.standard_normal(
        (nz, 2 * H, 2 * W)).astype(np.float32))
    e, bq = rc.extend_quads(rc.split_quads(f())), rc.split_quads(f())
    col = rc.colour_targets("RB")[colour]
    want = np_dma_only_bands(cp, e, bq, col)
    for got in (rl.dma_only_bands_plain(e, bq, bp, col),
                rl.dma_only_bands(e, bq, bp, col)):
        assert sorted(got) == sorted(col)
        for t in col:
            np.testing.assert_array_equal(got[t].numpy(), want[t])


def np_fma_kernel(x):
    """micro_roofline.py:251-260 in float32 numpy."""
    accs = [x * np.float32(1.0 + 0.001 * i) for i in range(rl.FMA_CHAINS)]
    for _ in range(rl.FMA_REPS):
        for i in range(rl.FMA_CHAINS):
            accs[i] = accs[i] * np.float32(1.000001) + x
    s = accs[0]
    for i in range(1, rl.FMA_CHAINS):
        s = s + accs[i]
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_run_plain_matches_numpy(seed):
    """fma_run_plain (float64, rounded once at the end) and the CPU wrapper
    == the float32 transcription within FMA_RTOL x max|numpy| on the
    (8, 8, 512) block."""
    x = np.random.default_rng(seed).uniform(0.5, 1.5, rl.FMA_BLOCK).astype(
        np.float32)
    want = np_fma_kernel(x)
    for got in (rl.fma_run_plain(torch.from_numpy(x)),
                rl.fma_run(torch.from_numpy(x))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rl.FMA_RTOL * np.abs(want).max())


def np_step_floor(x, nsteps):
    """The step-floor probe (roofline.cu step_floor_kernel) column by
    column in float32: in step s the columns with (j + i + s) even, each
    from the state before the step."""
    x = x.copy()
    nz, ny, nx = x.shape
    h = np.float32(rl.FLOOR_H)
    for step in range(nsteps):
        old = x.copy()
        for j in range(ny):
            for i in range(nx):
                if (j + i + step) % 2:
                    continue
                acc = np.float32(old[0, max(j - 1, 0), i] * h)
                for k in range(nz):
                    acc = np.float32(np.float32(acc * h) + old[k, j, i])
                x[0, j, i] = acc
    return x


@pytest.mark.parametrize("shape,nsteps", [((2, 32, 32), 6), ((4, 4, 4), 9),
                                          ((1, 5, 7), 4), ((3, 6, 5), 5)])
def test_step_floor_plain_matches_numpy(shape, nsteps):
    """step_floor_plain and the CPU wrapper == the column-by-column
    transcription bit for bit, at K6's coarsest shapes and ragged ones."""
    x = np.random.default_rng(sum(shape)).uniform(0.5, 1.5, shape).astype(
        np.float32)
    want = np_step_floor(x, nsteps)
    got, blocks = rl.step_floor(torch.from_numpy(x), nsteps)
    assert blocks == 1
    assert np.array_equal(rl.step_floor_plain(torch.from_numpy(x),
                                              nsteps).numpy(), want)
    assert np.array_equal(got.numpy(), want)
    assert rl.LAUNCHES["step_floor"] == 0


def test_counts():
    """The flop count of fma_run (micro_roofline.py:283) and the bytes
    dma_only must move at the CUC level-0 quad shape; step_floor's flops
    (a multiply and nz multiply-adds per active column)."""
    assert rl.fma_flops() == 2.0 * 8 * 64 * 256 * 8 * 8 * 512
    assert rl.step_floor_flops((2, 32, 32), 80) == 80 * 512 * 5
    assert rl.step_floor_flops((3, 3, 3), 3) == (5 + 4 + 5) * 7
    nz, H, W = 64, 512, 512
    q, e = nz * H * W * 4, nz * (H + 2) * (W + 2) * 4
    assert rl.dma_only_bytes(nz, H, W, "windows") == 2 * q + 3 * e
    assert rl.dma_only_bytes(nz, H, W, "blocks") == \
        2 * q + 12 * q + 2 * H * W * 4
    assert rl.dma_only_bytes(nz, H, W, "all", real=False) == \
        2 * q + 3 * e + 12 * q + (nz - 1) * H * W * 4 + q
    # an RB colour reads all 24 band quads, each once
    for lp, vb in ((False, 4), (True, 2)):
        assert rl.dma_only_bands_bytes(
            nz, H, W, rc.colour_targets("RB")[0], lp) == \
            24 * nz * (H + 2) * (W + 2) * vb + 2 * q \
            + 2 * (3 * q - H * W * 4) + 2 * q


def test_micro_roofline_check_on_cpu():
    """The micro entry point's check at a tiny size on the CPU."""
    from mgroms_tpu_torch.scripts import micro_roofline as mr
    rows = mr.check(torch.device("cpu"))
    assert set(rows) == {"dma_only_all", "dma_only_windows",
                         "dma_only_blocks", "dma_only_bands",
                         "dma_only_bands_bf16", "fma_run"}
    assert all(v == 0.0 for v in rows.values()), rows


def np_dma_only_ring(o, which, gam, real, tile=rl.WINDOW_TILE,
                     ring=rl.WINDOW_RING):
    """csrc/roofline.cu dma_only_ring_kernel's recipe in numpy (the
    windows and all forms): per block of ``tile`` columns, each plane's
    three extended-quad windows ((rows + 2) x (cols + 2), NaN where not
    staged) staged into a ring of ``ring`` slots (planes 0 .. ring-3
    first, plane k+1+(ring-3) into plane k-2's slot at step k), the terms
    read from the slots of planes k-1 .. k+1 (a read of a plane its slot
    does not hold fails), then the coalesced operands, added in
    dma_only_plain's order in float32."""
    e3, bq = o["e3"], o["bq"]
    nz, H, W = bq.shape
    tj, ti = tile
    ahead = ring - 3
    tt = term_table(rl.TARGET, gather_quads(rl.TARGET))
    out = np.full_like(bq, np.nan)
    for J0 in range(0, H, tj):
        for I0 in range(0, W, ti):
            rows, cols = min(tj, H - J0), min(ti, W - I0)
            slots = [None] * ring

            def stage(k):
                win = np.full((3, tj + 2, ti + 2), np.nan, np.float32)
                win[:, :rows + 2, :cols + 2] = [
                    e[k, J0:J0 + rows + 2, I0:I0 + cols + 2] for e in e3]
                slots[k % ring] = (k, win)

            for q in range(min(ahead + 1, nz)):
                stage(q)
            for k in range(nz):
                if k + 1 + ahead < nz:
                    stage(k + 1 + ahead)
                acc = bq[k, J0:J0 + rows, I0:I0 + cols].copy()
                for m, (src, dk, oj, oi, _) in enumerate(tt):
                    if m >= 12 and not (real and k == 0):
                        break
                    kk = k + dk
                    if 0 <= kk < nz:
                        held = slots[kk % ring]
                        assert held[0] == kk, (kk, held[0])
                        acc = acc + held[1][src, oj:oj + rows, oi:oi + cols]
                    else:
                        acc = acc + np.float32(0)
                if which == "all":
                    cut = (slice(J0, J0 + rows), slice(I0, I0 + cols))
                    for m in range(12):
                        acc = acc + o["blocks"][k][cut[0], m * W + I0:
                                                   m * W + I0 + cols]
                    if real and k == 0:
                        acc = acc + o["rb"][0][cut[0], I0:I0 + cols]
                        acc = acc + o["rb"][0][cut[0], W + I0:W + I0 + cols]
                    if k > 0:
                        acc = acc + o["ud"][k - 1][cut]
                    acc = acc + o["bet"][k][cut]
                    if gam and k < nz - 1:
                        acc = acc + o["gam"][k][cut]
                out[k, J0:J0 + rows, I0:I0 + cols] = acc
    return out


@pytest.mark.parametrize("shape", [(5, 6, 40), (1, 9, 33), (3, 17, 70),
                                   (2, 8, 32), (9, 3, 5)])
@pytest.mark.parametrize("which", ["windows", "all"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_dma_only_ring_recipe_matches_plain(shape, which, real, lp):
    """The windows' ring recipe (the windows and all forms) ==
    dma_only_plain bit for bit at ragged (H, W) against the 8 x 32 block
    tile, nz from 1 to 9 (the ring wraps), with float32 or bfloat16
    blocks."""
    o = operands(*shape, seed=sum(shape) + len(which))
    if lp:
        for k in ("blocks", "rb"):
            o[k] = torch.from_numpy(o[k]).to(torch.bfloat16).float().numpy()
    t = {k: (tuple(torch.from_numpy(x) for x in v) if k == "e3"
             else torch.from_numpy(v)) for k, v in o.items()}
    want = rl.dma_only_plain(t["e3"], t["bq"], t["blocks"], t["ud"],
                             t["bet"], t["gam"], which,
                             t["rb"] if real else None).numpy()
    np.testing.assert_array_equal(np_dma_only_ring(o, which, True, real),
                                  want)
