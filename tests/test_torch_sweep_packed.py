"""The packed-stream colour-fused sweep (K8) and its packer (K9) == JAX, on
the CPU.

JAX's K8/K9 run in Pallas interpret mode (``interpret=True``); the
port's wrappers run their plain versions on CPU tensors.  The CUDA
kernel's recipe (csrc/sweep_packed.cu: column windows, the staged band and
state windows, colour 0 on its overhang kept on chip with the mirror cells
filled, colour 1 reading it there and its plane-0 siblings patched by the
e1 halo rules) is emulated below in scalar numpy and held to the plain
version to the last bit; its launcher's window choice and shared-memory
count are pinned.

Tolerances: 1e-14 x max|JAX| in float64 (the same term order; measured
<= 1.1e-16 of the plain sweep); 1e-6 x max|JAX| with bfloat16 bands in
float32; layouts and packs exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgroms_tpu.ops.pallas.sweep_packed as jsp
import mgroms_tpu.ops.relax_compact as jrc
import mgroms_tpu_torch.ops.kernels.sweep_packed as sp
import mgroms_tpu_torch.ops.relax_compact as trc
from mgroms_tpu_torch.convert import (pack_from_numpy,
                                      packed_operator_from_numpy)

torch.set_num_threads(1)


def close(got, want, tol):
    want = np.asarray(want, dtype=np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def problem(nz, ny, nx, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    return tuple(x.astype(dtype) for x in (
        cA, rng.standard_normal((nz, ny, nx)),
        rng.standard_normal((nz, ny, nx))))


def jax_operator(cA, real, chunks, band_dtype=None):
    """JAX's pack and packed operator at its own plan (tj from its VMEM
    model), ``chunks`` lane chunks."""
    nz, ny, nx = cA.shape[1], cA.shape[2] - 2, cA.shape[3] - 2
    pack = jrc.build_compact_pack(jnp.asarray(cA), real)
    sop = jsp.build_sweep_operator(jnp.asarray(cA), pack, nz, ny // 2,
                                   nx // 2, band_dtype=band_dtype,
                                   force_chunks=chunks, min_chunk=8)
    assert sop is not None and sop.plan.nchunks == chunks
    return pack._replace(sweep=sop)


def port_operator(cA, real, tj, nchunks, band_dtype=None):
    t = torch.from_numpy(cA)
    nz, ny, nx = cA.shape[1], cA.shape[2] - 2, cA.shape[3] - 2
    pack = trc.build_compact_pack(t, real)
    return pack, sp.build_sweep_operator(t, pack, nz, ny // 2, nx // 2,
                                         tj=tj, nchunks=nchunks,
                                         band_dtype=band_dtype)


def jquads(x):
    return jrc.split_quads(jnp.asarray(x))


def tquads(x):
    return trc.split_quads(torch.from_numpy(x))


# -------------------------------------------------------------------- (a)

@pytest.mark.parametrize("real", [True, False])
def test_layout_equals_jax_at_its_plan(real):
    """build_sweep_operator at JAX's (tj, nchunks), on JAX's pack (carried
    over by pack_from_numpy: XLA may contract the pivots' recurrence on
    the CPU, an ulp off the port's) == JAX's pband, ppiv, pseam exactly
    (float64, 2 chunks)."""
    cA, _, _ = problem(4, 32, 32, seed=0)
    jp = jax_operator(cA, real, 2)
    plan = jp.sweep.plan
    fields = {f: [np.asarray(x) for x in getattr(jp, f)]
              for f in ("blocks", "d", "ud", "bet")
              + (("rblocks",) if real else ())}
    pack = pack_from_numpy(fields, real, device="cpu")
    sop = sp.build_sweep_operator(torch.from_numpy(cA), pack, 4, 16, 16,
                                  tj=plan.tj, nchunks=plan.nchunks)
    for name in ("pband", "ppiv", "pseam"):
        for got, want in zip(getattr(sop, name), getattr(jp.sweep, name)):
            close(got, want, 0)


# -------------------------------------------------------------------- (b)

@pytest.mark.parametrize("mode", ["main", "seam"])
def test_pack_streams_equals_jax(mode):
    """pack_streams_plain (and the library form chip_smoke.py times) ==
    JAX's _pack_streams (interpret) exactly: the state stream's main mode
    (3 tiles, 2 chunks) and the RHS seam mode."""
    rng = np.random.default_rng(1)
    nz, H, W, tj, C = 3, 12, 16, 4, 2
    if mode == "main":
        shape, rows, wpad = (nz, H + 4, W + 4), tj + 4, 4
    else:
        shape, rows, wpad = (nz, H + 2, W + 2), tj + 2, -2
    arrs = [rng.standard_normal(shape) for _ in range(3)]
    want = jsp._pack_streams(tuple(jnp.asarray(a) for a in arrs), tj, rows,
                             W // C, wpad, C, interpret=True)
    ta = tuple(torch.from_numpy(a) for a in arrs)
    got = sp.pack_streams(ta, tj, rows, W // C, wpad, C)
    lib = sp.pack_streams_library(ta, tj, rows, W // C, wpad, C)
    assert len(got) == len(want) == C
    for g, li, w in zip(got, lib, want):
        close(g, w, 0)
        assert torch.equal(li, g)


# -------------------------------------------------------------------- (c)

@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("real", [True, False])
def test_packed_sweep_matches_jax(real, chunks):
    """relax_packed_sweep (the port's default plan: 2 row tiles of 8) ==
    JAX's relax_fused_sweep (interpret, its plan) over 2 sweeps in
    float64 at quads (4, 16, 16), within 1e-14 x max|JAX|."""
    cA, p, b = problem(4, 32, 32, seed=2)
    jp = jax_operator(cA, real, chunks)
    want = jsp.relax_fused_sweep(jquads(p), jquads(b), jp, 2, real,
                                 interpret=True)
    pack, sop = port_operator(cA, real, sp.DEFAULT_TJ, chunks)
    got = sp.relax_packed_sweep(tquads(p), tquads(b), pack, sop, 2)
    for t in trc._TKEYS:
        close(got[t], want[t], 1e-14)


# -------------------------------------------------------------------- (d)

def test_bf16_packed_sweep_matches_jax():
    """bfloat16 bands at float32 state (consistent pivots) == JAX's
    packed sweep with band_dtype=bfloat16 (interpret) within 1e-6 x
    max|JAX|, one sweep."""
    cA, p, b = problem(4, 32, 32, seed=3, dtype=np.float32)
    jp = jax_operator(cA, True, 1, band_dtype=jnp.bfloat16)
    want = jsp.relax_fused_sweep(jquads(p), jquads(b), jp, 1, True,
                                 interpret=True)
    pack, sop = port_operator(cA, True, 4, 1, band_dtype=torch.bfloat16)
    assert sop.pband[0].dtype == torch.bfloat16
    got = sp.relax_packed_sweep(tquads(p), tquads(b), pack, sop, 1)
    for t in trc._TKEYS:
        close(got[t], want[t], 1e-6)


# -------------------------------------------------------------------- (e)

@pytest.mark.parametrize("real", [True, False])
def test_port_sweep_on_jax_layout(real):
    """The port's sweep run on JAX's own packed operator (carried over by
    packed_operator_from_numpy) == the port's sweep at another plan, bit
    for bit, and == the plain RB sweep."""
    cA, p, b = problem(4, 32, 32, seed=4)
    jp = jax_operator(cA, real, 2)
    js = jp.sweep
    sop = packed_operator_from_numpy(
        [np.asarray(x) for x in js.pband], [np.asarray(x) for x in js.ppiv],
        [np.asarray(x) for x in js.pseam], js.plan.tj, js.plan.nchunks,
        device="cpu")
    pack, own = port_operator(cA, real, 4, 1)
    q, bq = tquads(p), tquads(b)
    got = sp.relax_packed_sweep(q, bq, pack, sop, 2)
    ref = sp.relax_packed_sweep(q, bq, pack, own, 2)
    plain = trc.relax_compact_quads(q, bq, pack, 2, "RB", real)
    for t in trc._TKEYS:
        assert torch.equal(got[t], ref[t])
        assert torch.equal(got[t], plain[t])


# ------------------------------------------- plan independence and domain

# (quad shape, tj, nchunks): ragged tiles/chunks, one-row tiles, one-column
# chunks (Wc = 1), nz = 2
PLANS = [((3, 6, 18), 2, 3), ((2, 4, 6), 1, 6), ((5, 8, 8), 8, 1),
         ((4, 12, 20), 3, 2)]


@pytest.mark.parametrize("case", PLANS)
@pytest.mark.parametrize("real", [True, False])
def test_plain_packed_sweep_equals_plain_sweep(case, real):
    """At any plan the packed sweep's iterates are the plain RB sweep's
    (relax_compact_quads) bit for bit with bands of the state type."""
    (nz, H, W), tj, C = case
    cA, p, b = problem(nz, 2 * H, 2 * W, seed=sum(case[0]))
    pack, sop = port_operator(cA, real, tj, C)
    q, bq = tquads(p), tquads(b)
    got = sp.relax_packed_sweep(q, bq, pack, sop, 2)
    want = trc.relax_compact_quads(q, bq, pack, 2, "RB", real)
    for t in trc._TKEYS:
        assert torch.equal(got[t], want[t])


def test_plan_domain_is_enforced():
    cA, p, b = problem(2, 8, 12, seed=5)
    t = torch.from_numpy(cA)
    pack = trc.build_compact_pack(t, True)
    for tj, C, nz in ((3, 1, 2), (2, 4, 2), (2, 1, 1)):
        with pytest.raises(ValueError):
            sp.build_sweep_operator(t, pack, nz, 4, 6, tj=tj, nchunks=C)
    sop = sp.build_sweep_operator(t, pack, 2, 4, 6, tj=2, nchunks=2)
    q = tquads(p)
    q3 = {k: v[:, :3] for k, v in q.items()}     # H = 3: not a multiple
    with pytest.raises(ValueError):
        sp.relax_packed_sweep(q3, q3, pack, sop, 1)


# ------------------------------------------------- the CUDA kernel's recipe

def _emulate_chunk(streams, tj, nz, Wc, real, first_chunk, last_chunk,
                   cols):
    """csrc/sweep_packed.cu sweep_packed_kernel in scalar numpy: a block
    per row tile x window of ``cols`` columns.  Phase 0 solves (0,0) on
    rows [J0, J0+tj] x columns [c0, ce] and (1,1) on rows [J0-1, J0+tj) x
    [c0-1, ce) into the window's on-chip store, whose physical mirror cells
    hold the pre-sweep state; phase 1 reads colour 0 there and the 'real'
    terms' colour-1 siblings from plane 0 patched by the e1 rules.  Every
    band and state read must fall in the staged window (rows [J0-1,
    J0+tj], columns [c0-1, ce]); planes outside [0, nz) read zero."""
    pst, pband, ppiv, pseam, pbq, pqs = (
        (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        for x in streams)
    ntiles = pst.shape[0]
    H = ntiles * tj
    dt = pst.dtype.type
    terms = sp.term_rows()
    out = np.zeros((4, nz, H, Wc), pst.dtype)
    ptidx = {0: 0, 3: 1, 1: 2, 2: 3}
    for tile in range(ntiles):
        J0 = tile * tj
        for c0 in range(0, Wc, cols):
            ce = min(c0 + cols, Wc)

            def staged(y, x):
                assert J0 - 1 <= y <= J0 + tj and c0 - 1 <= x <= ce, (y, x)

            def band(s, k, y, x):
                staged(y, x)
                if not 0 <= k < nz:
                    return dt(0)
                return dt(pband[tile, s * nz + k, y - J0 + 2, x + 1])

            def state(q, k, y, x):
                staged(y, x)
                if not 0 <= k < nz:
                    return dt(0)
                return pst[tile, q * nz + k, y - J0 + 2, x + 2]

            store = {}

            def stored(qi, k, y, x):
                return dt(0) if not 0 <= k < nz else store[(qi, y, x)][k]

            def solve(t, y, x, ci, reader):
                pt = ptidx[t]
                r = y - J0 + 1

                def piv(f, k):
                    s = (pt * 3 + f) * nz + k
                    return (ppiv[tile, s, r, x] if ci < 0
                            else pseam[tile, s, r, ci])

                def rhs(k):
                    return (pbq[tile, pt * nz + k, r, x] if ci < 0
                            else pqs[tile, pt * nz + k, r, ci])

                def term(m, k):
                    bs, bk, rjb, rib, q, pk, rj, ri = terms[t][m]
                    return band(bs, k + bk, y + rjb, x + rib) \
                        * reader(q, k + pk, y + rj, x + ri)

                col = np.zeros(nz, pst.dtype)
                xk = None
                for k in range(nz):
                    s = term(0, k)
                    for m in range(1, 12):
                        s = s + term(m, k)
                    if real and k == 0:
                        x0 = term(12, 0)
                        for m in range(13, 16):
                            x0 = x0 + term(m, 0)
                        s = s + x0
                    rk = rhs(k) - s
                    xk = rk * piv(0, k) if k == 0 \
                        else (rk - piv(2, k - 1) * xk) * piv(0, k)
                    col[k] = xk
                for k in range(nz - 2, -1, -1):
                    xk = col[k] - piv(1, k) * xk
                    col[k] = xk
                return col

            # phase 0: colour-1 quads (1, 2) from the state ring, the
            # plane-0 'real' siblings (0, 3) from the staged plane 0
            def read0(q, k, y, x):
                assert q in (1, 2) or k == 0
                return state(q, k, y, x)

            for qi, t in ((0, 0), (1, 3)):
                ys = range(J0, J0 + tj + 1) if qi == 0 \
                    else range(J0 - 1, J0 + tj)
                xs = range(c0, ce + 1) if qi == 0 else range(c0 - 1, ce)
                for y in ys:
                    for x in xs:
                        if (qi == 0 and (y == H or (last_chunk and x == Wc))) \
                                or (qi == 1 and (y == -1 or (first_chunk
                                                             and x == -1))):
                            store[(qi, y, x)] = np.array(
                                [state(3 * qi, k, y, x) for k in range(nz)])
                            continue
                        ci = 0 if x == -1 else 1 if x == Wc else -1
                        store[(qi, y, x)] = solve(t, y, x, ci, read0)
                        if J0 <= y < J0 + tj and c0 <= x < ce:
                            out[t, :, y, x] = store[(qi, y, x)]

            # phase 1: colour 0 from the store; the 'real' terms' (0,1) and
            # (1,0) siblings from plane 0 with the e1 patches
            def read1(q, k, y, x):
                if q in (0, 3):
                    return stored(0 if q == 0 else 1, k, y, x)
                assert k == 0
                if q == 2:
                    if y == -1:
                        return stored(0, 0, 0, x)
                    if last_chunk and x == Wc:
                        return stored(1, 0, y, Wc - 1)
                elif y == H:
                    return stored(1, 0, H - 1, x)
                elif first_chunk and x == -1:
                    return stored(0, 0, y, 0)
                return state(q, 0, y, x)

            for t in (1, 2):
                for y in range(J0, J0 + tj):
                    for x in range(c0, ce):
                        out[t, :, y, x] = solve(t, y, x, -1, read1)
    return out


@pytest.mark.parametrize("case", [((3, 4, 12), 2, 2, 4),
                                  ((2, 6, 10), 3, 1, 4),
                                  ((4, 6, 22), 3, 1, 16)])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_cuda_recipe_emulation_matches_plain(case, real, lp):
    """The CUDA kernel's windows (4 columns, so windows split each chunk,
    or the card's 16 against an 11-column chunk: neither divides Wc),
    phase-0 ranges, on-chip colour 0 with its mirror cells, staged window
    extents and the e1 patches give the plain chunk sweep's values to the
    last bit, in float64 and (lp) in float32 with bfloat16 bands."""
    (nz, H, W), tj, C, cols = case
    dtype = np.float32 if lp else np.float64
    cA, p, b = problem(nz, 2 * H, 2 * W, seed=sum(case[0]), dtype=dtype)
    pack, sop = port_operator(cA, real, tj, C,
                              torch.bfloat16 if lp else None)
    q, bq = tquads(p), tquads(b)
    pbq, pqs = sp.pack_rhs(bq, tj, C)
    psts = sp.pack_state(q, tj, C)
    for c in range(C):
        streams = (psts[c], sop.pband[c], sop.ppiv[c], sop.pseam[c], pbq[c],
                   pqs[c])
        want = sp.sweep_chunk_plain(*streams, tj, nz, real, c == 0,
                                    c == C - 1)
        got = _emulate_chunk(streams, tj, nz, W // C, real, c == 0,
                             c == C - 1, cols=cols)
        for m in range(4):
            np.testing.assert_array_equal(got[m], want[m].numpy())


def test_term_recipe_is_the_band_stacks():
    """The packed recipe (term_rows) is the band stack's (sweep_fused.
    band_term_table, which the CUDA tests hold to the compiled term_of
    that K8 reads too) with rows and columns one lower; each band slab is
    read at one plane offset per colour (the kernel stages slab s at plane
    k + bk(s))."""
    from mgroms_tpu_torch.ops.kernels import sweep_fused as ksf
    rows = sp.term_rows()
    for m, t in enumerate(trc._TKEYS):
        assert rows[m] == [(b, bk, bj - 1, bi - 1, src, dk, oj - 1, oi - 1)
                           for b, bk, bj, bi, src, dk, oj, oi
                           in ksf.band_term_table(t)]
    for colour in (((0, 0), (1, 1)), ((0, 1), (1, 0))):
        bk = {}
        for t in colour:
            for r in rows[trc._TKEYS.index(t)]:
                bk.setdefault(r[0], set()).add(r[1])
        assert sorted(bk) == list(range(24))
        assert all(len(v) == 1 for v in bk.values())


@pytest.mark.parametrize("case", [
    # CUC level 0 / level 1 quads at the card's default plan (tj 8, one
    # chunk): float32, bfloat16 bands, float64
    ((64, 512), 4, 4, 16, 320, 176784), ((32, 256), 4, 4, 16, 320, 137616),
    ((64, 512), 4, 2, 16, 320, 169104), ((64, 512), 8, 8, 8, 192, 193568),
    ((32, 256), 8, 8, 8, 192, 152096)])
def test_launcher_window_choice(case):
    """The window K8 launches with (sweep_packed.window_plan; the
    launcher refuses a shared-memory size its own layout does not give,
    which the CUDA tests check) and the shared memory it reckons at the
    default plan: in float32 at nz
    64 a 16-column window, 320 threads and 176,784 bytes (the colour-0
    store 80,784 of them, the band ring 69,120), in float64 an 8-column
    one."""
    (nz, Wc), isz, bsz, window, threads, smem = case
    plan = sp.window_plan(nz, sp.DEFAULT_TJ, Wc, isz, bsz)
    assert (plan["window"], plan["threads"], plan["smem_bytes"]) == \
        (window, threads, smem)
    assert plan["smem_bytes"] <= sp.MAX_SMEM
    assert plan["store"] == 2 * (nz + 2) * (sp.DEFAULT_TJ + 1) \
        * (window + 1) * isz
    # the next wider window does not fit
    if window < 16:
        wider = sp.window_layout(nz, sp.DEFAULT_TJ, 2 * window, isz, bsz)
        assert wider["smem_bytes"] > sp.MAX_SMEM
    # a narrow chunk takes a window no wider than itself
    assert sp.window_plan(nz, sp.DEFAULT_TJ, 6, isz, bsz)["window"] == 6


@pytest.mark.parametrize("nz, tj", [(2000, 8), (64, 400)])
def test_plan_outside_the_window_domain_raises(nz, tj):
    """A plan no window holds (the colour-0 columns of nz 2000 overflow
    shared memory even one column wide; a 400-row tile needs more threads
    than a block takes) raises ValueError."""
    with pytest.raises(ValueError, match="no window"):
        sp.window_plan(nz, tj, 512, 4, 4)


def _thomas_out_of_place(bet, gam, ud, b):
    """thomas_factored_unrolled's recurrence without writes into its
    result, so autograd can take it back."""
    x = [b[0] * bet[0]]
    for k in range(1, b.shape[0]):
        x.append((b[k] - ud[k - 1] * x[k - 1]) * bet[k])
    for k in range(b.shape[0] - 2, -1, -1):
        x[k] = x[k] - gam[k] * x[k + 1]
    return torch.stack(x)


@pytest.mark.parametrize("case", [
    # (nz, H, W, tj, nchunks): three tiles and chunks, one tile, one
    # column a chunk, one-row tiles, nz 2
    (4, 12, 18, 4, 3), (3, 2, 10, 2, 2), (5, 6, 8, 3, 1),
    (2, 3, 9, 1, 3), (4, 4, 3, 2, 3)])
@pytest.mark.parametrize("real", [True, False])
def test_needed_bytes_are_what_the_plain_sweep_reads(case, real,
                                                     monkeypatch):
    """needed_bytes (K8's bound) counts exactly the elements of each
    packed stream that sweep_chunk_plain's outputs depend on: those with
    a nonzero gradient of a random weighting of the outputs, every chunk
    of the plan, on random streams."""
    nz, H, W, tj, C = case
    monkeypatch.setattr(sp, "thomas_factored_unrolled",
                        _thomas_out_of_place)
    ntiles, Wc = H // tj, W // C
    shapes = {"state": [(4, tj + 4, Wc + 4)], "bands": [(24, tj + 4, Wc + 3)],
              "pivots": [(12, tj + 2, Wc), (6, tj + 2, 2)],
              "rhs": [(4, tj + 2, Wc), (2, tj + 2, 2)]}
    g = torch.Generator().manual_seed(sum(case))
    got = dict.fromkeys(shapes, 0)
    for c in range(C):
        xs = {k: [(torch.rand((ntiles, s * nz, rows, cols), generator=g,
                              dtype=torch.float64) + 0.5).requires_grad_()
                  for s, rows, cols in v]
              for k, v in shapes.items()}
        outs = sp.sweep_chunk_plain(
            xs["state"][0], xs["bands"][0], xs["pivots"][0],
            xs["pivots"][1], xs["rhs"][0], xs["rhs"][1], tj, nz, real,
            c == 0, c == C - 1)
        sum((o * torch.rand(o.shape, generator=g, dtype=o.dtype)).sum()
            for o in outs).backward()
        for k, v in xs.items():
            got[k] += sum(int((x.grad != 0).sum()) for x in v
                          if x.grad is not None)
    want = sp.needed_bytes(nz, H, W, tj, C, 1, 1, real)
    assert want.pop("outputs") == 4 * nz * H * W
    assert want == got


def test_design_bytes_counts_the_bands_twice():
    """design_bytes at the CUC level-0 default plan: each colour stages
    every band slab's window once, so the bands are twice a colour's
    staged slabs, and more than twice their unique bytes; at a small plan
    it moves no less than the sweep needs (needed_bytes), stream by
    stream."""
    nz, H, W = 64, 512, 512
    got = sp.design_bytes(nz, H, W, 8, 1, 4, 4)
    uniq = sp.unique_bytes(nz, H, W, 4, 4)
    assert got["bands"] == 2 * 24 * nz * 10 * 18 * 4 * (H // 8) * (W // 16)
    assert got["bands"] > 2 * uniq["bands"]
    assert got["outputs"] == uniq["outputs"]
    own = sp.design_bytes(8, 32, 40, 8, 1, 4, 4)
    need = sp.needed_bytes(8, 32, 40, 8, 1, 4, 4, True)
    assert own["bands"] > need["bands"] and own["state"] > need["state"]
    assert own["pivots_rhs"] > need["pivots"] + need["rhs"]
    assert own["outputs"] == need["outputs"]


# -------------------------------------------------------------------- (f)

def test_micro_sweep_and_parts_checks_on_cpu():
    """The micro entry points' check functions at a tiny size on the CPU:
    every mode of micro_sweep_fused agrees with the plain sweep, and
    micro_packed_parts' pieces rebuild the packed sweep."""
    from mgroms_tpu_torch.scripts import micro_packed_parts as mpp
    from mgroms_tpu_torch.scripts import micro_sweep_fused as msf
    rows = msf.check(torch.device("cpu"), nz=4, ny=16, nx=24, tj=2,
                     nchunks=3)
    assert set(rows) == set(msf.MODES) - {"check"}
    assert all(v <= 1e-6 for v in rows.values()), rows
    assert mpp.check(torch.device("cpu"), nz=3, ny=8, nx=16, tj=2,
                     nchunks=2) == 0.0
