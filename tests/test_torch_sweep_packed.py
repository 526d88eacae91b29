"""The packed-stream colour-fused sweep (K8) and its packer (K9) == JAX, on
the CPU.

JAX's K8/K9 run in Pallas interpret mode (``interpret=True``); the
port's wrappers run their plain versions on CPU tensors.  The CUDA
kernel's index recipe (column blocks with a one-column colour-0
overhang, its private colour-0 store and the e1 view of
csrc/sweep_packed.cu) is emulated below in scalar numpy and held to the
plain version to the last bit.

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
    """csrc/sweep_packed.cu sweep_packed_kernel in scalar numpy: blocks of
    ``cols`` columns per tile, phase 0 into a private store ((0,0) on
    [c0, ce], (1,1) on [c0-1, ce), mirror cells skipped), phase 1 through
    the e1 view."""
    pst, pband, ppiv, pseam, pbq, pqs = (
        (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        for x in streams)
    ntiles = pst.shape[0]
    H = ntiles * tj
    terms = sp.term_rows()
    out = np.zeros((4, nz, H, Wc), pst.dtype)
    ptidx = {0: 0, 3: 1, 1: 2, 2: 3}
    for tile in range(ntiles):
        J0 = tile * tj
        for c0 in range(0, Wc, cols):
            ce = min(c0 + cols, Wc)
            scr = {}

            def state(q, k, y, x):
                return pst[tile, q * nz + k, y - J0 + 2, x + 2]

            def e1(q, k, y, x):
                if q == 2:
                    if y == -1:
                        q, y = 0, 0
                    elif last_chunk and x == Wc:
                        q, x = 3, Wc - 1
                    else:
                        return state(2, k, y, x)
                elif q == 1:
                    if y == H:
                        q, y = 3, H - 1
                    elif first_chunk and x == -1:
                        q, x = 0, 0
                    else:
                        return state(1, k, y, x)
                if q == 0:
                    if y == H or (last_chunk and x == Wc):
                        return state(0, k, y, x)
                    return scr[(0, y, x)][k]
                if y == -1 or (first_chunk and x == -1):
                    return state(3, k, y, x)
                return scr[(1, y, x)][k]

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
                    kb, kp = k + bk, k + pk
                    bv = (pband[tile, bs * nz + kb, y - J0 + 2 + rjb,
                                x + 1 + rib] if 0 <= kb < nz else 0.0)
                    v = reader(q, kp, y + rj, x + ri) if 0 <= kp < nz else 0.0
                    return pst.dtype.type(bv) * pst.dtype.type(v)

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

            for qi, t in ((0, 0), (1, 3)):
                for y in range(J0 - 1, J0 + tj + 1):
                    xs = range(c0, ce + 1) if qi == 0 else range(c0 - 1, ce)
                    for x in xs:
                        if (qi == 0 and (y == H or (last_chunk and x == Wc))) \
                                or (qi == 1 and (y == -1 or (first_chunk
                                                             and x == -1))):
                            continue
                        ci = 0 if x == -1 else 1 if x == Wc else -1
                        scr[(qi, y, x)] = solve(t, y, x, ci, state)
                        if J0 <= y < J0 + tj and c0 <= x < ce:
                            out[t, :, y, x] = scr[(qi, y, x)]
            for t in (1, 2):
                for y in range(J0, J0 + tj):
                    for x in range(c0, ce):
                        out[t, :, y, x] = solve(t, y, x, -1, e1)
    return out


@pytest.mark.parametrize("case", [((3, 4, 12), 2, 2), ((2, 6, 10), 3, 1)])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("lp", [False, True])
def test_cuda_recipe_emulation_matches_plain(case, real, lp):
    """The CUDA kernel's column blocks (4 columns here, so blocks split
    each chunk), phase-0 ranges, skipped mirror cells and e1 view give the
    plain chunk sweep's values to the last bit, in float64 and (lp) in
    float32 with bfloat16 bands."""
    (nz, H, W), tj, C = case
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
                             c == C - 1, cols=4)
        for m in range(4):
            np.testing.assert_array_equal(got[m], want[m].numpy())


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
