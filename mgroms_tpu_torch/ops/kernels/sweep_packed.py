"""The packed-stream colour-fused RB sweep (K8) and its stream packer (K9):
the hand-written CUDA kernels and their plain torch versions.

Port of ``mgroms_tpu/ops/pallas/sweep_packed.py``, the other design of the
colour-fused sweep (K4, ``sweep_fused.py``): every operator band, pivot and
RHS value a row tile needs is laid out contiguously per tile, TILE-MAJOR
(``(ntiles, nslabs*nz, rows, width)`` per lane chunk), and colour 0 is
recomputed on a one-row overhang of each tile so a tile needs nothing of
another tile's colour-0 values.  The kernels (``csrc/sweep_packed.cu``)
replace:

  ``sweep_packed``  <- ``_sweep_chunk``  (sweep_packed.py:519, body :336)
  ``pack_streams``  <- ``_pack_streams`` (sweep_packed.py:591, body :570)

The TPU kernel's VMEM model (``_Plan``/``_plan_bytes``/``_pick_plan``/
``supports``) is not carried over: :func:`build_sweep_operator` takes the
row tile ``tj`` and the lane chunk count ``nchunks`` explicitly.  The
card's default, tj 8 with one chunk: the CUDA kernel splits a chunk's
columns over its own blocks, so lane chunks only add launches and seam
recomputes; at tj 8 the duplicated overhang rows make the band stream 1.5x
its unique bytes (tj 16: 1.25x), and of tj 4, 8, 16 and 32 it timed
fastest at CUC level 0 (PERF.md, section 6).

K8's design (``csrc/sweep_packed.cu``): a block owns one row tile x a
window of the chunk's columns and walks z in lock step, staging every
plane's band slabs, colour-0 state and column values in shared memory
through a ring of asynchronous copies; colour 0's overhang columns stay in
shared memory over all nz planes (no store in device memory), and colour 1
reads them there.  What bounds it is memory: both colours read every band
slab, so the band stream is read twice a sweep (:func:`design_bytes`
counts this design's own traffic beside the bound's bytes,
:func:`needed_bytes`: what the outputs depend on, read once).
:func:`window_plan` chooses the window from (nz, tj, types): the widest
of :data:`WINDOWS` whose colour-0 columns and rings fit a block's 227 KB
of shared memory with at most :data:`MAX_THREADS` threads; a plan no
window fits raises ``ValueError`` before any launch (float32 at nz 64,
tj 8: a 16-column window, 320 threads, 176,784 B).  The launcher takes
the window and the shared memory reckoned for it and refuses a pair its
own layout does not give; :func:`launch_plan` reads its plan on the
card.

Iterates equal relax_compact.relax_compact_quads bit for bit with bands of
the state type (same term order, the same factored Thomas recurrence) and
are independent of ``tj`` and ``nchunks``.  With bfloat16 bands the
pivots are those of the rounded operator (relax_compact.
consistent_pivots), as in the JAX package.

:func:`relax_packed_sweep` runs the plain versions for tensors on the CPU
only; for CUDA tensors it launches the kernels or raises.  ``LAUNCHES``
counts kernel launches.  It is not wired into the solver: the JAX package
routes no level to this sweep.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from ._build import check_launch, instance, on_cpu, ptr
from ..relax import thomas_factored_unrolled
from ..relax_compact import (_BASE_TERMS, _REAL_TERMS, _TKEYS, CompactPack,
                             _kshift, consistent_pivots, extend_quads,
                             quad_ext_bands)

LAUNCHES = {"sweep_packed": 0, "sweep_packed_bf16": 0, "pack_streams": 0}

_TI = {t: i for i, t in enumerate(_TKEYS)}
_COLOR0 = ((0, 0), (1, 1))     # (i + j) even: updated first (phase 0)
_COLOR1 = ((0, 1), (1, 0))
# pivot slab order inside the packed pivot stream: (bet, gam, ud) per
# target, targets in (_COLOR0 + _COLOR1) order
_PTARGETS = _COLOR0 + _COLOR1

DEFAULT_TJ = 8
DEFAULT_NCHUNKS = 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class SweepOperator:
    """Per-level packed-stream smoother operator (sweep_packed.py:198).

    ``pband[c]``: (ntiles, 24*nz, tj+4, Wc+3): per tile, the 24 extended
    band quads' row slabs [J0-2, J0+TJ+2) x cols [I0-1, I0+WC+2), band-major
    then ``_TKEYS`` order, overlap rows duplicated.  ``ppiv[c]``:
    (ntiles, 12*nz, tj+2, Wc): (bet, gam, ud) per target in ``_PTARGETS``
    order, rows [J0-1, J0+TJ+1), gam/ud zero-padded to nz planes.
    ``pseam[c]``: (ntiles, 6*nz, tj+2, 2): the colour-0 targets' pivots at
    the seam columns I0-1 / I0+WC."""

    pband: tuple
    ppiv: tuple
    pseam: tuple
    tj: int
    nchunks: int


def _zpad_to(x: torch.Tensor, nz: int) -> torch.Tensor:
    """Zero-pad the leading (z) dim to ``nz`` planes (uniform slab)."""
    if x.shape[0] == nz:
        return x
    return torch.cat([x, x.new_zeros((nz - x.shape[0],) + x.shape[1:])])


def _pad_rows(x: torch.Tensor, top: int, rows: int) -> torch.Tensor:
    """``top`` edge-dup rows on top, tail-dup to ``rows`` total."""
    parts = [x[:, :1]] * top + [x]
    extra = rows - x.shape[1] - top
    if extra > 0:
        parts += [x[:, -1:]] * extra
    return torch.cat(parts, dim=1)


def _pad_cols(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``n`` edge-dup columns each side."""
    return torch.cat([x[..., :1]] * n + [x] + [x[..., -1:]] * n, dim=-1)


def _tile_pack(slabs, ntiles: int, tj: int, rows: int) -> torch.Tensor:
    """Stack per-tile row slabs of each (nz, H', width) array of ``slabs``
    into one tile-major (ntiles, nslabs*nz, rows, width) array."""
    full = torch.cat(list(slabs), dim=0)
    return torch.stack([full[:, i * tj: i * tj + rows] for i in range(ntiles)])


def check_plan(nz: int, H: int, W: int, tj: int, nchunks: int) -> None:
    """The JAX function's domain: ``H % tj == 0``, ``W % nchunks == 0``,
    ``nz >= 2``."""
    if nz < 2:
        raise ValueError(f"the packed sweep needs nz >= 2, got {nz}")
    if tj < 1 or H % tj:
        raise ValueError(f"row tile {tj} does not divide H = {H}")
    if nchunks < 1 or W % nchunks:
        raise ValueError(f"{nchunks} lane chunks do not divide W = {W}")


def build_sweep_operator(cA: torch.Tensor, pack: CompactPack, nz: int,
                         H: int, W: int, tj: int = DEFAULT_TJ,
                         nchunks: int = DEFAULT_NCHUNKS,
                         band_dtype=None) -> SweepOperator:
    """One-time per-level build (sweep_packed.py:265).  ``cA`` is the
    extended band stack (8, nz, ny+2, nx+2); ``pack`` supplies the Thomas
    pivots.  With ``band_dtype`` (bfloat16 beside float32 state) the bands
    are rounded once and the pivots are the consistent ones of the rounded
    operator."""
    check_plan(nz, H, W, tj, nchunks)
    bd = band_dtype if band_dtype is not None else cA.dtype
    C, Wc, ntiles = nchunks, W // nchunks, H // tj
    eb = []
    for n in range(2, 8):
        qe = quad_ext_bands(cA[n])
        for t in _TKEYS:
            eb.append(_pad_rows(_pad_cols(qe[t].to(bd), 1), 1, H + 4))
    pband = tuple(_tile_pack([x[:, :, c * Wc + 1: c * Wc + Wc + 4]
                              for x in eb], ntiles, tj, tj + 4)
                  for c in range(C))
    del eb
    if bd != cA.dtype:
        bet = consistent_pivots(pack, bd)
    else:
        bet = pack.bet
    gam = tuple(u * b[:-1] for u, b in zip(pack.ud, bet))
    fields = lambda m: (bet[m], gam[m], pack.ud[m])
    piv_full = [_pad_rows(_zpad_to(xs, nz), 1, H + 2)
                for t in _PTARGETS for xs in fields(_TI[t])]
    ppiv, pseam = [], []
    for c in range(C):
        ppiv.append(_tile_pack([x[:, :, c * Wc: (c + 1) * Wc]
                                for x in piv_full], ntiles, tj, tj + 2))
        se = []
        for t in _COLOR0:
            for xs in fields(_TI[t]):
                x = _pad_cols(_pad_rows(_zpad_to(xs, nz), 1, H + 2), 1)
                se.append(torch.cat([x[:, :, c * Wc: c * Wc + 1],
                                     x[:, :, c * Wc + Wc + 1:
                                       c * Wc + Wc + 2]], dim=2))
        pseam.append(_tile_pack(se, ntiles, tj, tj + 2))
    return SweepOperator(pband=pband, ppiv=tuple(ppiv), pseam=tuple(pseam),
                         tj=tj, nchunks=C)


def unique_bytes(nz: int, H: int, W: int, itemsize: int,
                 band_itemsize: int) -> dict:
    """The same sweep's unique bytes: the 6 band quads' 24 extended slabs,
    bet/gam/ud of 4 targets, the 4 state and RHS quads, the 4 outputs."""
    q = nz * H * W
    return {"bands": 24 * q * band_itemsize,
            "pivots": 4 * (3 * nz - 2) * H * W * itemsize,
            "state": 4 * q * itemsize, "rhs": 4 * q * itemsize,
            "outputs": 4 * q * itemsize}


# K8's block layout (csrc/sweep_packed.cu: Layout) and window choice: the
# ring stages of bands and column values, the state ring's planes, the
# most band / state copies a thread issues a plane, the threads a block
# may have, the shared memory a block may take and the windows tried,
# widest first
RING_STAGES = 4
STATE_SLOTS = RING_STAGES + 2
MAX_BAND_COPIES = 16
MAX_STATE_COPIES = 4
MAX_THREADS = 384
MAX_SMEM = 227 * 1024
WINDOWS = (16, 8, 4, 2, 1)


def _a16(b: int) -> int:
    return -(-b // 16) * 16


def window_layout(nz: int, tj: int, wn: int, itemsize: int,
                  band_itemsize: int) -> dict:
    """One K8 block's threads and shared memory at window ``wn``
    (csrc/sweep_packed.cu ``Layout``, which the launcher checks against
    the shared memory reckoned here): the colour-0 store (2 quads x
    (nz+2) planes x (tj+1) x (wn+1)), the plane-0 window of the four quads,
    the state ring, the band ring (bfloat16 rows staged in 16-byte copies
    aligned as device memory has them, with 7 values of slack; float32 and
    float64 a value a copy) and the column ring."""
    R, NC = tj + 2, wn + 2
    E = 8 if band_itemsize == 2 else 1
    BP = (NC + 2 * E - 2) // E * E
    CPR = BP // E
    need = max(2 * (tj + 1) * (wn + 1), 2 * tj * wn,
               -(-24 * R * CPR // MAX_BAND_COPIES),
               -(-2 * R * NC // MAX_STATE_COPIES))
    nt = -(-need // 32) * 32
    parts = {"store": _a16(2 * (nz + 2) * (tj + 1) * (wn + 1) * itemsize),
             "plane0": _a16(4 * R * NC * itemsize),
             "state_ring": _a16(STATE_SLOTS * 2 * R * NC * itemsize),
             "band_ring": _a16(RING_STAGES * 24 * R * BP * band_itemsize),
             "column_ring": _a16(RING_STAGES * 3 * nt * itemsize)}
    return {"threads": nt, "smem_bytes": sum(parts.values()), **parts}


def window_plan(nz: int, tj: int, Wc: int, itemsize: int,
                band_itemsize: int) -> dict:
    """The window K8 launches with for a chunk of ``Wc`` columns: the
    widest of :data:`WINDOWS` (at most ``Wc``) whose block fits
    :data:`MAX_THREADS` threads and :data:`MAX_SMEM` bytes; ``ValueError``
    when none does."""
    for w in WINDOWS:
        wn = min(w, Wc)
        lay = window_layout(nz, tj, wn, itemsize, band_itemsize)
        if lay["threads"] <= MAX_THREADS and lay["smem_bytes"] <= MAX_SMEM:
            return {"window": wn, **lay}
    raise ValueError(
        f"the packed sweep has no window for nz {nz}, tj {tj} with "
        f"{itemsize}-byte state and {band_itemsize}-byte bands: one column "
        f"needs {window_layout(nz, tj, 1, itemsize, band_itemsize)} (limits "
        f"{MAX_THREADS} threads, {MAX_SMEM} bytes)")


def design_bytes(nz: int, H: int, W: int, tj: int, nchunks: int,
                 itemsize: int, band_itemsize: int) -> dict:
    """What K8 moves for one packed sweep at plan (``tj``, ``nchunks``),
    per stream, as its blocks stage it: every band slab's window (rows
    [J0-1, J0+tj], the window's columns and one each side; the slack of
    the aligned copies, in the same 32-byte sectors, left out) once per
    colour; colour 0's state (two quads, all planes, and plane 0 of all
    four); bet, gam, ud and the RHS of every column each colour solves
    (colour 0's overhang and seam columns included); the four outputs
    written once.  Left out: colour 1's
    forward values, written to the outputs and read back by the same
    thread (from L2), and the physical mirror cells' state reads (a few
    edge columns)."""
    ntiles, Wc = H // tj, W // nchunks
    wn = window_plan(nz, tj, Wc, itemsize, band_itemsize)["window"]
    R = tj + 2
    bands = state = cols = 0
    for c0 in range(0, Wc, wn):
        nc = min(wn, Wc - c0)
        bands += 2 * 24 * nz * R * (nc + 2) * band_itemsize
        state += (2 * nz + 4) * R * (nc + 2) * itemsize
        cols += (2 * (tj + 1) * (nc + 1) + 2 * tj * nc) \
            * (4 * nz - 2) * itemsize
    per = nchunks * ntiles
    q = nz * H * W * itemsize
    return {"bands": per * bands, "state": per * state,
            "pivots_rhs": per * cols, "outputs": 4 * q}


# ------------------------------------------------------------ K9 (pack)

def pack_streams_plain(arrs, tj: int, rows: int, Wc: int, wpad: int,
                       C: int) -> tuple:
    """Tile-major packing of full-width padded arrays (nz, H', W') into C
    per-chunk (ntiles, nslabs*nz, rows, width) streams: tile i of chunk c
    holds rows [i*tj, i*tj+rows) of each array, columns
    [c*Wc, c*Wc+Wc+wpad) (``wpad >= 0``) or, in seam mode (``wpad < 0``),
    the two columns c*Wc and c*Wc+Wc+1 that frame the chunk."""
    Hp = arrs[0].shape[1]
    ntiles = (Hp - rows) // tj + 1
    out = []
    for c in range(C):
        if wpad < 0:
            sl = [torch.cat([a[:, :, c * Wc: c * Wc + 1],
                             a[:, :, c * Wc + Wc + 1: c * Wc + Wc + 2]],
                            dim=2) for a in arrs]
        else:
            sl = [a[:, :, c * Wc: c * Wc + Wc + wpad] for a in arrs]
        out.append(_tile_pack(sl, ntiles, tj, rows))
    return tuple(out)


def pack_streams_library(arrs, tj: int, rows: int, Wc: int, wpad: int,
                         C: int) -> tuple:
    """The same packing in one strided PyTorch copy per chunk
    (``unfold`` -> ``permute`` -> ``contiguous``): the yardstick
    chip_smoke.py times beside K9; the port never calls it."""
    full = torch.cat(list(arrs), dim=0).unfold(1, rows, tj)
    out = []
    for c in range(C):
        if wpad < 0:
            x = full[:, :, [c * Wc, c * Wc + Wc + 1]]
        else:
            x = full[:, :, c * Wc: c * Wc + Wc + wpad]
        out.append(x.permute(1, 0, 3, 2).contiguous())
    return tuple(out)


class _PackArgs(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p * 8), ("dst", ctypes.c_void_p * 64)]


def pack_streams(arrs, tj: int, rows: int, Wc: int, wpad: int,
                 C: int) -> tuple:
    """K9: :func:`pack_streams_plain` in one kernel launch for CUDA
    tensors (up to 8 arrays, 64 chunks); the plain version for CPU
    tensors."""
    a0 = arrs[0]
    if on_cpu(a0):
        return pack_streams_plain(arrs, tj, rows, Wc, wpad, C)
    nz, Hp, Wp = a0.shape
    if not 1 <= len(arrs) <= 8 or not 1 <= C <= 64:
        raise ValueError(f"{len(arrs)} arrays, {C} chunks: the kernel "
                         "takes 1-8 arrays and 1-64 chunks")
    if a0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pack_streams takes float32/float64, got {a0.dtype}")
    for a in arrs:
        if (a.shape != a0.shape or a.dtype != a0.dtype
                or a.device != a0.device):
            raise ValueError("pack_streams: arrays differ in shape, type or "
                             "device")
        if not a.is_contiguous():
            raise ValueError("pack_streams: arrays must be contiguous")
    width = 2 if wpad < 0 else Wc + wpad
    last = (C - 1) * Wc + (Wc + 2 if wpad < 0 else Wc + wpad)
    if rows > Hp or tj < 1 or last > Wp:
        raise ValueError(f"pack_streams: window rows {rows} / cols {last} "
                         f"exceed the arrays' ({Hp}, {Wp})")
    ntiles = (Hp - rows) // tj + 1
    outs = [a0.new_empty((ntiles, len(arrs) * nz, rows, width))
            for _ in range(C)]
    args = _PackArgs((ctypes.c_void_p * 8)(*(ptr(a) for a in arrs)),
                     (ctypes.c_void_p * 64)(*(ptr(o) for o in outs)))
    lib = _build.load()
    fn = (lib.mg_pack_streams_f64 if a0.dtype == torch.float64
          else lib.mg_pack_streams_f32)
    with torch.cuda.device(a0.device):
        rc = fn(ctypes.byref(args), len(arrs), C, nz, Hp, Wp, tj, rows, Wc,
                wpad, ntiles, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "pack_streams")
    LAUNCHES["pack_streams"] += 1
    return tuple(outs)


# ----------------------------------------------------------- K8 (sweep)

def sweep_chunk_plain(pst, pband_c, ppiv_c, pseam_c, pbq_c, pqs_c, tj: int,
                      nz: int, real_matrix: bool, first_chunk: bool,
                      last_chunk: bool) -> tuple:
    """One RB sweep of one lane chunk from the packed streams: the four
    updated chunk quads (nz, H, Wc) in ``_TKEYS`` order.  Term for term
    sweep_packed.py ``_kernel`` (:336-514), with the tiles as a batch
    dimension: every slab is read as (nz, ntiles, rows, cols)."""
    ntiles = pst.shape[0]
    Wc = ppiv_c.shape[3]
    dt = pst.dtype
    n0, m0 = tj + 2, Wc + 2
    k0 = (torch.arange(nz, device=pst.device) == 0).to(dt).reshape(
        nz, 1, 1, 1) if real_matrix else None

    def slab(ref, s, n, rows, cols):
        return ref[:, s: s + n, rows, cols].transpose(0, 1)

    def band_read(n, boff, a, b, o, oc, nrows, ncols):
        bk, bj, bi = boff
        kb = ((a + bj) % 2, (b + bi) % 2)
        rjb = (a + bj - kb[0]) // 2
        rib = (b + bi - kb[1]) // 2
        s = ((n - 3) * 4 + _TI[kb]) * nz
        x = slab(pband_c, s, nz,
                 slice(o + rjb + 2, o + rjb + 2 + nrows),
                 slice(oc + rib + 1, oc + rib + 1 + ncols))
        return _kshift(x.to(dt), bk)

    def gather(a, b, o, oc, nrows, ncols, reader):
        s = None
        for n, boff, poff in _BASE_TERMS:
            t = band_read(n, boff, a, b, o, oc, nrows, ncols) \
                * reader(poff, a, b)
            s = t if s is None else s + t
        if real_matrix:
            x = None
            for n, boff, poff in _REAL_TERMS:
                t = band_read(n, boff, a, b, o, oc, nrows, ncols) \
                    * reader(poff, a, b)
                x = t if x is None else x + t
            s = s + k0 * x
        return s

    def piv(t, field, rows, seam=None):
        """Pivot slab: field 0 = bet (nz), 1 = gam, 2 = ud (nz-1)."""
        zlen = nz if field == 0 else nz - 1
        if seam is None:
            return slab(ppiv_c, (_PTARGETS.index(t) * 3 + field) * nz, zlen,
                        rows, slice(None))
        return slab(pseam_c, (_COLOR0.index(t) * 3 + field) * nz, zlen, rows,
                    seam)

    def read_p0(poff, a, b, oc, ncols):
        pk, pj, pi = poff
        kp = ((a + pj) % 2, (b + pi) % 2)
        rj = (a + pj - kp[0]) // 2
        ri = (b + pi - kp[1]) // 2
        x = slab(pst, _TI[kp] * nz, nz, slice(rj + 1, rj + 1 + n0),
                 slice(oc + ri + 2, oc + ri + 2 + ncols))
        return _kshift(x, pk)

    rall = slice(0, n0)

    def p0_compute(t, oc, ncols):
        a, b = t
        m = _COLOR0.index(t) * nz
        # the main tile is oc == 0 (JAX tests ncols == Wc, which sends the
        # 1-column seam recomputes down the main branch when Wc == 1)
        if oc == 0:
            pv = [piv(t, f, rall) for f in range(3)]
            rhs0 = slab(pbq_c, m, nz, rall, slice(None))
        else:
            cs = slice(0, 1) if oc < 0 else slice(1, 2)
            pv = [piv(t, f, rall, seam=cs) for f in range(3)]
            rhs0 = slab(pqs_c, m, nz, rall, cs)
        rhs = rhs0 - gather(a, b, -1, oc, n0, ncols,
                            lambda poff, a, b: read_p0(poff, a, b, oc,
                                                       ncols))
        return thomas_factored_unrolled(*pv, rhs)

    outs = [None] * 4
    p0 = {}
    for t in _COLOR0:
        p0[t] = p0_compute(t, 0, Wc)
        outs[_TI[t]] = p0[t][:, :, 1: tj + 1]

    def state(t, rows, cols):
        return slab(pst, _TI[t] * nz, nz, rows, cols)

    scr = {}
    for t in _COLOR0:
        s = pst.new_zeros((nz, ntiles, n0, m0))
        s[:, :, :, 1: Wc + 1] = p0[t]
        if t == (1, 1):
            s[:, :, :, 0:1] = (state(t, slice(1, n0 + 1), slice(1, 2))
                               if first_chunk else p0_compute(t, -1, 1))
            s[:, 0, 0:1, :] = state(t, slice(1, 2), slice(1, m0 + 1))[:, 0]
        else:
            s[:, :, :, m0 - 1:] = (
                state(t, slice(1, n0 + 1), slice(m0, m0 + 1)) if last_chunk
                else p0_compute(t, Wc, 1))
            s[:, -1, n0 - 1:, :] = state(t, slice(n0, n0 + 1),
                                         slice(1, m0 + 1))[:, -1]
        scr[t] = s
    if real_matrix:
        e10 = state((1, 0), slice(1, n0 + 1), slice(1, m0 + 1)).clone()
        if last_chunk:
            e10[:, :, :, m0 - 1:] = scr[(1, 1)][:, :, :, m0 - 2: m0 - 1]
        e10[:, 0, 0:1, :] = scr[(0, 0)][:, 0, 1:2, :]
        e01 = state((0, 1), slice(1, n0 + 1), slice(1, m0 + 1)).clone()
        if first_chunk:
            e01[:, :, :, 0:1] = scr[(0, 0)][:, :, :, 1:2]
        e01[:, -1, n0 - 1:, :] = scr[(1, 1)][:, -1, n0 - 2: n0 - 1, :]
        scr[(1, 0)], scr[(0, 1)] = e10, e01

    def read_p1(poff, a, b):
        pk, pj, pi = poff
        kp = ((a + pj) % 2, (b + pi) % 2)
        rj = (a + pj - kp[0]) // 2
        ri = (b + pi - kp[1]) // 2
        return _kshift(scr[kp][:, :, rj + 1: rj + 1 + tj, ri + 1: ri + 1 + Wc],
                       pk)

    r1 = slice(1, tj + 1)
    for t in _COLOR1:
        a, b = t
        m = (2 + _COLOR1.index(t)) * nz
        rhs = slab(pbq_c, m, nz, r1, slice(None)) \
            - gather(a, b, 0, 0, tj, Wc, read_p1)
        outs[_TI[t]] = thomas_factored_unrolled(
            piv(t, 0, r1), piv(t, 1, r1), piv(t, 2, r1), rhs)
    H = ntiles * tj
    return tuple(x.reshape(nz, H, Wc) for x in outs)


def term_rows() -> list:
    """Per target (``_TKEYS`` order) and gather term (the 12 of
    ``_BASE_TERMS``, then the 4 of ``_REAL_TERMS``): ``(band slab, bk,
    rjb, rib, source quad, pk, rj, ri)`` -- the band value is slab ``band
    slab`` of the packed band stream at plane k+bk, row y+rjb, column
    x+rib; the state value is quad ``source quad`` (``_TKEYS`` index) at
    plane k+pk, row y+rj, column x+ri (sweep_packed.py band_read /
    read_p0 / read_p1)."""
    out = []
    for a, b in _TKEYS:
        rows = []
        for n, (bk, bj, bi), (pk, pj, pi) in _BASE_TERMS + _REAL_TERMS:
            kb = ((a + bj) % 2, (b + bi) % 2)
            kp = ((a + pj) % 2, (b + pi) % 2)
            rows.append(((n - 3) * 4 + _TI[kb], bk, (a + bj - kb[0]) // 2,
                         (b + bi - kb[1]) // 2, _TI[kp], pk,
                         (a + pj - kp[0]) // 2, (b + pi - kp[1]) // 2))
        out.append(rows)
    return out


def _kinds(n: int) -> list:
    """(first, last, how many) of ``n`` tiles or chunks."""
    if n == 1:
        return [(True, True, 1)]
    return [(True, False, 1), (False, True, 1), (False, False, n - 2)]


def _shifted(cells, dr: int, dc: int):
    """``cells`` moved by (dr, dc) on the same grid (each lands inside)."""
    out = torch.zeros_like(cells)
    r, c = cells.nonzero(as_tuple=True)
    out[r + dr, c + dc] = True
    return out


def _needed_elements(nz: int, tj: int, Wc: int, real: bool,
                     first_tile: bool, last_tile: bool, first_chunk: bool,
                     last_chunk: bool) -> dict:
    """The elements of one tile's packed streams that the chunk's four
    outputs depend on, per stream, following :func:`sweep_chunk_plain`
    term by term.  Cells are indexed on its colour-0 grid (``scr``): rows
    [J0-1, J0+tj], columns [-1, Wc] of the chunk; a term reads band slab
    ``s`` at row r+rjb+1, column c+rib and its source at cell (r+rj, c+ri),
    the pre-sweep state at (r+1, c+1) of its grid, and neither where the
    other is a zero (a plane beyond nz, an unset colour-0 cell)."""
    n0, m0 = tj + 2, Wc + 2
    terms = [rows[:16 if real else 12] for rows in term_rows()]
    band = torch.zeros(24, nz, tj + 4, Wc + 3, dtype=torch.bool)
    state = torch.zeros(4, nz, tj + 4, Wc + 4, dtype=torch.bool)
    full = lambda v: torch.full((n0, m0), v, dtype=torch.long)
    # colour-0 cells: 1 solved, 2 the pre-sweep state (mirror), 0 zero
    src = {(1, 1): full(1), (0, 0): full(1)}
    src[(1, 1)][:, m0 - 1] = 0
    src[(0, 0)][:, 0] = 0
    if first_chunk:
        src[(1, 1)][:, 0] = 2
    if first_tile:
        src[(1, 1)][0, :] = 2
    if last_chunk:
        src[(0, 0)][:, m0 - 1] = 2
    if last_tile:
        src[(0, 0)][n0 - 1, :] = 2
    # the lowest plane read of each solved cell (nz: none)
    low = {t: full(nz) for t in _COLOR0}
    colour1 = torch.zeros(n0, m0, dtype=torch.bool)
    colour1[1: tj + 1, 1: Wc + 1] = True
    for t in _COLOR0:
        low[t][colour1] = 0                        # the outputs

    def span(j: int, bk: int, pk: int) -> tuple:
        """The planes k a term is read at: every k whose band plane k+bk
        and source plane k+pk exist; plane 0 alone for a 'real' term."""
        if j >= 12:
            return 0, 1
        return max(0, -bk, -pk), min(nz, nz - bk, nz - pk)

    def put(dst, lo: int, hi: int, cells, dr: int, dc: int) -> None:
        r, c = cells.nonzero(as_tuple=True)
        dst[lo:hi, r + dr, c + dc] = True

    def need0(t, cells, lo: int, hi: int):
        """Colour-0 quad ``t``'s ``cells`` read at planes [lo, hi): the
        cells that hold a value."""
        solved = cells & (src[t] == 1)
        low[t][solved] = low[t][solved].clamp(max=lo)
        put(state[_TI[t]], lo, hi, cells & (src[t] == 2), 1, 1)
        return cells & (src[t] != 0)

    for t in _COLOR1:
        for j, (s, bk, rjb, rib, kp, pk, rj, ri) in enumerate(
                terms[_TI[t]]):
            lo, hi = span(j, bk, pk)
            cells = _shifted(colour1, rj, ri)
            kq = _TKEYS[kp]
            if kq in _COLOR0:
                live = need0(kq, cells, lo + pk, hi + pk)
            else:
                # a 'real' term's colour-1 sibling at plane 0: the
                # pre-sweep state, or colour 0 where the e1 rules patch it
                row, col = torch.zeros_like(cells), torch.zeros_like(cells)
                if kq == (1, 0):
                    row[0], col[:, m0 - 1] = first_tile, last_chunk
                    by_row, dr, by_col, dc = (0, 0), 1, (1, 1), -1
                else:
                    row[n0 - 1], col[:, 0] = last_tile, first_chunk
                    by_row, dr, by_col, dc = (1, 1), -1, (0, 0), 1
                col &= ~row
                live = cells & ~(row | col)
                put(state[kp], lo + pk, hi + pk, live, 1, 1)
                live |= _shifted(need0(by_row, _shifted(cells & row, dr, 0),
                                       pk, pk + 1), -dr, 0)
                live |= _shifted(need0(by_col, _shifted(cells & col, 0, dc),
                                       pk, pk + 1), 0, -dc)
            put(band[s], lo + bk, hi + bk, _shifted(live, -rj, -ri),
                1 + rjb, rib)
    cols = gam = 0
    for t in _COLOR0:
        solved = low[t] < nz
        for j, (s, bk, rjb, rib, kp, pk, rj, ri) in enumerate(
                terms[_TI[t]]):
            lo, hi = span(j, bk, pk)
            put(band[s], lo + bk, hi + bk, solved, 1 + rjb, rib)
            put(state[kp], lo + pk, hi + pk, solved, 1 + rj, 1 + ri)
        cols += int(solved.sum())
        gam += int((nz - 1 - low[t][solved]).clamp(min=0).sum())
    # a solved column needs bet, ud and the RHS at every plane and gam
    # from its lowest plane read; colour 1's 2 tj Wc columns all of them
    n1 = 2 * tj * Wc
    return {"bands": int(band.sum()), "state": int(state.sum()),
            "pivots": (cols + n1) * (2 * nz - 1) + gam + n1 * (nz - 1),
            "rhs": (cols + n1) * nz}


def needed_bytes(nz: int, H: int, W: int, tj: int, nchunks: int,
                 itemsize: int, band_itemsize: int, real: bool) -> dict:
    """The bytes one packed sweep must move at plan (``tj``, ``nchunks``),
    per stream: every element of the packed streams that the four output
    quads depend on, read once (what :func:`sweep_chunk_plain` reads: rows
    [J0-1, J0+tj] of the bands and state, colour 0's own quads only at
    plane 0 and the mirror cells, each band slab at the planes its terms
    reach), and the outputs written once.  K8's bound counts these; the
    tests hold the count to the plain version's dependencies."""
    ntiles, Wc = H // tj, W // nchunks
    got = dict.fromkeys(("bands", "state", "pivots", "rhs"), 0)
    for ft, lt, nt in _kinds(ntiles):
        for fc, lc, nc in _kinds(nchunks):
            if nt and nc:
                one = _needed_elements(nz, tj, Wc, real, ft, lt, fc, lc)
                for k in got:
                    got[k] += nt * nc * one[k]
    return {"bands": got["bands"] * band_itemsize,
            "state": got["state"] * itemsize,
            "pivots": got["pivots"] * itemsize, "rhs": got["rhs"] * itemsize,
            "outputs": 4 * nz * H * W * itemsize}


class _SweepPackedArgs(ctypes.Structure):
    _fields_ = [("pst", ctypes.c_void_p), ("pband", ctypes.c_void_p),
                ("ppiv", ctypes.c_void_p), ("pseam", ctypes.c_void_p),
                ("pbq", ctypes.c_void_p), ("pqs", ctypes.c_void_p),
                ("out", ctypes.c_void_p * 4)]


# (state dtype, band dtype) -> K8's C entry (csrc/sweep_packed.cu's
# instances).  No (float64, bfloat16) instance: the JAX package never
# builds one
PACKED_ENTRIES = {
    (torch.float32, torch.float32): "mg_sweep_packed_f32",
    (torch.float64, torch.float64): "mg_sweep_packed_f64",
    (torch.float32, torch.bfloat16): "mg_sweep_packed_bf16",
}


def launch_plan(nz: int, tj: int, Wc: int, state, band) -> dict:
    """The launch K8 takes for a chunk of ``Wc`` columns at (``nz``,
    ``tj``) for the pair (``state``, ``band``): the window
    (:func:`window_plan`), and read from the launcher
    (``mg_sweep_packed_plan``; needs a card) the threads a block, the
    dynamic shared memory of a block and the resident blocks per SM."""
    instance(PACKED_ENTRIES, state, band, "K8")
    inst = list(PACKED_ENTRIES).index((state, band))
    size = lambda d: torch.empty((), dtype=d).element_size()
    plan = window_plan(nz, tj, Wc, size(state), size(band))
    out = (ctypes.c_int * 3)()
    check_launch(_build.load().mg_sweep_packed_plan(
        inst, nz, tj, Wc, plan["window"], plan["smem_bytes"], out),
        "mg_sweep_packed_plan")
    return {"window": plan["window"],
            **dict(zip(("threads", "smem_bytes", "blocks_per_sm"), out))}


def sweep_chunk(pst, pband_c, ppiv_c, pseam_c, pbq_c, pqs_c, tj: int,
                nz: int, real_matrix: bool, first_chunk: bool,
                last_chunk: bool) -> tuple:
    """K8: one packed sweep of one lane chunk; the kernel for CUDA
    tensors, :func:`sweep_chunk_plain` for CPU tensors."""
    if on_cpu(pst):
        return sweep_chunk_plain(pst, pband_c, ppiv_c, pseam_c, pbq_c, pqs_c,
                                 tj, nz, real_matrix, first_chunk,
                                 last_chunk)
    ntiles = pst.shape[0]
    Wc = ppiv_c.shape[3]
    dt = pst.dtype
    H = ntiles * tj
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"sweep_packed takes float32/float64, got {dt}")
    band = pband_c.dtype
    c_entry = instance(PACKED_ENTRIES, dt, band, "K8")
    if nz < 2:
        raise ValueError("the packed sweep needs nz >= 2")
    shapes = {"pst": (pst, (ntiles, 4 * nz, tj + 4, Wc + 4), dt),
              "pband": (pband_c, (ntiles, 24 * nz, tj + 4, Wc + 3), band),
              "ppiv": (ppiv_c, (ntiles, 12 * nz, tj + 2, Wc), dt),
              "pseam": (pseam_c, (ntiles, 6 * nz, tj + 2, 2), dt),
              "pbq": (pbq_c, (ntiles, 4 * nz, tj + 2, Wc), dt),
              "pqs": (pqs_c, (ntiles, 2 * nz, tj + 2, 2), dt)}
    for name, (x, shape, want) in shapes.items():
        if x.device != pst.device or x.dtype != want:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                             f"{want} on {pst.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{shape}")
    # the kernel's offsets within one tile's band stream are 32-bit
    if pband_c[0].numel() >= 2 ** 31:
        raise ValueError(f"pband: {pband_c[0].numel()} values a tile, the "
                         "kernel indexes a tile's streams in 32 bits")
    plan = window_plan(nz, tj, Wc, pst.element_size(),
                       pband_c.element_size())
    outs = [pst.new_empty((nz, H, Wc)) for _ in range(4)]
    args = _SweepPackedArgs(ptr(pst), ptr(pband_c), ptr(ppiv_c),
                            ptr(pseam_c), ptr(pbq_c), ptr(pqs_c),
                            (ctypes.c_void_p * 4)(*(ptr(o) for o in outs)))
    fn = getattr(_build.load(), c_entry)
    with torch.cuda.device(pst.device):
        rc = fn(ctypes.byref(args), nz, ntiles, tj, Wc, plan["window"],
                plan["smem_bytes"], int(real_matrix), int(first_chunk),
                int(last_chunk), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "sweep_packed")
    LAUNCHES["sweep_packed_bf16" if band == torch.bfloat16
             else "sweep_packed"] += 1
    return tuple(outs)


# ------------------------------------------------------ the whole sweep

def pack_rhs(bq, tj: int, C: int) -> tuple:
    """The RHS streams of one call (sweep_packed.py:659-665): the four
    targets' rows [J0-1, J0+TJ+1) (colour 0 first) and the colour-0 seam
    slivers, packed by K9."""
    H, W = bq[(0, 0)].shape[1:]
    Wc = W // C
    full = tuple(_pad_rows(bq[t], 1, H + 2) for t in _PTARGETS)
    pbq = pack_streams(full, tj, tj + 2, Wc, 0, C)
    se = tuple(_pad_cols(_pad_rows(bq[t], 1, H + 2), 1) for t in _COLOR0)
    return pbq, pack_streams(se, tj, tj + 2, Wc, -2, C)


def pack_state(q, tj: int, C: int) -> tuple:
    """The state stream of one sweep: the four extended quads' rows
    [J0-2, J0+TJ+2) x cols [I0-2, I0+WC+2), packed by K9."""
    H, W = q[(0, 0)].shape[1:]
    e = extend_quads(q)
    full = tuple(_pad_rows(_pad_cols(e[t], 1), 1, H + 4) for t in _TKEYS)
    return pack_streams(full, tj, tj + 4, W // C, 4, C)


def sweep_packed_streams(psts, pbq, pqs, sop: SweepOperator, nz: int,
                         real_matrix: bool) -> dict:
    """K8 on every chunk of pre-packed streams, the chunks concatenated."""
    C = sop.nchunks
    parts = [sweep_chunk(psts[c], sop.pband[c], sop.ppiv[c], sop.pseam[c],
                         pbq[c], pqs[c], sop.tj, nz, real_matrix, c == 0,
                         c == C - 1) for c in range(C)]
    if C == 1:
        return dict(zip(_TKEYS, parts[0]))
    return {t: torch.cat([p[m] for p in parts], dim=2)
            for m, t in enumerate(_TKEYS)}


def relax_packed_sweep(q0, bq, pack: CompactPack, sop: SweepOperator,
                       nsweeps: int) -> dict:
    """``nsweeps`` packed-stream RB sweeps (sweep_packed.py:641
    ``relax_fused_sweep``), quad-parity state in and out: the RHS packed
    once per call, then per sweep ``extend_quads``, the state pack (K9),
    K8 on each chunk and the concatenation of the chunks."""
    nz, H, W = q0[(0, 0)].shape
    check_plan(nz, H, W, sop.tj, sop.nchunks)
    pbq, pqs = pack_rhs(bq, sop.tj, sop.nchunks)
    q = dict(q0)
    for _ in range(nsweeps):
        psts = pack_state(q, sop.tj, sop.nchunks)
        q = sweep_packed_streams(psts, pbq, pqs, sop, nz, pack.real_matrix)
    return q
