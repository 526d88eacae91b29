"""Compact checkerboard (quad-parity) red-black line relaxation — the plain
torch layer under the hand-written kernels of ops/kernels/relax_tiled.py.

Port of ``mgroms_tpu/ops/relax_compact.py``.  The state of a level is kept
in quad-parity form — four arrays ``Q[a][b] = p[:, a::2, b::2]`` of shape
(nz, ny/2, nx/2) — so a colour update computes exactly the active columns:
the two quads of one checkerboard colour are updated from shifted reads of
the complementary quads, with the reference's term order
(mg_relax.f90:263-334).

Index algebra: a point (j, i) = (2J+a, 2I+b); a neighbour offset (dj, di)
lands in quad (a', b') = ((a+dj)%2, (b+di)%2) at quad index
(J + (a+dj-a')/2, I + (b+di-b')/2), so each stencil term is one shifted
slice of one extended quad (:func:`_qread`).  Quad halos (the mirror ring
of bc.extend_h1) come from sibling quads (:func:`extend_quads`).

The low-precision smoother operator (``cfg.fused_bands_bf16``) is
:func:`attach_lp`: the gather operator rounded to bfloat16 beside
row-sum-consistent Thomas pivots (:func:`consistent_pivots`), read by
every smoothing path, plain or kernel, through :func:`smoother_operator`;
residual paths keep the full-precision operator.  The operator comes in
one of two layouts: the 48 per-target gather blocks (``pack.blocks``,
:func:`build_compact_pack`), or the 24 halo-extended band quads that
hold the same values once (:func:`band_quads`, ``pack.ebands``); every
kernel reads either; a level with the band stack
(:func:`build_band_pack`) holds no gather blocks, and its plain paths
slice the stack (:func:`band_views`).

Orderings: 'RB' (two colours, each two target quads solved as one
x-concatenated system) and 'FC' (four colours, one target quad each, the
reference order).  GS has no quad form here or in the JAX package.  The
plain colour update also solves by parallel cyclic reduction
(``tridiag_method='pcr'``, ops/relax.tridiag_pcr), on the full-precision
operator only, as the JAX package's does; the kernels solve by Thomas.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .relax import thomas_factor, thomas_factored_unrolled, tridiag_pcr
from .transfer import _interleave

Quads = Dict[Tuple[int, int], torch.Tensor]

# target-quad key order used everywhere a pack is indexed
_TKEYS = ((0, 0), (0, 1), (1, 0), (1, 1))


def split_quads(x: torch.Tensor) -> Quads:
    """(nz, ny, nx) -> {(a, b): x[:, a::2, b::2]} (contiguous copies)."""
    return {(a, b): x[:, a::2, b::2].contiguous()
            for a in (0, 1) for b in (0, 1)}


def merge_quads(q: Quads) -> torch.Tensor:
    """Inverse of :func:`split_quads`."""
    col0 = _interleave(q[(0, 0)], q[(1, 0)], axis=-2)
    col1 = _interleave(q[(0, 1)], q[(1, 1)], axis=-2)
    return _interleave(col0, col1, axis=-1)


class QuadField:
    """A level state kept in quad-parity layout across the V-cycle: four
    (nz, ny/2, nx/2) tensors in ``_TKEYS`` order.  Merging back to the full
    array happens once per solve.  ``+`` is the prolongation's additive
    correction (mg_intergrids.f90:224-226), per quad."""

    __slots__ = ("quads",)

    def __init__(self, quads):
        self.quads = tuple(quads)

    def __add__(self, other: "QuadField") -> "QuadField":
        return QuadField(a + b for a, b in zip(self.quads, other.quads))

    def asdict(self) -> Quads:
        return dict(zip(_TKEYS, self.quads))

    @classmethod
    def fromdict(cls, q: Quads) -> "QuadField":
        return cls(q[t] for t in _TKEYS)

    @classmethod
    def split(cls, x: torch.Tensor) -> "QuadField":
        return cls.fromdict(split_quads(x))

    def merge(self) -> torch.Tensor:
        return merge_quads(self.asdict())


def quad_ext_bands(ce: torch.Tensor) -> Quads:
    """Quad-sample a halo-extended field ``ce`` (..., ny+2, nx+2) into four
    extended quads (..., H+2, W+2).  Extended row R of quad a holds full
    j = 2(R-1)+a; the two never-read rows (j = -2 for a=0, j = ny+1 for
    a=1) are edge duplicates."""
    odd_j = ce[..., 1::2, :]       # j = 0, 2, ..., ny      (H+1 rows)
    even_j = ce[..., 0::2, :]      # j = -1, 1, ..., ny-1   (H+1 rows)
    rows = {0: torch.cat([odd_j[..., :1, :], odd_j], dim=-2),
            1: torch.cat([even_j, even_j[..., -1:, :]], dim=-2)}
    out = {}
    for a in (0, 1):
        r = rows[a]
        odd_i = r[..., :, 1::2]
        even_i = r[..., :, 0::2]
        out[(a, 0)] = torch.cat([odd_i[..., :, :1], odd_i], dim=-1)
        out[(a, 1)] = torch.cat([even_i, even_i[..., :, -1:]], dim=-1)
    return out


def extend_quads(q: Quads) -> Quads:
    """Halo-1 extension of the four quads with the homogeneous-Neumann
    mirror rule of bc.extend_h1 (edge copy), halos sourced from sibling
    quads."""
    rj = {}
    for b in (0, 1):
        q0, q1 = q[(0, b)], q[(1, b)]
        # quad 0 rows: [junk(j=-2), j=0..ny-2, halo j=ny = p[ny-1] = q1[-1]]
        rj[(0, b)] = torch.cat([q0[:, :1], q0, q1[:, -1:]], dim=1)
        # quad 1 rows: [halo j=-1 = p[0] = q0[0], j=1..ny-1, junk(j=ny+1)]
        rj[(1, b)] = torch.cat([q0[:, :1], q1, q1[:, -1:]], dim=1)
    e = {}
    for a in (0, 1):
        r0, r1 = rj[(a, 0)], rj[(a, 1)]
        e[(a, 0)] = torch.cat([r0[:, :, :1], r0, r1[:, :, -1:]], dim=2)
        e[(a, 1)] = torch.cat([r0[:, :, :1], r1, r1[:, :, -1:]], dim=2)
    return e


def _kshift(x: torch.Tensor, dk: int) -> torch.Tensor:
    """Zero-padded k-shift (no vertical halo — BCs live in the bands)."""
    if dk == 0:
        return x
    z = torch.zeros_like(x[:1])
    if dk == 1:
        return torch.cat([x[1:], z], dim=0)
    return torch.cat([z, x[:-1]], dim=0)


def _qread(e: Quads, a: int, b: int, dj: int, di: int, dk: int = 0
           ) -> torch.Tensor:
    """Value at offset (dk, dj, di) from every target-quad-(a,b) point:
    one shifted interior slice of the source quad."""
    a2, b2 = (a + dj) % 2, (b + di) % 2
    rj = (a + dj - a2) // 2
    ri = (b + di - b2) // 2
    x = e[(a2, b2)]
    H, W = x.shape[-2] - 2, x.shape[-1] - 2
    return _kshift(x[:, 1 + rj:1 + rj + H, 1 + ri:1 + ri + W], dk)


# The neighbour gather for one target quad, term for term the quad form of
# ops/stencil.offdiag_columns (mg_relax.f90:263-300).  Entries:
# (band n, (bk, bj, bi) band offset, (pk, pj, pi) state offset), in the
# summation order of the reference gather.  The band reads are constant
# operator data, pre-sliced once per level into aligned blocks
# (:class:`CompactPack`).
_BASE_TERMS = (
    (3, (0, 0, 0), (1, -1, 0)),
    (3, (-1, 1, 0), (-1, 1, 0)),
    (4, (0, 0, 0), (0, -1, 0)),
    (4, (0, 1, 0), (0, 1, 0)),
    (5, (0, 0, 0), (-1, -1, 0)),
    (5, (1, 1, 0), (1, 1, 0)),
    (6, (0, 0, 0), (1, 0, -1)),
    (6, (-1, 0, 1), (-1, 0, 1)),
    (7, (0, 0, 0), (0, 0, -1)),
    (7, (0, 0, 1), (0, 0, 1)),
    (8, (0, 0, 0), (-1, 0, -1)),
    (8, (1, 0, 1), (1, 0, 1)),
)
# bottom-level (k=1) horizontal-diagonal couplings (mg_relax.f90:271-276);
# the first/third band reads alias _BASE_TERMS entries
_REAL_TERMS = (
    (5, (0, 0, 0), (0, 1, -1)),
    (5, (0, -1, 1), (0, -1, 1)),
    (8, (0, 0, 0), (0, -1, -1)),
    (8, (0, 1, 1), (0, 1, 1)),
)


def gather_keys(real_matrix: bool) -> tuple:
    """Unique (band, band-offset) reads of the gather, in first-use order
    (12 keys, 14 when ``real_matrix``)."""
    keys = []
    terms = _BASE_TERMS + (_REAL_TERMS if real_matrix else ())
    for n, boff, _ in terms:
        k = (n, boff)
        if k not in keys:
            keys.append(k)
    return tuple(keys)


def real_only_keys() -> tuple:
    """gather_keys(True) minus gather_keys(False), in appended order."""
    base = set(gather_keys(False))
    return tuple(k for k in gather_keys(True) if k not in base)


class LowPrecision(NamedTuple):
    """The low-precision smoother operator of a pack (:func:`attach_lp`),
    per target quad in ``_TKEYS`` order: the gather blocks and the 'real'
    pair in bfloat16 (None on a band-stack level), the Thomas pivots
    ``bet`` of the rounded operator (state dtype), and the band stack in
    bfloat16 where the pack has one."""

    blocks: object   # per target: (nz, H, 12*W) bfloat16, or None
    rblocks: object  # per target: (1, H, 2*W) bfloat16, None unless 'real'
    bet: tuple       # per target: (nz, H, W)
    ebands: object = None   # band_quads in bfloat16, or None


class CompactPack(NamedTuple):
    """Per-level smoother operator in quad-gather layout.  Every field but
    ``ebands`` is a tuple over target quads (``_TKEYS`` order) of
    contiguous tensors.

    The gather operator is held in one of two layouts:

    - ``blocks[m]``: the 12 base gather blocks of target m side by side in
      one (nz, H, 12*W) array, in ``gather_keys(False)`` order; the two
      real-only keys live in ``rblocks[m]`` (1, H, 2*W) as their k=1
      plane (the only plane read, mg_relax.f90:271-276), None unless
      'real'.  On the CPU the levels smoothed by K1 and the tiles of a
      distributed level have them (:func:`build_compact_pack`), as the
      JAX package's do.
    - ``ebands``: the 24 halo-extended band quads (:func:`band_quads`),
      each value once where the blocks hold it twice.  Every quad level
      and tile on the card, and the levels the colour-fused sweep K4
      smooths on the CPU, have only it (:func:`build_band_pack`, blocks
      and rblocks None; solver.band_stack_wanted): the kernels and the
      plain versions (through :func:`band_views`) read it, and the 48
      blocks (+3.2 GB at CUC level 0 in float32) are not built.  A tile's
      stack is cut from its extended cA, whose halo is the seam's.
      :func:`attach_bands` adds it beside the blocks.

    ``bet`` holds the precomputed reciprocal Thomas pivots (ops/relax.
    thomas_factor; the back-substitution multipliers ud*bet are recomputed
    where used, as the kernels do); ``d``/``ud`` the in-column diagonal and
    off-diagonal.  ``lp`` holds the low-precision smoother operator
    (:class:`LowPrecision`, :func:`attach_lp`) or None: in the layout of
    the pack's own operator (its ``blocks`` or its ``ebands`` rounded), and
    always its pivots.  On a K4 level in perf mode the pack therefore holds
    the band stack twice, in float32 (residuals need the true operator)
    and in bfloat16 (``lp.ebands``, the smoother's).
    """

    blocks: object   # per target: (nz, H, 12*W), or None
    d: tuple         # per target: (nz, H, W)
    ud: tuple        # per target: (nz-1, H, W)
    bet: tuple       # per target: (nz, H, W)
    real_matrix: bool
    rblocks: object = None
    lp: object = None
    ebands: object = None    # (24, nz+2, H+2, W+2), or None


def wide_slices(wide: torch.Tensor, nkeys: int) -> tuple:
    """The ``nkeys`` (nz, H, W) blocks of a side-by-side (nz, H, nkeys*W)
    array."""
    W = wide.shape[2] // nkeys
    return tuple(wide[:, :, m * W: (m + 1) * W] for m in range(nkeys))


def key_views(blocks_w: torch.Tensor, rb=None) -> tuple:
    """Per-key (nz, H, W) views in gather_keys(rb is not None) order: the
    12 base blocks of the side-by-side array, then the two plane-0 halves
    of the 'real' pair ``rb`` (1, H, 2*W)."""
    base = wide_slices(blocks_w, len(gather_keys(False)))
    if rb is None:
        return base
    W = rb.shape[2] // 2
    return base + (rb[:, :, :W], rb[:, :, W:])


def band_views(ebands: torch.Tensor, m: int, real_matrix: bool) -> tuple:
    """Per-key (nz, H, W) views of target ``m``'s gather operator in
    gather_keys(real) order, sliced out of the band stack ``ebands``
    (24, nz+2, H+2, W+2): key (n, (bk, bj, bi)) of target (a, b) is band
    quad (n, ((a+bj)%2, (b+bi)%2)) at planes 1+bk .. nz+bk (the stack's
    zero end planes are _kshift's padding), shifted in rows and columns
    by the index algebra of :func:`_qread` — the values and shape of the
    gather block :func:`build_compact_pack` cuts.  The real-only keys are
    plane 0 only, as ``rblocks``' halves."""
    a, b = _TKEYS[m]
    nz, H, W = (s - 2 for s in ebands.shape[1:])
    views = []
    for n, (bk, bj, bi) in gather_keys(real_matrix):
        a2, b2 = (a + bj) % 2, (b + bi) % 2
        rj, ri = (a + bj - a2) // 2, (b + bi - b2) // 2
        views.append(ebands[band_index(n, (a2, b2)), 1 + bk:1 + bk + nz,
                            1 + rj:1 + rj + H, 1 + ri:1 + ri + W])
    nbase = len(gather_keys(False))
    return tuple(views[:nbase]) + tuple(v[:1] for v in views[nbase:])


def block_views(pack: CompactPack, m: int, lp: bool = False) -> tuple:
    """Per-key operator views of target ``m`` in gather_keys(real) order:
    the gather blocks, or slices of the band stack on a level without
    them (:func:`band_views`); ``lp`` selects the low-precision smoother
    copies (``pack.lp``)."""
    src = pack.lp if lp else pack
    if src.blocks is None:
        return band_views(src.ebands, m, pack.real_matrix)
    return key_views(src.blocks[m],
                     src.rblocks[m] if pack.real_matrix else None)


def smoother_operator(pack: CompactPack, dtype):
    """``(blocks, rblocks, bet, block dtype)`` the smoother uses, per target
    in ``_TKEYS`` order (blocks and rblocks None on a band-stack level:
    :func:`block_views` reads its stack), for state of type ``dtype``: the
    low-precision consistent operator (bfloat16) when the pack has one,
    else the full-precision one.  The bfloat16 band stack serves float32
    and float64 state (K4's instances, the JAX package's bfloat16 sweep
    bands of either state type); bfloat16 gather blocks serve float32
    state only.  Values of another type than the state come only with
    their consistent pivots, in ``pack.lp`` and in the state's type: the
    full-precision pivots with rounded values break the operator's row
    sums (:func:`consistent_pivots`).  Residual paths never use this (they
    need the true A)."""
    lp = pack.lp
    if lp is None:
        src, band = pack, dtype
    elif lp.blocks is not None and dtype != torch.float32:
        raise ValueError(f"low-precision blocks need float32 state, got "
                         f"{dtype}")
    elif dtype not in (torch.float32, torch.float64):
        raise ValueError(f"low-precision bands need float32 or float64 "
                         f"state, got {dtype}")
    else:
        src, band = lp, torch.bfloat16
    held = src.blocks if src.blocks is not None else (src.ebands,)
    if src.bet is None or any(x is None or x.dtype != band for x in held):
        raise ValueError(f"{held[0].dtype if held[0] is not None else None}"
                         f" operator for {dtype} state without its "
                         "consistent pivots (pack.lp)")
    if lp is not None and lp.bet[0].dtype != dtype:
        raise ValueError(f"{lp.bet[0].dtype} low-precision pivots for "
                         f"{dtype} state")
    return src.blocks, src.rblocks, src.bet, band


def consistent_pivots(pack: CompactPack, band_dtype) -> tuple:
    """Thomas pivots ``bet'`` per target (``_TKEYS`` order) of the
    row-sum-consistent low-precision smoother operator.

    Rounding the gather blocks to ``band_dtype`` while the pivots keep the
    full-precision diagonal breaks the diag = -(row sum) identity the
    operator is built on (mg_define_matrix.f90:615-657), and the smoother
    then amplifies the constant mode (the JAX package's round-3 negative
    result: CUC stalled at a relative residual of 0.17).  So the rounded
    blocks are the smoother's operator A', with its diagonal rebuilt so the
    row sums match A's:

        d' = d + gather(1, A - A')     (the gather against an all-ones state)

    and ``bet', _ = thomas_factor(d', ud)``."""
    bets = []
    for m, (a, b) in enumerate(_TKEYS):
        blocks = block_views(pack, m)
        deltas = tuple(x - x.to(band_dtype).to(x.dtype) for x in blocks)
        nz, H, W = pack.d[m].shape
        ones = pack.d[m].new_ones((nz, H + 2, W + 2))
        d2 = pack.d[m] + gather_blocks({t: ones for t in _TKEYS}, deltas,
                                       a, b, pack.real_matrix)
        bets.append(thomas_factor(d2, pack.ud[m])[0])
    return tuple(bets)


def attach_lp(pack: CompactPack, band_dtype=torch.bfloat16) -> CompactPack:
    """Attach the low-precision smoother operator: the gather operator
    rounded to ``band_dtype`` (round to nearest even) and the
    row-sum-consistent pivots of the rounded operator
    (:func:`consistent_pivots`).  One-time build work.  On a band-stack
    level (no blocks) the rounded operator is the stack rounded,
    ``lp.ebands``."""
    bet = consistent_pivots(pack, band_dtype)
    if pack.blocks is None:
        return pack._replace(lp=LowPrecision(
            blocks=None, rblocks=None, bet=bet,
            ebands=stack_bands([pack.ebands[i, 1:-1] for i in range(NBANDS)],
                               band_dtype)))
    rb = (tuple(r.to(band_dtype) for r in pack.rblocks)
          if pack.real_matrix else None)
    return pack._replace(lp=LowPrecision(
        blocks=tuple(b.to(band_dtype) for b in pack.blocks), rblocks=rb,
        bet=bet))


GATHER_BANDS = range(3, 9)     # the bands the gather reads (cA[2] .. cA[7])
NBANDS = len(GATHER_BANDS) * len(_TKEYS)


def band_quads(cA: torch.Tensor, dtype=None) -> torch.Tensor:
    """The gather's operator as the 24 halo-extended band quads, stacked
    (:func:`stack_bands`): entry :func:`band_index` (band n = 3..8, i.e.
    ``cA[n - 1]``, then quad in ``_TKEYS`` order) holds
    :func:`quad_ext_bands` of the band in its planes 1..nz, (H+2, W+2)
    each, between two zero planes, the padding of a k-shifted read
    (:func:`_kshift`); in ``dtype`` (default ``cA``'s; a narrower type
    rounds as ``.to`` does).  ``ebands[i, 1:-1]`` is the content of the
    JAX package's ``SweepOperator.ebands[0][i]`` without its padding row
    and columns.  Gather block (n, boff) of target (a, b) is the slice
    ``_qread`` takes of one of them, so each band quad holds the values of
    two gather blocks."""
    nz, H, W = cA.shape[1], cA.shape[2] // 2 - 1, cA.shape[3] // 2 - 1
    stack = _empty_stack(nz, H, W, dtype or cA.dtype, cA.device)
    for n in GATHER_BANDS:       # one band's quad temporaries at a time
        qe = quad_ext_bands(cA[n - 1])
        for t in _TKEYS:
            stack[band_index(n, t), 1:nz + 1] = qe[t]
    return stack


BAND_TILE = 64    # columns of a tile of the stack (csrc kBandTile)


def band_layout(W: int, itemsize: int) -> tuple:
    """``(lpad, pitch)`` of a row of the band stack of a level W quads
    wide: extended column C sits at storage column C + lpad (extended
    column 1, a tile's first, on a 16-byte boundary) in rows of ``pitch``
    values (16-byte multiples, with room for every tile's staged span of
    BAND_TILE + 16 bytes of values)."""
    e16 = 16 // itemsize
    return e16 - 1, -(-W // BAND_TILE) * BAND_TILE + 2 * e16


def check_band_stack(ebands, shape, dtype, device) -> None:
    """A kernel's check of the band stack it reads: one tensor of ``shape``
    and ``dtype`` on ``device``, a view of rows of :func:`band_layout`'s
    pitch over storage that holds every row whole (the kernels address the
    storage: K4 stages aligned spans of it), under 2**32 values."""
    if not isinstance(ebands, torch.Tensor):
        raise ValueError("the band stack must be one tensor (band_quads)")
    if (ebands.dtype != dtype or ebands.device != device
            or tuple(ebands.shape) != shape):
        raise ValueError(f"band stack: {ebands.dtype} {tuple(ebands.shape)}"
                         f" on {ebands.device}, expected {dtype} {shape} on "
                         f"{device}")
    isz = ebands.element_size()
    lpad, pitch = band_layout(shape[3] - 2, isz)
    rows = shape[0] * shape[1] * shape[2]
    start = ebands.storage_offset() - lpad
    if (ebands.stride() != (shape[1] * shape[2] * pitch, shape[2] * pitch,
                            pitch, 1)
            or start < 0 or (ebands.data_ptr() - lpad * isz) % 16
            or ebands.untyped_storage().nbytes() < (start + rows * pitch) * isz
            or rows * pitch >= 2 ** 32):
        raise ValueError("the band stack must be a view of 16-byte aligned "
                         "rows of band_layout's pitch, under 2**32 values "
                         "(band_quads)")


def stack_bands(quads, dtype) -> torch.Tensor:
    """The 24 band quads ``quads`` ((nz, H+2, W+2) each, in
    :func:`band_quads` order) as a (24, nz+2, H+2, W+2) tensor in
    ``dtype``, planes 0 and nz+1 zero: a view of rows padded to
    :func:`band_layout`'s pitch, so that the sweep kernel stages each
    tile row of a band quad as one aligned span."""
    nz, H2, W2 = quads[0].shape
    stack = _empty_stack(nz, H2 - 2, W2 - 2, dtype, quads[0].device)
    for i, x in enumerate(quads):
        stack[i, 1:nz + 1] = x
    return stack


def _empty_stack(nz, H, W, dtype, device) -> torch.Tensor:
    """A zero band stack (24, nz+2, H+2, W+2) in ``dtype``: a view of rows
    of :func:`band_layout`'s pitch."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    lpad, pitch = band_layout(W, itemsize)
    buf = torch.zeros((NBANDS, nz + 2, H + 2, pitch), dtype=dtype,
                      device=device)
    return buf[..., lpad:lpad + W + 2]


def band_index(n: int, quad) -> int:
    """Position of band ``n``'s extended quad ``quad`` in
    :func:`band_quads`."""
    return (n - GATHER_BANDS[0]) * len(_TKEYS) + _TKEYS.index(quad)


def attach_bands(pack: CompactPack, cA: torch.Tensor) -> CompactPack:
    """Attach the band quads of ``cA`` (:func:`band_quads`) that the
    smoother reads: in the state type as ``pack.ebands``, or, where the
    pack carries the low-precision operator, rounded to its type as
    ``pack.lp.ebands`` (rounding a band and slicing it equals slicing and
    rounding, so the products equal those of the rounded blocks).
    One-time build work."""
    if pack.lp is None:
        return pack._replace(ebands=band_quads(cA))
    return pack._replace(lp=pack.lp._replace(
        ebands=band_quads(cA, pack.lp.blocks[0].dtype)))


def _column_fields(cA: torch.Tensor):
    """Per target (``_TKEYS`` order): the in-column diagonal ``d``, the
    off-diagonal ``ud`` and the reciprocal Thomas pivots ``bet``."""
    q1, q2 = quad_ext_bands(cA[0]), quad_ext_bands(cA[1])
    ds, uds, bets = [], [], []
    for t in _TKEYS:
        d = q1[t][:, 1:-1, 1:-1].contiguous()
        ud = q2[t][1:, 1:-1, 1:-1].contiguous()
        ds.append(d)
        uds.append(ud)
        bets.append(thomas_factor(d, ud)[0])
    return tuple(ds), tuple(uds), tuple(bets)


def build_band_pack(cA: torch.Tensor, real_matrix: bool) -> CompactPack:
    """The pack of a level whose gather operator is held only as the band
    stack (:func:`band_quads`): ``d``, ``ud``, ``bet`` and ``ebands``, no
    gather blocks.  One-time work per level; one band's quad-sampled
    temporaries exist at a time."""
    d, ud, bet = _column_fields(cA)
    return CompactPack(blocks=None, d=d, ud=ud, bet=bet,
                       real_matrix=real_matrix, ebands=band_quads(cA))


def build_compact_pack(cA: torch.Tensor, real_matrix: bool) -> CompactPack:
    """Pre-slice the extended band stack into the gather-block layout.
    One-time work per level; the quad-sampled bands are temporaries."""
    qa = [quad_ext_bands(cA[n]) for n in range(cA.shape[0])]
    blocks, rbs = [], []
    for (a, b) in _TKEYS:
        blocks.append(torch.cat([
            _qread(qa[n - 1], a, b, bj, bi, bk)
            for (n, (bk, bj, bi)) in gather_keys(False)], dim=2))
        if real_matrix:
            rbs.append(torch.cat([
                _qread(qa[n - 1], a, b, bj, bi, bk)[:1]
                for (n, (bk, bj, bi)) in real_only_keys()], dim=2))
    d, ud, bet = _column_fields(cA)
    return CompactPack(blocks=tuple(blocks), d=d, ud=ud, bet=bet,
                       real_matrix=real_matrix,
                       rblocks=tuple(rbs) if real_matrix else None)


def gather_blocks(e: Quads, blocks_t, a: int, b: int,
                  real_matrix: bool) -> torch.Tensor:
    """Off-column coupling sum for target quad (a, b) from the per-key
    blocks ``blocks_t`` (:func:`block_views`): the 12 base terms summed in
    ``_BASE_TERMS`` order; for 'real', the four plane-0 terms summed into
    ``x0`` and added as ``s[:1] + x0``."""
    keys = gather_keys(real_matrix)
    idx = {k: i for i, k in enumerate(keys)}

    def term(n, boff, poff, plane0=False):
        pk, pj, pi = poff
        blk = blocks_t[idx[(n, boff)]]
        st = _qread(e, a, b, pj, pi, pk)
        if plane0:
            return blk[:1] * st[:1]
        return blk * st

    s = None
    for n, boff, poff in _BASE_TERMS:
        t = term(n, boff, poff)
        s = t if s is None else s + t
    if real_matrix:
        x0 = None
        for n, boff, poff in _REAL_TERMS:
            t = term(n, boff, poff, plane0=True)    # pk == 0 for all four
            x0 = t if x0 is None else x0 + t
        s = torch.cat([s[:1] + x0, s[1:]], dim=0)
    return s


_RB_TARGETS = (((0, 0), (1, 1)),   # color 0: (i + j) even
               ((0, 1), (1, 0)))   # color 1: (i + j) odd
# FC reference order (mg_relax.f90:214-228): (i even, j even), (i even,
# j odd), (i odd, j even), (i odd, j odd); the quad key is (j%2, i%2)
_FC_TARGETS = (((0, 0),), ((1, 0),), ((0, 1),), ((1, 1),))


def colour_targets(kind: str) -> tuple:
    """The target quads of each colour of one sweep of ordering ``kind``
    ('RB' or 'FC')."""
    if kind == "RB":
        return _RB_TARGETS
    if kind == "FC":
        return _FC_TARGETS
    raise NotImplementedError(f"no quad-parity form of relax kind {kind!r} "
                              "(RB and FC only)")


def plain_color_update(q: Quads, bq: Quads, pack: CompactPack, targets,
                       emit: bool, real_matrix: bool, extend_fn=None,
                       tridiag_method: str = "thomas"):
    """One colour update of ``targets`` in plain torch, with the smoother
    operator (:func:`smoother_operator`; low-precision blocks are upcast
    at read).  The targets read the same pre-colour extension and are
    solved as one x-concatenated tridiagonal system (factored Thomas,
    ud*bet recomputed per plane as in the kernels; with ``tridiag_method=
    'pcr'`` parallel cyclic reduction on d and ud, and the full-precision
    operator even where the pack has a low-precision one: a rounded
    gather against the true diagonal would break the row sums that the
    low-precision pivots restore, mgroms_tpu/ops/relax_compact.py:448).
    With ``emit``, each target's raw residual from its own gather comes
    too (full-precision packs only, :func:`relax_emit_last_color`).
    ``extend_fn`` maps the quads to their halo-extended forms (default
    :func:`extend_quads`).  Returns ``(q, {target: raw r})``."""
    ti = {t: i for i, t in enumerate(_TKEYS)}
    W = q[(0, 0)].shape[2]
    e = (extend_fn or extend_quads)(q)
    dt = q[(0, 0)].dtype
    pcr = tridiag_method == "pcr"
    lp = pack.lp is not None and not pcr
    gs = {t: gather_blocks(e, tuple(v.to(dt) for v in block_views(
        pack, ti[t], lp=lp)), t[0], t[1], real_matrix) for t in targets}
    cat = lambda f: torch.cat([f[ti[t]] for t in targets], dim=-1)
    rhs = torch.cat([bq[t] - gs[t] for t in targets], dim=-1)
    if pcr:
        sol = tridiag_pcr(cat(pack.d), cat(pack.ud), rhs)
    else:
        _, _, bet, _ = smoother_operator(pack, dt)
        sol = thomas_factored_unrolled(cat(bet), None, cat(pack.ud), rhs)
    q = dict(q)
    info = {}
    for n, t in enumerate(targets):
        q[t] = sol[..., n * W:(n + 1) * W]
        if emit:
            info[t] = residual_from_gather(bq[t], q[t], pack.d[ti[t]],
                                           pack.ud[ti[t]], gs[t])
    return q, info


def relax_compact(p: torch.Tensor, b: torch.Tensor, cA, nsweeps: int,
                  kind: str, real_matrix: bool,
                  tridiag_method: str = "thomas", extend_fn=None,
                  pack: CompactPack | None = None) -> torch.Tensor:
    """``nsweeps`` RB or FC line-smoothing sweeps in quad-parity form on a
    full-layout state (even ny, nx).  ``extend_fn`` maps the four quads to
    their halo-extended forms: the single-tile mirror rule
    (:func:`extend_quads`) by default, the seam exchange
    (parallel/exchange.extend_quads_shard) on a tile of a distributed
    level, whose even dims make local quad parity the global one.
    ``pack`` is the persisted gather-block operator, built from ``cA``
    here if absent; ``tridiag_method`` as :func:`plain_color_update`."""
    nz, ny, nx = p.shape
    assert ny % 2 == 0 and nx % 2 == 0, "compact relax needs even ny, nx"
    if pack is None:
        pack = build_compact_pack(cA, real_matrix)
    q = relax_compact_quads(split_quads(p), split_quads(b), pack, nsweeps,
                            kind, real_matrix,
                            tridiag_method=tridiag_method,
                            extend_fn=extend_fn)
    return merge_quads(q)


def relax_compact_quads(q0: Quads, bq: Quads, pack: CompactPack,
                        nsweeps: int, kind: str, real_matrix: bool,
                        tridiag_method: str = "thomas",
                        extend_fn=None) -> Quads:
    """``nsweeps`` RB or FC line-smoothing sweeps, state in and out in
    quad-parity layout, one :func:`plain_color_update` per colour
    (:func:`colour_targets`), with the smoother operator
    (:func:`smoother_operator`) and the halo of ``extend_fn`` (default
    :func:`extend_quads`), solved by ``tridiag_method``."""
    q = dict(q0)
    for _ in range(nsweeps):
        for targets in colour_targets(kind):
            q, _ = plain_color_update(q, bq, pack, targets, False,
                                      real_matrix, extend_fn=extend_fn,
                                      tridiag_method=tridiag_method)
    return q


def _residual_one_core(e: Quads, bq_t, d, ud, blocks_t,
                       t: Tuple[int, int], real_matrix: bool
                       ) -> torch.Tensor:
    """Fresh residual of one target quad from the extended state ``e`` —
    the expression every fused or partial residual path reproduces.  All
    operands may be consistently sliced sub-boxes (:func:`_residual_box`)."""
    pq = e[t][:, 1:-1, 1:-1]
    z1 = torch.zeros_like(ud[:1])
    lo2 = torch.cat([z1, ud], dim=0)   # cA2(k),   couples p(k-1)
    hi2 = torch.cat([ud, z1], dim=0)   # cA2(k+1), couples p(k+1)
    return (bq_t
            - d * pq
            - lo2 * _kshift(pq, -1)
            - hi2 * _kshift(pq, 1)
            - gather_blocks(e, blocks_t, t[0], t[1], real_matrix))


def _residual_one(e: Quads, bq_t, pack: CompactPack, m: int,
                  t: Tuple[int, int], real_matrix: bool) -> torch.Tensor:
    return _residual_one_core(e, bq_t, pack.d[m], pack.ud[m],
                              block_views(pack, m), t, real_matrix)


def _residual_box(e: Quads, bq_t, pack: CompactPack, m: int,
                  t: Tuple[int, int], real_matrix: bool,
                  jsl: slice = slice(None), isl: slice = slice(None)
                  ) -> torch.Tensor:
    """Fresh residual restricted to quad rows ``jsl`` x cols ``isl``."""
    def ext(s):
        # output rows [start, stop) read extended rows [start, stop + 2)
        return slice(None) if s == slice(None) \
            else slice(s.start, s.stop + 2)

    e_sub = {k: x[:, ext(jsl), ext(isl)] for k, x in e.items()}
    blocks = tuple(blk[:, jsl, isl] for blk in block_views(pack, m))
    return _residual_one_core(e_sub, bq_t[:, jsl, isl],
                              pack.d[m][:, jsl, isl],
                              pack.ud[m][:, jsl, isl],
                              blocks, t, real_matrix)


def residual_from_gather(bq_t, sol, d, ud, g) -> torch.Tensor:
    """Residual of a just-updated target from its own colour update's
    gather ``g`` (r = b - D x - g, :func:`_residual_one` order) — the
    plain form of the emit kernel's second output."""
    z1 = torch.zeros_like(ud[:1])
    lo2 = torch.cat([z1, ud], dim=0)
    hi2 = torch.cat([ud, z1], dim=0)
    return (bq_t
            - d * sol
            - lo2 * _kshift(sol, -1)
            - hi2 * _kshift(sol, 1)
            - g)


def _plane0_of_kshift(x, pk: int):
    """Plane-0 row of ``_kshift(x, pk)`` without materializing the shift."""
    if pk == 0:
        return x[:1]
    if pk == 1:
        return x[1:2]
    return torch.zeros_like(x[:1])


def _residual_plane0(e: Quads, bq_t, pack: CompactPack, m: int,
                     t: Tuple[int, int], real_matrix: bool) -> torch.Tensor:
    """Plane-0 row of :func:`_residual_one`, term for term in the same
    association order.  Patches the 'real' diagonal couplings of an
    emitted residual: they read the same-colour sibling quad, whose
    post-update values the in-sweep gather predates."""
    a, b = t
    keys = gather_keys(real_matrix)
    idx = {k: i for i, k in enumerate(keys)}
    blocks_t = block_views(pack, m)

    def term0(n, boff, poff):
        pk, pj, pi = poff
        a2, b2 = (a + pj) % 2, (b + pi) % 2
        rj = (a + pj - a2) // 2
        ri = (b + pi - b2) // 2
        x = e[(a2, b2)]
        H, W = x.shape[-2] - 2, x.shape[-1] - 2
        st = _plane0_of_kshift(x[:, 1 + rj:1 + rj + H, 1 + ri:1 + ri + W],
                               pk)
        return blocks_t[idx[(n, boff)]][:1] * st

    g0 = None
    for n, boff, poff in _BASE_TERMS:
        v = term0(n, boff, poff)
        g0 = v if g0 is None else g0 + v
    if real_matrix:
        x0 = None
        for n, boff, poff in _REAL_TERMS:
            v = term0(n, boff, poff)
            x0 = v if x0 is None else x0 + v
        g0 = g0 + x0
    pq = e[t][:, 1:-1, 1:-1]
    ud = pack.ud[m]
    z0 = torch.zeros_like(bq_t[:1])
    # lo2[0] = 0 and _kshift(pq,-1)[0] = 0: the term is an exact +0.0
    return (bq_t[:1]
            - pack.d[m][:1] * pq[:1]
            - z0
            - ud[:1] * pq[1:2]
            - g0)


def residual_quads(q: Quads, bq: Quads, pack: CompactPack,
                   real_matrix: bool, extend_fn=None, targets=None) -> Quads:
    """r = b - A p with state and result in quad-parity layout — term for
    term ops/stencil.residual in quad form, with the halo of ``extend_fn``
    (default :func:`extend_quads`).  ``targets`` restricts the output to a
    subset of quads."""
    e = (extend_fn or extend_quads)(q)
    ti = {t: i for i, t in enumerate(_TKEYS)}
    return {t: _residual_one(e, bq[t], pack, ti[t], t, real_matrix)
            for t in (targets if targets is not None else _TKEYS)}


def _ring_index(t, r):
    """(row J, column Ic) of target ``t``'s mirror ring in a (.., H, W)
    residual: the j = -1 side for a = 0, the j = ny side for a = 1, and
    likewise in i by b."""
    a, b = t
    return (0 if a == 0 else r.shape[1] - 1), (0 if b == 0 else r.shape[2] - 1)


def _patch_emitted_residual(e2: Quads, bq_t, pack: CompactPack, m: int,
                            t: Tuple[int, int], real_matrix: bool,
                            r) -> torch.Tensor:
    """Make an emitted last-colour residual equal to a fresh one.

    Two places where the in-sweep gather differs from a fresh one:
      1. the boundary ring — the Neumann mirror halo reflects the target's
         own colour, so the solve consumed pre-update mirror values: one
         quad row and one quad column per target, recomputed fresh;
      2. the 'real' plane-0 diagonal couplings read the same-colour
         sibling: plane 0 is recomputed fresh.
    """
    J, Ic = _ring_index(t, r)
    out = r.clone()
    out[:, :, Ic:Ic + 1] = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                                         isl=slice(Ic, Ic + 1))
    # the row patch wins at the corner (J, Ic), as in the JAX package
    out[:, J:J + 1] = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                                    jsl=slice(J, J + 1))
    if real_matrix:
        out[:1] = _residual_plane0(e2, bq_t, pack, m, t, real_matrix)
    return out


def _patched_zsum(e2: Quads, bq_t, pack: CompactPack, m: int,
                  t: Tuple[int, int], real_matrix: bool, r) -> torch.Tensor:
    """z-pair sums of a patched emitted residual, with the patches applied
    after the z-sum (plane-0 pair = fresh plane 0 + raw plane 1; ring
    rows/columns fully fresh)."""
    J, Ic = _ring_index(t, r)
    zs = r[0::2] + r[1::2]
    if real_matrix:
        p0 = _residual_plane0(e2, bq_t, pack, m, t, real_matrix)
        zs[:1] = p0 + r[1:2]
    row = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                        jsl=slice(J, J + 1))
    zs[:, J:J + 1] = row[0::2] + row[1::2]
    col = _residual_box(e2, bq_t, pack, m, t, real_matrix,
                        isl=slice(Ic, Ic + 1))
    zs[:, :, Ic:Ic + 1] = col[0::2] + col[1::2]
    return zs


def relax_emit_last_color(q0: Quads, bq: Quads, pack: CompactPack,
                          nsweeps: int, real_matrix: bool, extend_fn=None,
                          sweep_fn=None, color_update_fn=None,
                          tridiag_method: str = "thomas"):
    """``nsweeps`` RB sweeps with the last colour update also emitting its
    targets' raw residuals from its own gather (callers patch them with
    :func:`_patch_emitted_residual`).  Returns ``(q, {target: raw r})``.

    ``sweep_fn(q, n)`` runs the first ``nsweeps - 1`` sweeps (default: the
    plain path); ``color_update_fn(q, targets, emit) -> (q, info)``
    substitutes the per-colour update (the kernel path); ``extend_fn`` is
    the plain path's halo (default :func:`extend_quads`).  The emitted
    residual is the true A's, so a pack with the low-precision smoother
    operator is refused."""
    assert nsweeps >= 1, "fused relax+residual needs at least one sweep"
    if pack.lp is not None:
        raise ValueError("the fused relax+residual needs the full-precision "
                         "operator; this pack carries pack.lp")
    if sweep_fn is None:
        sweep_fn = lambda q, n: relax_compact_quads(
            q, bq, pack, n, "RB", real_matrix,
            tridiag_method=tridiag_method, extend_fn=extend_fn)
    q = dict(sweep_fn(q0, nsweeps - 1)) if nsweeps > 1 else dict(q0)
    update = color_update_fn or (
        lambda q, targets, emit: plain_color_update(
            q, bq, pack, targets, emit, real_matrix, extend_fn=extend_fn,
            tridiag_method=tridiag_method))
    q, _ = update(q, _RB_TARGETS[0], False)
    q, info = update(q, _RB_TARGETS[1], True)
    return q, info


def relax_residual_compact_quads(q0: Quads, bq: Quads, pack: CompactPack,
                                 nsweeps: int, real_matrix: bool,
                                 extend_fn=None, sweep_fn=None,
                                 color_update_fn=None,
                                 tridiag_method: str = "thomas"):
    """``nsweeps`` RB sweeps plus the fresh post-sweep residual, the last
    colour's residual coming from its own colour update.  Returns
    ``(q, rq)``; equal to :func:`relax_compact_quads` then
    :func:`residual_quads` in exact arithmetic.  The patches read the
    post-sweep extension of ``extend_fn`` (default :func:`extend_quads`):
    they recompute the one halo-reading row and column per quad fresh, so
    they hold under the mirror and under a seam exchange alike."""
    ti = {t: i for i, t in enumerate(_TKEYS)}
    q, info = relax_emit_last_color(q0, bq, pack, nsweeps, real_matrix,
                                    extend_fn=extend_fn, sweep_fn=sweep_fn,
                                    color_update_fn=color_update_fn,
                                    tridiag_method=tridiag_method)
    e2 = (extend_fn or extend_quads)(q)
    rq = {}
    for t in _RB_TARGETS[0]:
        rq[t] = _residual_one(e2, bq[t], pack, ti[t], t, real_matrix)
    for t in _RB_TARGETS[1]:
        rq[t] = _patch_emitted_residual(e2, bq[t], pack, ti[t], t,
                                        real_matrix, info[t])
    return q, rq


def relax_residual_restrict_compact_quads(q0: Quads, bq: Quads,
                                          pack: CompactPack, nsweeps: int,
                                          real_matrix: bool,
                                          extend_fn=None, sweep_fn=None,
                                          color_update_fn=None,
                                          rr_fn=None,
                                          tridiag_method: str = "thomas"):
    """``nsweeps`` RB sweeps plus the coarse RHS restrict(b - A p) — the
    V-cycle down-leg.  Returns ``(q, coarse_b)`` with the full coarse
    array; the summation tree matches transfer.restrict_3d.

    ``rr_fn(e2, targets) -> {target: (nz/2, H, W)}`` computes fresh
    targets' residual z-pair sums (the residual + restriction kernel in
    its z-pair mode); default: from the plain fresh residual."""
    ti = {t: i for i, t in enumerate(_TKEYS)}
    q, info = relax_emit_last_color(q0, bq, pack, nsweeps, real_matrix,
                                    extend_fn=extend_fn, sweep_fn=sweep_fn,
                                    color_update_fn=color_update_fn,
                                    tridiag_method=tridiag_method)
    e2 = (extend_fn or extend_quads)(q)
    if rr_fn is not None:
        zs = dict(rr_fn(e2, _RB_TARGETS[0]))
    else:
        zs = {}
        for t in _RB_TARGETS[0]:
            r = _residual_one(e2, bq[t], pack, ti[t], t, real_matrix)
            zs[t] = r[0::2] + r[1::2]
    for t in _RB_TARGETS[1]:
        zs[t] = _patched_zsum(e2, bq[t], pack, ti[t], t, real_matrix,
                              info[t])
    return q, ((zs[(0, 0)] + zs[(1, 0)]) + (zs[(0, 1)] + zs[(1, 1)]))


def restrict_quads_to_full(rq: Quads) -> torch.Tensor:
    """Coarse = sum of 8 children with the residual given in quads — the
    summation tree of transfer.restrict_3d (z-pairs, then j-pairs, then
    i-pairs)."""
    t1 = {t: rq[t][0::2] + rq[t][1::2] for t in _TKEYS}
    return (t1[(0, 0)] + t1[(1, 0)]) + (t1[(0, 1)] + t1[(1, 1)])
