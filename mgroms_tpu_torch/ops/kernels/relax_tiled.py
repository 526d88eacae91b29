"""The quad-parity smoother's hand-written CUDA kernels, their plain torch
versions, and the orchestration that runs them.

Port of ``mgroms_tpu/ops/pallas/relax_tiled.py``.  The kernels replace:

  ``color_update``       <- ``color_update_tiled``      (relax_tiled.py:147)
  ``color_update_emit``  <- ``color_update_tiled_emit`` (relax_tiled.py:247)
  ``residual_restrict``  <- ``_rr_one`` on every target (relax_tiled.py:340,
                            via residual_restrict_tiled_quads :426)

K1 and K2 (``csrc/relax_tiled.cu``) update every target quad of one
colour in one launch (both of an RB colour, one of an FC colour; K2, the
emitting form, the RB colours), one thread per (J, I) column.  K3
(``csrc/rr_fused.cu``) takes all four target quads of a level in one
launch.  Each reads the operator in the layout the level holds it: the
band stack (``pack.ebands``, or ``pack.lp.ebands`` for K1 in perf mode) or
the gather blocks.  K3 has three modes: the coarse RHS restrict(b - A p), the
z-pair sums of chosen targets (the fused down-leg's fresh colour), and the
residual quads themselves (``residual_quads``, the level-0 residual of the
K4 levels, whose JAX counterpart is relax_compact.residual_quads:615, XLA
glue there).

Each wrapper runs its plain version (written with ops/relax_compact.py)
for tensors on the CPU only; for a CUDA tensor it checks device, dtype,
shape and contiguity, launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches per wrapper (``color_update_bf16``: K1 on the
low-precision smoother operator, bfloat16 values beside float32 state;
``residual_restrict``: K3 in its coarse-RHS and z-pair modes,
``residual_quads``: K3 in its residual mode).  The TPU kernels' row tiles,
VMEM budgets and Element windows have no counterpart here: the kernels
take any ``nz >= 2`` and any H, W.
"""

from __future__ import annotations

import ctypes

import torch

from ..relax import thomas_factored_unrolled
from . import _build
from ._build import check_launch, check_tensors, instance, on_cpu, ptr
from ..relax_compact import (_BASE_TERMS, _REAL_TERMS, _TKEYS, NBANDS,
                             CompactPack, _residual_one, band_layout,
                             block_views, check_band_stack, colour_targets,
                             extend_quads, gather_blocks, gather_keys,
                             merge_quads, relax_residual_compact_quads,
                             relax_residual_restrict_compact_quads,
                             residual_from_gather, smoother_operator,
                             split_quads)

LAUNCHES = {"color_update": 0, "color_update_bf16": 0,
            "color_update_emit": 0, "residual_restrict": 0,
            "residual_quads": 0}

# (state dtype, operator dtype) -> K1-K2's C entry (csrc/relax_tiled.cu's
# instances; K2 reads the true operator, in the state's type).  No
# (float64, bfloat16) instance: the JAX package never smooths a float64
# state with K1 on bfloat16 blocks
COLOUR_ENTRIES = {
    (torch.float32, torch.float32): "mg_colour_update_f32",
    (torch.float64, torch.float64): "mg_colour_update_f64",
    (torch.float32, torch.bfloat16): "mg_colour_update_bf16",
}

# K3's modes (csrc/rr_fused.cu): the coarse RHS of all four targets, the
# z-pair sums of chosen targets, the residual of chosen targets
RR_MODES = {"coarse": 0, "zsum": 1, "residual": 2}

# the kernel functions behind each count (ops/kernels/__init__.py):
# colour_kernel<T, B, BANDS, EMIT, ...>, rr_kernel<T, BANDS, MODE>
GRAPH_NAMES = (
    (r"\bcolour_kernel<\w+, \w+, \w+, true,", "color_update_emit"),
    (r"\bcolour_kernel<\w+, __nv_bfloat16,", "color_update_bf16"),
    (r"\bcolour_kernel<", "color_update"),
    (rf"\brr_kernel<\w+, \w+, {RR_MODES['residual']}>", "residual_quads"),
    (r"\brr_kernel<", "residual_restrict"),
)

_NKEYS = len(gather_keys(False))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gather_quads(target) -> tuple:
    """The 3 quads a target's gather reads, in the order K10's
    ``dma_only`` takes them (ops/kernels/roofline.py): the y-sibling, the
    x-sibling and the diagonal sibling (every off-column coupling flips at
    least one parity)."""
    a, b = target
    return ((1 - a, b), (a, 1 - b), (1 - a, 1 - b))


class _Terms(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int * 16)
                for name in ("src", "dk", "oj", "oi", "blk")]


def term_table(target, quad_keys) -> list:
    """Per gather term (the 12 of ``_BASE_TERMS``, then the 4 of
    ``_REAL_TERMS``): ``(src, dk, oj, oi, blk)`` — the state value is
    extended quad ``quad_keys[src]`` at z-offset ``dk``, extended row
    J + ``oj`` and column I + ``oi`` (the index algebra of
    relax_compact._qread); the operator value is block ``blk`` of
    ``gather_keys(True)`` order (12 and 13: the plane-0 'real' pair)."""
    a, b = target
    keys = gather_keys(True)
    rows = []
    for n, boff, (pk, pj, pi) in _BASE_TERMS + _REAL_TERMS:
        a2, b2 = (a + pj) % 2, (b + pi) % 2
        rows.append((quad_keys.index((a2, b2)), pk,
                     1 + (a + pj - a2) // 2, 1 + (b + pi - b2) // 2,
                     keys.index((n, boff))))
    return rows


def _terms(target, quad_keys) -> _Terms:
    cols = list(zip(*term_table(target, quad_keys)))
    return _Terms(*((ctypes.c_int * 16)(*c) for c in cols))


# --------------------------------------------------------------- plain

def colour_partner(target) -> tuple:
    """The other target quad of ``target``'s RB colour (the diagonal
    sibling, relax_compact.colour_targets)."""
    return (1 - target[0], 1 - target[1])


def _check_colour(targets) -> tuple:
    """``targets`` as a colour: one target quad, or an RB pair in
    ``_TKEYS`` order (the kernel's first target is (0,0) or (0,1))."""
    targets = tuple(sorted(targets))
    if not targets or len(targets) > 2 or any(t not in _TKEYS
                                              for t in targets) \
            or (len(targets) == 2 and targets[1] != colour_partner(
                targets[0])):
        raise ValueError(f"a colour is one target quad or an RB pair, got "
                         f"{targets}")
    return targets


def color_update_plain(e, bq, pack: CompactPack, targets) -> dict:
    """One colour update of ``targets`` (one target quad, or the two of an
    RB colour): per target, the gather from the extended quads ``e``
    (``_TKEYS``-keyed, all four) with the smoother operator
    (relax_compact.smoother_operator, in the layout the pack holds it;
    bfloat16 values upcast at read), then the factored Thomas solve with
    gam recomputed.  Returns ``{target: new quad}``."""
    dt = e[targets[0]].dtype
    _, _, bet, _ = smoother_operator(pack, dt)
    lp = pack.lp is not None
    out = {}
    for t in _check_colour(targets):
        m = _TKEYS.index(t)
        g = gather_blocks(e, tuple(v.to(dt) for v in block_views(pack, m,
                                                                  lp=lp)),
                          t[0], t[1], pack.real_matrix)
        out[t] = thomas_factored_unrolled(bet[m], None, pack.ud[m],
                                          bq[t] - g)
    return out


def color_update_emit_plain(e, bq, pack: CompactPack, targets) -> tuple:
    """:func:`color_update_plain` with the true operator (the pack's own,
    never ``pack.lp``), plus each target's raw residual
    bq - d x - lo x_- - hi x_+ - g from the same gather:
    ``({target: new quad}, {target: residual})``."""
    sol, res = {}, {}
    for t in _check_colour(targets):
        m = _TKEYS.index(t)
        g = gather_blocks(e, block_views(pack, m), t[0], t[1],
                          pack.real_matrix)
        sol[t] = thomas_factored_unrolled(pack.bet[m], None, pack.ud[m],
                                          bq[t] - g)
        res[t] = residual_from_gather(bq[t], sol[t], pack.d[m], pack.ud[m],
                                      g)
    return sol, res


def residual_restrict_plain(e4, bq, pack: CompactPack, mode="coarse",
                            targets=_TKEYS):
    """The fresh residual of ``targets`` from the 4 extended quads ``e4``
    (``_TKEYS`` order) with the pack's true operator in its own layout
    (relax_compact.block_views), as ``mode`` gives it: ``"residual"``
    {target: (nz, H, W)}; ``"zsum"`` {target: its z-pair sums (nz/2, H,
    W)}; ``"coarse"`` the four targets' z-pair sums added in the order of
    transfer.restrict_3d, (zs00 + zs10) + (zs01 + zs11): the coarse RHS."""
    e = dict(zip(_TKEYS, e4))
    r = {t: _residual_one(e, bq[t], pack, _TKEYS.index(t), t,
                          pack.real_matrix) for t in targets}
    if mode == "residual":
        return r
    zs = {t: x[0::2] + x[1::2] for t, x in r.items()}
    if mode == "zsum":
        return zs
    return (zs[(0, 0)] + zs[(1, 0)]) + (zs[(0, 1)] + zs[(1, 1)])


# ------------------------------------------------------------- wrappers

def _shapes(nz, H, W, real_matrix) -> dict:
    s = {"e": (nz, H + 2, W + 2), "bq": (nz, H, W), "d": (nz, H, W),
         "bet": (nz, H, W), "ud": (nz - 1, H, W),
         "blocks": (nz, H, _NKEYS * W)}
    if real_matrix:
        s["rb"] = (1, H, 2 * W)
    return s


class _ColourArgs(ctypes.Structure):
    _fields_ = [("e", ctypes.c_void_p * 4)] + [
        (f, ctypes.c_void_p * 2) for f in ("bq", "ud", "bet", "d", "out",
                                           "res", "blocks", "rb")] \
        + [("band", ctypes.c_void_p)]


def colour_operator(pack: CompactPack, dt, emit: bool = False):
    """``(layout, holder, bet, value dtype)`` of the operator a colour
    update of state of type ``dt`` reads: the smoother operator for K1
    (relax_compact.smoother_operator: ``pack.lp`` when present), the true
    operator for K2; ``layout`` is ``"bands"`` where its holder has the
    band stack, else ``"blocks"``."""
    if emit:
        holder, bet, band = pack, pack.bet, dt
    else:
        _, _, bet, band = smoother_operator(pack, dt)
        holder = pack.lp if pack.lp is not None else pack
    return ("bands" if holder.ebands is not None else "blocks", holder, bet,
            band)


def _launch_colour(e, bq, pack: CompactPack, targets, emit: bool):
    targets = _check_colour(targets)
    q0 = bq[targets[0]]
    nz, H, W = q0.shape
    if nz < 2:
        raise ValueError("the kernels need nz >= 2")
    if nz * (H + 2) * (W + 2) >= 2 ** 32:
        raise ValueError("a quad of 2**32 values or more")
    layout, holder, bet, band = colour_operator(pack, q0.dtype, emit)
    name = instance(COLOUR_ENTRIES, q0.dtype, band, "K1")
    real = pack.real_matrix
    ms = [_TKEYS.index(t) for t in targets]
    named, shapes = {}, {}
    for t in _TKEYS:
        named[f"e{t}"], shapes[f"e{t}"] = e[t], (nz, H + 2, W + 2)
    fields = {"bq": lambda m, t: bq[t], "ud": lambda m, t: pack.ud[m],
              "bet": lambda m, t: bet[m]}
    if emit:
        fields["d"] = lambda m, t: pack.d[m]
    for m, t in zip(ms, targets):
        for f, get in fields.items():
            named[f"{f}{t}"] = get(m, t)
            shapes[f"{f}{t}"] = (nz - 1 if f == "ud" else nz, H, W)
    dtypes = {}
    bandp = None
    if layout == "bands":
        check_band_stack(holder.ebands, (NBANDS, nz + 2, H + 2, W + 2),
                         band, q0.device)
        lpad, _ = band_layout(W, holder.ebands.element_size())
        bandp = (holder.ebands.data_ptr()
                 - lpad * holder.ebands.element_size())
    else:
        if real and holder.rblocks is None:
            raise ValueError("the pack holds neither the band stack nor "
                             "its 'real' pairs")
        for m, t in zip(ms, targets):
            named[f"blocks{t}"] = holder.blocks[m]
            shapes[f"blocks{t}"] = (nz, H, _NKEYS * W)
            dtypes[f"blocks{t}"] = band
            if real:
                named[f"rb{t}"] = holder.rblocks[m]
                shapes[f"rb{t}"] = (1, H, 2 * W)
                dtypes[f"rb{t}"] = band
    check_tensors(named, shapes, q0.dtype, q0.device, dtypes)
    out = {t: torch.empty_like(q0) for t in targets}
    res = {t: torch.empty_like(q0) for t in targets} if emit else {}
    two = lambda xs: (ctypes.c_void_p * 2)(*(ptr(x) for x in xs),
                                           *([None] * (2 - len(xs))))
    per = lambda f: two([named[f"{f}{t}"] for t in targets])
    args = _ColourArgs(
        (ctypes.c_void_p * 4)(*(ptr(e[t]) for t in _TKEYS)), per("bq"),
        per("ud"), per("bet"), per("d") if emit else two([]),
        two([out[t] for t in targets]), two([res.get(t) for t in targets]),
        two([holder.blocks[m] for m in ms]) if layout == "blocks"
        else two([]),
        two([holder.rblocks[m] for m in ms])
        if layout == "blocks" and real else two([]), bandp)
    fn = getattr(_build.load(), name)
    with torch.cuda.device(q0.device):
        rc = fn(ctypes.byref(args), nz, H, W, int(real), ms[0],
                len(targets), int(emit), int(layout == "bands"),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "color_update_emit" if emit else "color_update")
    return out, res, band


def color_update(e, bq, pack: CompactPack, targets) -> dict:
    """K1: one colour update of ``targets`` (one target quad, or the two of
    an RB colour, in one launch) from the four extended quads ``e``
    ((nz, H+2, W+2), ``_TKEYS``-keyed) and the RHS quads ``bq``, with the
    pack's smoother operator (:func:`colour_operator`: the band stack or
    the gather blocks, in the state type or, with float32 state and the
    pack's ``lp``, in bfloat16).  Returns ``{target: new quad}``."""
    if on_cpu(bq[targets[0]]):
        return color_update_plain(e, bq, pack, targets)
    out, _, band = _launch_colour(e, bq, pack, targets, emit=False)
    LAUNCHES["color_update_bf16" if band == torch.bfloat16
             else "color_update"] += 1
    return out


def color_update_emit(e, bq, pack: CompactPack, targets) -> tuple:
    """K2: :func:`color_update` of an RB colour with the pack's true
    operator that also returns each target's raw residual from its own
    gather: ``({target: new quad}, {target: residual})``."""
    if on_cpu(bq[targets[0]]):
        return color_update_emit_plain(e, bq, pack, targets)
    if len(tuple(targets)) != 2:
        raise ValueError("K2 updates the two targets of an RB colour")
    out, res, _ = _launch_colour(e, bq, pack, targets, emit=True)
    LAUNCHES["color_update_emit"] += 1
    return out, res


class _RRArgs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p * 4)
                for f in ("e", "bq", "d", "ud", "out", "blocks", "rb")] \
        + [("band", ctypes.c_void_p)]


def rr_operator(pack: CompactPack) -> str:
    """The layout K3 reads a level's true operator in: ``"bands"`` where
    the pack holds the band stack, else ``"blocks"``."""
    return "bands" if pack.ebands is not None else "blocks"


def residual_restrict(e4, bq, pack: CompactPack, mode="coarse",
                      targets=_TKEYS):
    """K3: the fresh residual of ``targets`` (all four for ``"coarse"``)
    of a quad-parity level in one launch, from its 4 extended quads ``e4``
    ((nz, H+2, W+2) each, ``_TKEYS`` order) and RHS quads ``bq``
    (``_TKEYS``-keyed), the operator read as :func:`rr_operator` says;
    returns what :func:`residual_restrict_plain` returns."""
    if on_cpu(e4[0]):
        return residual_restrict_plain(e4, bq, pack, mode, targets)
    targets = tuple(targets)
    if mode == "coarse" and sorted(targets) != sorted(_TKEYS):
        raise ValueError("the coarse RHS needs all four targets")
    q0 = bq[(0, 0)]
    nz, H, W = q0.shape
    if nz < 2 or (mode != "residual" and nz % 2):
        raise ValueError(f"K3 mode {mode!r} needs nz >= 2"
                         + ("" if mode == "residual" else ", even"))
    real = pack.real_matrix
    named, shapes = {}, {}
    for m, t in enumerate(_TKEYS):
        for f, (x, shape) in {"e": (e4[m], (nz, H + 2, W + 2)),
                              "bq": (bq[t], (nz, H, W)),
                              "d": (pack.d[m], (nz, H, W)),
                              "ud": (pack.ud[m], (nz - 1, H, W))}.items():
            named[f"{f}{t}"], shapes[f"{f}{t}"] = x, shape
    layout = rr_operator(pack)
    band = None
    if layout == "bands":
        check_band_stack(pack.ebands, (NBANDS, nz + 2, H + 2, W + 2),
                         q0.dtype, q0.device)
        lpad, _ = band_layout(W, pack.ebands.element_size())
        band = pack.ebands.data_ptr() - lpad * pack.ebands.element_size()
    else:
        if pack.blocks is None or (real and pack.rblocks is None):
            raise ValueError("the pack holds neither the band stack nor "
                             "its gather blocks" + (" and 'real' pairs"
                                                    if real else ""))
        for m, t in enumerate(_TKEYS):
            named[f"blocks{t}"] = pack.blocks[m]
            shapes[f"blocks{t}"] = (nz, H, _NKEYS * W)
            if real:
                named[f"rb{t}"] = pack.rblocks[m]
                shapes[f"rb{t}"] = (1, H, 2 * W)
    check_tensors(named, shapes, q0.dtype, q0.device)
    if mode == "coarse":
        out = q0.new_empty((nz // 2, H, W))
        outs = [out, None, None, None]
    else:
        shape = (nz // 2, H, W) if mode == "zsum" else (nz, H, W)
        out = {t: q0.new_empty(shape) for t in targets}
        outs = [out.get(t) for t in _TKEYS]
    arr = lambda xs: (ctypes.c_void_p * 4)(*(ptr(x) for x in xs))
    blocks = pack.blocks if layout == "blocks" else (None,) * 4
    rbs = pack.rblocks if layout == "blocks" and real else (None,) * 4
    args = _RRArgs(arr(e4), arr([bq[t] for t in _TKEYS]), arr(pack.d),
                   arr(pack.ud), arr(outs), arr(blocks), arr(rbs), band)
    mask = sum(1 << _TKEYS.index(t) for t in targets)
    lib = _build.load()
    fn = lib.mg_rr_f32 if q0.dtype == torch.float32 else lib.mg_rr_f64
    with torch.cuda.device(q0.device):
        rc = fn(ctypes.byref(args), nz, H, W, int(real), mask,
                RR_MODES[mode], int(layout == "bands"),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "residual_restrict")
    LAUNCHES["residual_quads" if mode == "residual"
             else "residual_restrict"] += 1
    return out


# --------------------------------------------------------- orchestration

def relax_compact_tiled_quads(q0, bq, pack: CompactPack, nsweeps: int,
                              kind: str = "RB", extend_fn=None):
    """``nsweeps`` RB or FC sweeps, one :func:`color_update` launch per
    colour (relax_compact.colour_targets: RB two colours of two targets,
    FC four colours of one), with the smoother operator
    (relax_compact.smoother_operator: ``pack.lp``'s operator and pivots
    when present); the quad halo extension before each colour
    (``extend_fn``, default extend_quads; the seam exchange on a tile of a
    distributed level) stays plain torch."""
    extend = extend_fn or extend_quads
    q = dict(q0)
    for _ in range(nsweeps):
        for targets in colour_targets(kind):
            q.update(color_update(extend(q), bq, pack, targets))
    return q


def relax_compact_tiled(p, b, pack: CompactPack, nsweeps: int,
                        kind: str = "RB", extend_fn=None):
    """:func:`relax_compact_tiled_quads` on a full-layout state (even ny,
    nx): split, sweep, merge."""
    return merge_quads(relax_compact_tiled_quads(
        split_quads(p), split_quads(b), pack, nsweeps, kind,
        extend_fn=extend_fn))


def _tiled_fused_parts(bq, pack: CompactPack, extend_fn=None):
    """The kernel ``sweep_fn`` / ``color_update_fn`` / ``rr_fn`` plugged
    into the relax_compact fused-residual orchestrators."""
    extend = extend_fn or extend_quads

    def sweep_fn(q, n):
        return relax_compact_tiled_quads(q, bq, pack, n, extend_fn=extend_fn)

    def color_update_fn(q, targets, emit):
        e = extend(q)
        q = dict(q)
        info = {}
        if emit:
            new, info = color_update_emit(e, bq, pack, targets)
        else:
            new = color_update(e, bq, pack, targets)
        q.update(new)
        return q, info

    def rr_fn(e2, targets):
        return residual_restrict(tuple(e2[k] for k in _TKEYS), bq, pack,
                                 "zsum", targets)

    return sweep_fn, color_update_fn, rr_fn


def relax_residual_tiled_quads(q0, bq, pack: CompactPack, nsweeps: int,
                               extend_fn=None):
    """``nsweeps`` RB sweeps + the fresh residual: the last colour's
    residual from :func:`color_update_emit`, the first colour's fresh
    (plain).  Returns ``(q, rq)``."""
    sweep_fn, color_update_fn, _ = _tiled_fused_parts(bq, pack, extend_fn)
    return relax_residual_compact_quads(
        q0, bq, pack, nsweeps, pack.real_matrix, extend_fn=extend_fn,
        sweep_fn=sweep_fn, color_update_fn=color_update_fn)


def relax_residual_restrict_tiled_quads(q0, bq, pack: CompactPack,
                                        nsweeps: int, extend_fn=None):
    """The V-cycle down-leg: ``nsweeps`` RB sweeps + restrict(b - A p), the
    last colour's residual from :func:`color_update_emit`, the first
    colour's z-pair sums from one :func:`residual_restrict` launch.
    Returns ``(q, coarse_b)``."""
    sweep_fn, color_update_fn, rr_fn = _tiled_fused_parts(bq, pack,
                                                          extend_fn)
    return relax_residual_restrict_compact_quads(
        q0, bq, pack, nsweeps, pack.real_matrix, extend_fn=extend_fn,
        sweep_fn=sweep_fn, color_update_fn=color_update_fn, rr_fn=rr_fn)


def residual_restrict_tiled_quads(q, bq, pack: CompactPack,
                                  extend_fn=None) -> torch.Tensor:
    """Coarse b = restrict(b - A p) by one :func:`residual_restrict`
    launch on all four targets (the fine residual is never materialized);
    the four z-pair sums at (J, I) are the 8 children of coarse cell
    (K, J, I)."""
    e = (extend_fn or extend_quads)(q)
    return residual_restrict(tuple(e[k] for k in _TKEYS), bq, pack)


def residual_tiled_quads(q, bq, pack: CompactPack, extend_fn=None) -> dict:
    """r = b - A p in quad layout (relax_compact.residual_quads) by one
    :func:`residual_restrict` launch in its residual mode."""
    e = (extend_fn or extend_quads)(q)
    return residual_restrict(tuple(e[k] for k in _TKEYS), bq, pack,
                             "residual")
