"""The quad-parity smoother's hand-written CUDA kernels, their plain torch
versions, and the orchestration that runs them.

Port of ``mgroms_tpu/ops/pallas/relax_tiled.py``.  The kernels replace:

  ``color_update``       <- ``color_update_tiled``      (relax_tiled.py:147)
  ``color_update_emit``  <- ``color_update_tiled_emit`` (relax_tiled.py:247)
  ``residual_restrict``  <- ``_rr_one`` on every target (relax_tiled.py:340,
                            via residual_restrict_tiled_quads :426)

K1 and K2 (``csrc/relax_tiled.cu``) take one thread per column of one
target quad and read the gather blocks.  K3 (``csrc/rr_fused.cu``) takes
all four target quads of a level in one launch and reads the operator in
the layout the level holds it: the band stack (``pack.ebands``) or the
gather blocks.  It has three modes: the coarse RHS restrict(b - A p), the
z-pair sums of chosen targets (the fused down-leg's fresh colour), and the
residual quads themselves (``residual_quads``, the level-0 residual of the
K4 levels, whose JAX counterpart is relax_compact.residual_quads:615, XLA
glue there).

Each wrapper runs its plain version (written with ops/relax_compact.py)
for tensors on the CPU only; for a CUDA tensor it checks device, dtype,
shape and contiguity, launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches per wrapper (``color_update_bf16``: K1 on the
low-precision smoother operator, bfloat16 blocks beside float32 state;
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
from ._build import check_launch, check_tensors, on_cpu, ptr
from ..relax_compact import (_BASE_TERMS, _REAL_TERMS, _TKEYS, NBANDS,
                             CompactPack, _residual_one, band_layout,
                             check_band_stack, colour_targets, extend_quads,
                             gather_blocks, gather_keys, key_views,
                             merge_quads, relax_residual_compact_quads,
                             relax_residual_restrict_compact_quads,
                             residual_from_gather, smoother_operator,
                             split_quads)

LAUNCHES = {"color_update": 0, "color_update_bf16": 0,
            "color_update_emit": 0, "residual_restrict": 0,
            "residual_quads": 0}

# K3's modes (csrc/rr_fused.cu): the coarse RHS of all four targets, the
# z-pair sums of chosen targets, the residual of chosen targets
RR_MODES = {"coarse": 0, "zsum": 1, "residual": 2}

_NKEYS = len(gather_keys(False))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gather_quads(target) -> tuple:
    """The 3 quads a colour update's gather reads, in kernel argument
    order: the y-sibling, the x-sibling and the diagonal sibling (every
    off-column coupling flips at least one parity)."""
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

def color_update_plain(e3, bq, blocks_w, ud, bet, target, real_matrix,
                       rb=None):
    """One RB colour update of target quad ``target``: gather from the 3
    sibling extended quads ``e3`` (:func:`gather_quads` order), then the
    factored Thomas solve with gam recomputed.  Blocks in bfloat16 are
    upcast to the state type at read."""
    e = dict(zip(gather_quads(target), e3))
    g = gather_blocks(e, tuple(v.to(bq.dtype) for v in key_views(blocks_w,
                                                                 rb)),
                      target[0], target[1], real_matrix)
    return thomas_factored_unrolled(bet, None, ud, bq - g)


def color_update_emit_plain(e3, bq, blocks_w, ud, bet, d, target,
                            real_matrix, rb=None):
    """:func:`color_update_plain` plus the raw residual
    bq - d x - lo x_- - hi x_+ - g from the same gather."""
    e = dict(zip(gather_quads(target), e3))
    g = gather_blocks(e, key_views(blocks_w, rb), target[0], target[1],
                      real_matrix)
    sol = thomas_factored_unrolled(bet, None, ud, bq - g)
    return sol, residual_from_gather(bq, sol, d, ud, g)


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


def _geometry(bq, real_matrix, rb):
    nz, H, W = bq.shape
    if nz < 2:
        raise ValueError("the kernels need nz >= 2")
    if real_matrix != (rb is not None):
        raise ValueError("rb is required exactly when real_matrix")
    return nz, H, W


def _launch_color_update(e3, bq, blocks_w, ud, bet, d, target, real_matrix,
                         rb, emit):
    nz, H, W = _geometry(bq, real_matrix, rb)
    sh = _shapes(nz, H, W, real_matrix)
    named = {"bq": bq, "blocks": blocks_w, "ud": ud, "bet": bet}
    named.update({f"e{i}": x for i, x in enumerate(e3)})
    sh.update({f"e{i}": sh["e"] for i in range(3)})
    if emit:
        named["d"] = d
    if real_matrix:
        named["rb"] = rb
    # the emitted residual needs the true operator: blocks of the state type
    band = bq.dtype if emit else blocks_w.dtype
    check_tensors(named, sh, bq.dtype, bq.device,
                  {"blocks": band, "rb": band})
    out = torch.empty_like(bq)
    res = torch.empty_like(bq) if emit else None
    lib = _build.load()
    fn = {torch.bfloat16: lib.mg_color_update_bf16,
          torch.float64: lib.mg_color_update_f64}.get(band,
                                                      lib.mg_color_update_f32)
    tt = _terms(target, gather_quads(target))
    with torch.cuda.device(bq.device):
        rc = fn(*(ptr(x) for x in e3), ptr(blocks_w), ptr(rb), ptr(ud),
                ptr(bet), ptr(bq), ptr(d if emit else None), ptr(out),
                ptr(res), nz, H, W, int(real_matrix), int(emit),
                ctypes.addressof(tt), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "color_update")
    return out, res


def color_update(e3, bq, blocks_w, ud, bet, target, real_matrix, rb=None):
    """Colour update of one target quad (K1).  ``e3``: the 3 extended
    sibling quads (nz, H+2, W+2) in :func:`gather_quads` order; ``bq`` the
    target's RHS (nz, H, W); ``blocks_w`` (nz, H, 12W), ``ud``
    (nz-1, H, W), ``bet`` (nz, H, W), ``rb`` (1, H, 2W) the target's
    smoother operator fields (the blocks and ``rb`` in the state type, or
    in bfloat16 with float32 state and the pack's ``lp.bet``).  Returns
    the new quad."""
    if on_cpu(bq):
        return color_update_plain(e3, bq, blocks_w, ud, bet, target,
                                  real_matrix, rb)
    out, _ = _launch_color_update(e3, bq, blocks_w, ud, bet, None, target,
                                  real_matrix, rb, emit=False)
    LAUNCHES["color_update_bf16" if blocks_w.dtype == torch.bfloat16
             else "color_update"] += 1
    return out


def color_update_emit(e3, bq, blocks_w, ud, bet, d, target, real_matrix,
                      rb=None):
    """:func:`color_update` that also returns the raw residual of the
    updated target from its own gather (K2): ``(new quad, residual)``."""
    if on_cpu(bq):
        return color_update_emit_plain(e3, bq, blocks_w, ud, bet, d, target,
                                       real_matrix, rb)
    out, res = _launch_color_update(e3, bq, blocks_w, ud, bet, d, target,
                                    real_matrix, rb, emit=True)
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

def _rb(pack: CompactPack, m: int):
    return pack.rblocks[m] if pack.real_matrix else None


def relax_compact_tiled_quads(q0, bq, pack: CompactPack, nsweeps: int,
                              kind: str = "RB", extend_fn=None):
    """``nsweeps`` RB or FC sweeps, one :func:`color_update` per (colour,
    target quad) (relax_compact.colour_targets: RB two colours of two
    targets, FC four colours of one), with the smoother operator
    (relax_compact.smoother_operator: ``pack.lp``'s blocks and pivots when
    present); the quad halo extension before each colour (``extend_fn``,
    default extend_quads; the seam exchange on a tile of a distributed
    level) stays plain torch, and the targets of a colour read the same
    pre-colour extension."""
    ti = {t: i for i, t in enumerate(_TKEYS)}
    blocks, rblocks, bet, _ = smoother_operator(pack, q0[(0, 0)].dtype)
    extend = extend_fn or extend_quads
    q = dict(q0)
    for _ in range(nsweeps):
        for targets in colour_targets(kind):
            e = extend(q)
            for t in targets:
                m = ti[t]
                q[t] = color_update(tuple(e[k] for k in gather_quads(t)),
                                    bq[t], blocks[m], pack.ud[m], bet[m], t,
                                    pack.real_matrix,
                                    rblocks[m] if pack.real_matrix else None)
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
    ti = {t: i for i, t in enumerate(_TKEYS)}
    real = pack.real_matrix
    extend = extend_fn or extend_quads

    def sweep_fn(q, n):
        return relax_compact_tiled_quads(q, bq, pack, n, extend_fn=extend_fn)

    def color_update_fn(q, targets, emit):
        e = extend(q)
        q = dict(q)
        info = {}
        for t in targets:
            m = ti[t]
            e3 = tuple(e[k] for k in gather_quads(t))
            if emit:
                q[t], info[t] = color_update_emit(
                    e3, bq[t], pack.blocks[m], pack.ud[m], pack.bet[m],
                    pack.d[m], t, real, _rb(pack, m))
            else:
                q[t] = color_update(e3, bq[t], pack.blocks[m], pack.ud[m],
                                    pack.bet[m], t, real, _rb(pack, m))
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
