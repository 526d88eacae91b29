"""Roofline probes of the level-0 smoother (K10): their hand-written CUDA
kernels and plain torch versions.

Port of the two Pallas probes of ``scripts/micro_roofline.py``
(``csrc/roofline.cu``):

  ``dma_only``  <- ``dma_only`` (micro_roofline.py:123, pallas_call :135)
  ``fma_run``   <- ``fma_run``  (micro_roofline.py:266, pallas_call :267)

``dma_only`` loads what K1 (relax_tiled.color_update) loads on one target
quad's gather blocks, in the pattern and grid of the JAX script's K1, and
only adds it up (its windows and all forms stage the three extended
quads' windows plane by plane through a ring in shared memory, as the JAX
probe DMAs each window into VMEM once and K1 stages its siblings);
``dma_only_bands`` does the same for K1 as the card's solver launches it,
on an RB colour's band stack (counted as ``dma_only``); ``fma_run``
measures the card's float32 FMA rate.  ``step_floor`` (no
JAX counterpart) is the floor of K6's one-launch forms: their serial
colour steps, each a barrier and an nz-deep chain, in one block or a
thread block cluster.  Each wrapper runs its plain version for CPU
tensors only; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr
from .relax_tiled import _check_colour, _shapes, _terms, gather_quads
from ..relax_compact import (_BASE_TERMS, _REAL_TERMS, _TKEYS, NBANDS,
                             _qread, band_index, band_layout, block_views,
                             check_band_stack, gather_keys,
                             smoother_operator)

LAUNCHES = {"dma_only": 0, "fma_run": 0, "step_floor": 0}

WHICH = ("all", "windows", "blocks")
# the windows and all forms' block tile (rows, columns: K1's grid, a thread
# a column) and the depth of their ring of planes in shared memory (planes
# k-1, k, k+1 and the rest in flight), as csrc/roofline.cu compiles them
# (kWJ, kWI, kWSlots)
WINDOW_TILE = (8, 32)
WINDOW_RING = 8
# the target quad whose loads the probe makes: K1 is timed on it
# (micro_roofline.py:78-79)
TARGET = (0, 0)
FMA_CHAINS, FMA_REPS = 8, 64          # micro_roofline.py:248
FMA_BLOCK, FMA_TILES = (8, 8, 512), 256   # :249, :262
# the float32 tolerance of fma_run against its float64 plain version:
# 64 chained roundings of |x| ~ 65 |x0| (half an ulp each) and the
# 8-chain sum, ~4.3e-6 relative at most
FMA_RTOL = 1e-5


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fma_flops() -> float:
    """The flops of one ``fma_run`` on an :data:`FMA_BLOCK` block; FMA = 2
    flops (micro_roofline.py:283)."""
    return 2.0 * FMA_CHAINS * FMA_REPS * FMA_TILES * math.prod(FMA_BLOCK)


def dma_only_bytes(nz, H, W, which, real=True, lp=False) -> int:
    """The bytes ``dma_only`` must move without ``gam`` (f32 state, the
    blocks in bfloat16 with ``lp``): each array it loads read once, the
    output written once."""
    sh = _shapes(nz, H, W, real)
    n = lambda s: 4 * int(torch.Size(s).numel())
    win = 3 * n(sh["e"])
    blk = (n(sh["blocks"]) + (n(sh["rb"]) if real else 0)) // (2 if lp else 1)
    piv = n(sh["ud"]) + n(sh["bet"])
    base = 2 * n(sh["bq"])
    return base + {"all": win + blk + piv, "windows": win,
                   "blocks": blk}[which]


def dma_only_plain(e3, bq, blocks_w, ud, bet, gam, which, rb=None):
    """Per plane, in this order (blocks upcast to the state type): the
    RHS, the 12 state values of K1's gather of :data:`TARGET`
    (``_BASE_TERMS``), on plane 0 the 4 'real' ones; the 12 blocks,
    on plane 0 the 'real' pair; ud at k-1, bet, gam at k (when given)
    -- each added in turn (``windows``: state only, ``blocks``: blocks
    only, both with the RHS)."""
    a, b = TARGET
    e = dict(zip(gather_quads(TARGET), e3))
    W = bq.shape[2]
    acc = bq.clone()
    if which != "blocks":
        for _, _, (pk, pj, pi) in _BASE_TERMS:
            acc = acc + _qread(e, a, b, pj, pi, pk)
        if rb is not None:
            x = acc[:1]
            for _, _, (pk, pj, pi) in _REAL_TERMS:
                x = x + _qread(e, a, b, pj, pi, pk)[:1]
            acc = torch.cat([x, acc[1:]])
    if which != "windows":
        blocks_w = blocks_w.to(acc.dtype)
        for m in range(12):
            acc = acc + blocks_w[:, :, m * W: (m + 1) * W]
        if rb is not None:
            rb = rb.to(acc.dtype)
            x = acc[:1] + rb[:, :, :W]
            acc = torch.cat([x + rb[:, :, W:], acc[1:]])
    if which == "all":
        acc = torch.cat([acc[:1], acc[1:] + ud])
        acc = acc + bet
        if gam is not None:
            acc = torch.cat([acc[:-1] + gam, acc[-1:]])
    return acc


def dma_only(e3, bq, blocks_w, ud, bet, gam, which, rb=None):
    """K10 ``dma_only`` on K1's float32 operands (:func:`dma_only_plain`),
    the blocks and ``rb`` in float32 or bfloat16 (upcast at load);
    ``gam`` (nz-1, H, W) and ``rb`` may be None; ``which`` in
    :data:`WHICH`."""
    if which not in WHICH:
        raise ValueError(f"which must be one of {WHICH}, got {which!r}")
    if on_cpu(bq):
        return dma_only_plain(e3, bq, blocks_w, ud, bet, gam, which, rb)
    nz, H, W = bq.shape
    sh = _shapes(nz, H, W, rb is not None)
    named = {"bq": bq, "blocks": blocks_w, "ud": ud, "bet": bet}
    named.update({f"e{i}": x for i, x in enumerate(e3)})
    sh.update({f"e{i}": sh["e"] for i in range(3)}, gam=sh["ud"])
    if rb is not None:
        named["rb"] = rb
    if gam is not None:
        named["gam"] = gam
    if bq.dtype != torch.float32:
        raise ValueError(f"dma_only takes float32, got {bq.dtype}")
    band = blocks_w.dtype
    check_tensors(named, sh, bq.dtype, bq.device,
                  {"blocks": band, "rb": band})
    out = torch.empty_like(bq)
    tt = _terms(TARGET, gather_quads(TARGET))
    lib = _build.load()
    fn = lib.mg_dma_only_bf16 if band == torch.bfloat16 else lib.mg_dma_only
    with torch.cuda.device(bq.device):
        rc = fn(*(ptr(x) for x in e3), ptr(blocks_w), ptr(rb),
                             ptr(ud), ptr(bet), ptr(gam), ptr(bq), ptr(out),
                             nz, H, W, WHICH.index(which),
                             ctypes.addressof(tt),
                             torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "dma_only")
    LAUNCHES["dma_only"] += 1
    return out


def _rb_colour(targets) -> tuple:
    targets = _check_colour(targets)
    if len(targets) != 2:
        raise ValueError(f"dma_only_bands takes an RB colour, got {targets}")
    return targets


def dma_only_bands_bytes(nz, H, W, targets, lp=False) -> int:
    """The bytes ``dma_only_bands`` must move (float32 state, the stack in
    bfloat16 with ``lp``): the band quads the colour's base terms read,
    planes 1..nz of each, the two sibling quads' own values, per target
    bq, ud and bet, each read once, and the outputs written once."""
    bands = {band_index(n, ((a + bj) % 2, (b + bi) % 2))
             for a, b in _rb_colour(targets)
             for n, (_, bj, bi) in gather_keys(False)}
    col = nz * H * W
    return (len(bands) * nz * (H + 2) * (W + 2) * (2 if lp else 4)
            + 4 * (2 * col + 2 * (3 * col - H * W) + 2 * col))


def dma_only_bands_plain(e, bq, pack, targets):
    """Per plane, per target of the RB colour ``targets`` in turn: the RHS,
    the target's 12 base-term operator values (relax_compact.block_views
    of the smoother operator, upcast), for the first target the two
    sibling quads' (:func:`relax_tiled.gather_quads`) own values at
    (J, I), ud below the top plane and bet — each added in turn.
    ``{target: sums}``."""
    targets = _rb_colour(targets)
    _, _, bet, _ = smoother_operator(pack, torch.float32)
    out = {}
    for s, t in enumerate(targets):
        m = _TKEYS.index(t)
        acc = bq[t]
        for v in block_views(pack, m, lp=pack.lp is not None)[:12]:
            acc = acc + v.to(torch.float32)
        if s == 0:
            for q in gather_quads(t)[:2]:
                acc = acc + e[q][:, 1:-1, 1:-1]
        acc = torch.cat([acc[:-1] + pack.ud[m], acc[-1:]])
        out[t] = acc + bet[m]
    return out


def dma_only_bands(e, bq, pack, targets):
    """``dma_only`` on the band stack (csrc/roofline.cu
    dma_only_bands_kernel): :func:`dma_only_bands_plain` for float32 state
    ``e`` (extended quads, ``_TKEYS``-keyed) and ``bq``, the RB colour
    ``targets`` and a pack holding the band stack in float32 (or, with
    ``pack.lp``, in bfloat16)."""
    targets = _rb_colour(targets)
    q0 = bq[targets[0]]
    if on_cpu(q0):
        return dma_only_bands_plain(e, bq, pack, targets)
    nz, H, W = q0.shape
    if nz < 2:
        raise ValueError("dma_only_bands needs nz >= 2")
    _, _, bet, band = smoother_operator(pack, q0.dtype)
    holder = pack.lp if pack.lp is not None else pack
    if holder.ebands is None:
        raise ValueError("dma_only_bands reads the band stack; the pack "
                         "holds none")
    check_band_stack(holder.ebands, (NBANDS, nz + 2, H + 2, W + 2), band,
                     q0.device)
    sib = gather_quads(targets[0])[:2]
    named = {f"s{i}": e[q] for i, q in enumerate(sib)}
    shapes = {f"s{i}": (nz, H + 2, W + 2) for i in range(2)}
    for t in targets:
        m = _TKEYS.index(t)
        for f, x in (("bq", bq[t]), ("ud", pack.ud[m]), ("bet", bet[m])):
            named[f"{f}{t}"] = x
            shapes[f"{f}{t}"] = (nz - 1 if f == "ud" else nz, H, W)
    if q0.dtype != torch.float32:
        raise ValueError(f"dma_only_bands takes float32, got {q0.dtype}")
    check_tensors(named, shapes, q0.dtype, q0.device)
    out = {t: torch.empty_like(q0) for t in targets}
    isz = holder.ebands.element_size()
    lpad, _ = band_layout(W, isz)
    per = lambda f: [ptr(named[f"{f}{t}"]) for t in targets]
    lib = _build.load()
    with torch.cuda.device(q0.device):
        rc = lib.mg_dma_only_bands(
            ptr(named["s0"]), ptr(named["s1"]), *per("bq"), *per("ud"),
            *per("bet"), holder.ebands.data_ptr() - lpad * isz,
            *(ptr(out[t]) for t in targets), nz, H, W,
            _TKEYS.index(targets[0]), int(band == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "dma_only")
    LAUNCHES["dma_only"] += 1
    return out


FLOOR_H = 0.5          # step_floor's multiplier (roofline.cu kFloorH)
# (shape, steps, cluster): step_floor at K6's one-launch shapes, RB's
# steps: the coarsest levels of CUC and seamount 64^3 (40 sweeps, one
# block) and CUC level 4 (3 sweeps, a cluster)
STEP_FLOOR_CASES = [((2, 32, 32), 80, False), ((4, 4, 4), 80, False),
                    ((4, 64, 64), 6, True)]


def step_floor_plain(x, nsteps: int):
    """``nsteps`` steps of the step-floor probe on the (nz, ny, nx)
    state ``x``: in step s every column (j, i) with (j + i + s) even runs
    acc = x[0, max(j-1, 0), i] * h, then acc = acc * h + x[k, j, i] for k
    = 0 .. nz-1, all from the state before the step, and writes acc to
    x[0, j, i]."""
    x = x.clone()
    nz, ny, nx = x.shape
    ar = lambda n: torch.arange(n, device=x.device)
    jn = (ar(ny) - 1).clamp(min=0)
    jj = ar(ny)[:, None]
    ii = ar(nx)[None, :]
    for step in range(nsteps):
        acc = x[0, jn] * FLOOR_H
        for k in range(nz):
            acc = acc * FLOOR_H + x[k]
        x[0] = torch.where((jj + ii + step) % 2 == 0, acc, x[0])
    return x


def step_floor_flops(shape, nsteps: int) -> int:
    """The flops of ``nsteps`` steps: per active column (the step's
    parity colour) one multiply and nz multiply-adds."""
    nz, ny, nx = shape
    even = (ny * nx + 1) // 2           # the columns of (j + i) even
    cols = (nsteps + 1) // 2 * even + nsteps // 2 * (ny * nx - even)
    return cols * (2 * nz + 1)


def step_floor(x, nsteps: int, cluster: bool = False):
    """K10 ``step_floor`` on the float32 state ``x`` (nz, ny, nx) in one
    block, or with ``cluster`` in a thread block cluster (a band of rows
    a block): :func:`step_floor_plain` for a CPU tensor.  Returns the
    state and the blocks launched."""
    if on_cpu(x):
        return step_floor_plain(x, nsteps), 1
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 3:
        raise ValueError("step_floor takes a contiguous float32 (nz, ny, nx)"
                         " tensor")
    nz, ny, nx = x.shape
    out = torch.empty_like(x)
    blocks = ctypes.c_int(0)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.mg_step_floor(ptr(x), ptr(out), nz, ny, nx, nsteps,
                               int(cluster), ctypes.byref(blocks),
                               torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "step_floor")
    LAUNCHES["step_floor"] += 1
    return out, blocks.value


def fma_run_plain(x):
    """micro_roofline.py ``fma_kernel`` in float64 (the kernel's float32
    constants), rounded to float32 at the end; every tile computes the
    same block, so this is one tile's result."""
    xd = x.double()
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
    step = f32(1.000001)
    accs = [xd * f32(1.0 + 0.001 * i) for i in range(FMA_CHAINS)]
    for _ in range(FMA_REPS):
        accs = [a * step + xd for a in accs]
    s = accs[0]
    for a in accs[1:]:
        s = s + a
    return s.to(x.dtype)


def fma_run(x):
    """K10 ``fma_run``: :data:`FMA_TILES` tiles of 8 chains x 64 FMAs per
    element of the float32 block ``x``; :func:`fma_run_plain` for a CPU
    tensor."""
    if on_cpu(x):
        return fma_run_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fma_run takes a contiguous float32 tensor")
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.mg_fma_run(ptr(x), ptr(out), x.numel(), FMA_TILES,
                            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "fma_run")
    LAUNCHES["fma_run"] += 1
    return out
