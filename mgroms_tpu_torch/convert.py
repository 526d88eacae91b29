"""Carry assembled state into the port as numpy arrays.

The JAX package's assembled operators, fine metrics, smoother packs and
packed-stream sweep operators (converted to numpy by the caller) become
the port's tensors, so a solve can be checked apart from assembly:

    ops, metrics = operators_from_numpy(
        levels, [np.asarray(o.cA) for o in jax_model.ops],
        {f: np.asarray(x) for f, x in jax_model.metrics._asdict().items()})
    model.use_operators(ops, metrics)

A distributed state carries over the same way: the JAX package's blocked
arrays (per-shard blocks side by side in the last two dims: the
``block_extended`` cA of its shard_map backend, the leaves of its per-shard
packs) become the port's tile grids (:func:`tiles_from_numpy`,
:func:`pack_tiles_from_numpy`).

Every function puts the tensors on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .assembly import FineMetrics, LevelOperator
from .ops.kernels.sweep_packed import SweepOperator
from .ops.relax_compact import CompactPack, LowPrecision, stack_bands
from .parallel.mesh import Tiles


def _t(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def operators_from_numpy(levels, cA_list: Sequence, metrics: Mapping,
                         device="cuda", dtype=torch.float64,
                         Ainv: Sequence | None = None):
    """Per-level band stacks ``cA_list[lev]`` (8, nz, ny+2, nx+2) and the
    FineMetrics fields ``metrics`` (name -> array) as the port's
    ``(list[LevelOperator], FineMetrics)``.  Shapes are checked against the
    level plan; the u/v masks are all-ones (no bmask).  ``Ainv[lev]`` is
    the level's dense inverse or None (the JAX package's
    ``LevelOperator.Ainv`` of a ``coarsest='direct'`` model, on its
    coarsest level)."""
    if len(cA_list) != len(levels):
        raise ValueError(f"{len(cA_list)} band stacks for "
                         f"{len(levels)} levels")
    ops = []
    for spec, cA in zip(levels, cA_list):
        want = (8, spec.nzg, spec.nyg + 2, spec.nxg + 2)
        if tuple(cA.shape) != want:
            raise ValueError(f"level {spec.index}: cA shape "
                             f"{tuple(cA.shape)}, expected {want}")
        ones = torch.ones(want[2:], dtype=dtype, device=device)
        inv = None if Ainv is None else Ainv[spec.index]
        ops.append(LevelOperator(
            cA=_t(cA, device, dtype), umask=ones, vmask=ones,
            Ainv=None if inv is None else _t(inv, device, dtype)))
    fm = FineMetrics(**{f: _t(metrics[f], device, dtype)
                        for f in FineMetrics._fields})
    return ops, fm


def pack_from_numpy(fields: Mapping, real_matrix: bool, device="cuda",
                    dtype=torch.float64) -> CompactPack:
    """A CompactPack from ``fields``: ``d``, ``ud``, ``bet`` and the gather
    operator — ``blocks`` (and ``rblocks`` when ``real_matrix``), or only
    ``ebands`` below, as a level K4 smooths holds it — each a sequence of
    the four target quads' arrays in ``_TKEYS`` order.

    With ``bet_lp`` and ``blocks_lp`` (and ``rblocks_lp`` when
    ``real_matrix``) or ``ebands_lp`` the pack also carries the
    low-precision smoother operator (``pack.lp``, the JAX package's
    ``attach_lp``): the blocks arrive as float32 arrays of bfloat16 values
    and are stored in bfloat16 (exact), the pivots in ``dtype``.  The
    Thomas multipliers ``gam`` are not carried for either operator: the
    port recomputes them as ``ud * bet``.

    With ``ebands`` (or ``ebands_lp``, bfloat16 values as float32 arrays),
    the 24 band quads the colour-fused sweep reads (relax_compact.
    band_quads order, (nz, H+2, W+2) each: the JAX package's
    ``SweepOperator.ebands`` of one chunk without its padding row and
    columns, ``ebands[0][i][:, 1:H+3, 1:W+3]``), the pack carries their
    stack (relax_compact.stack_bands)."""
    conv = {k: tuple(_t(a, device, dtype) for a in fields[k])
            for k in ("d", "ud", "bet")}
    blocks = "blocks" in fields
    if not (blocks or "ebands" in fields):
        raise ValueError("a pack needs its gather operator: blocks or "
                         "ebands")
    conv["blocks"] = (tuple(_t(a, device, dtype) for a in fields["blocks"])
                      if blocks else None)
    rb = (tuple(_t(a, device, dtype) for a in fields["rblocks"])
          if real_matrix and blocks else None)
    bf16 = lambda xs: tuple(_t(a, device, torch.float32)
                            .to(torch.bfloat16) for a in xs)
    stack = lambda xs, dt: stack_bands([_t(a, device, dtype) for a in xs],
                                       dt)
    lp = None
    if "bet_lp" in fields:
        lp_blocks = "blocks_lp" in fields
        lp = LowPrecision(
            blocks=bf16(fields["blocks_lp"]) if lp_blocks else None,
            rblocks=(bf16(fields["rblocks_lp"])
                     if real_matrix and lp_blocks else None),
            bet=tuple(_t(a, device, dtype) for a in fields["bet_lp"]),
            ebands=(stack(fields["ebands_lp"], torch.bfloat16)
                    if "ebands_lp" in fields else None))
    eb = stack(fields["ebands"], dtype) if "ebands" in fields else None
    return CompactPack(real_matrix=real_matrix, rblocks=rb, lp=lp,
                       ebands=eb, **conv)


def packed_operator_from_numpy(pband: Sequence, ppiv: Sequence,
                               pseam: Sequence, tj: int, nchunks: int,
                               device="cuda", dtype=torch.float64,
                               band_dtype=None) -> SweepOperator:
    """The JAX package's packed-stream ``SweepOperator`` (its per-chunk
    ``pband``/``ppiv``/``pseam`` as numpy arrays, its plan's ``tj`` and
    ``nchunks``) as the port's (ops/kernels/sweep_packed.SweepOperator).
    Bands of another type than the state (bfloat16) arrive as float32
    arrays and are stored in ``band_dtype`` (exact)."""
    if not len(pband) == len(ppiv) == len(pseam) == nchunks:
        raise ValueError(f"{len(pband)}/{len(ppiv)}/{len(pseam)} chunk "
                         f"streams for {nchunks} chunks")
    bd = band_dtype or dtype
    band = tuple(_t(a, device, torch.float32 if bd == torch.bfloat16
                    else bd).to(bd) for a in pband)
    return SweepOperator(pband=band,
                         ppiv=tuple(_t(a, device, dtype) for a in ppiv),
                         pseam=tuple(_t(a, device, dtype) for a in pseam),
                         tj=tj, nchunks=nchunks)


def _tile_slices(a, shape):
    """The (ny, nx) grid ``shape`` of equal blocks of ``a``'s last two
    dims."""
    ny, nx = shape
    bj, bi = a.shape[-2] // ny, a.shape[-1] // nx
    return [[a[..., j * bj:(j + 1) * bj, i * bi:(i + 1) * bi]
             for i in range(nx)] for j in range(ny)]


def _tile_device(device, j, i):
    """``device``, or tile (j, i)'s entry of a grid of devices."""
    return device[j][i] if isinstance(device, (list, tuple)) else device


def tiles_from_numpy(blocked, shape, device="cuda",
                     dtype=torch.float64) -> Tiles:
    """A blocked array — the tiles' arrays side by side in the last two
    dims, e.g. the JAX package's ``block_extended`` cA — as a Tiles grid of
    ``shape`` (tiles along y, along x).  ``device`` is one device or a
    grid of them, one per tile."""
    grid = _tile_slices(np.asarray(blocked), shape)
    return Tiles([[_t(a, _tile_device(device, j, i), dtype)
                   for i, a in enumerate(row)] for j, row in enumerate(grid)])


def pack_tiles_from_numpy(fields: Mapping, shape, real_matrix: bool,
                          device="cuda", dtype=torch.float64) -> Tiles:
    """The JAX package's per-shard CompactPack (its leaves, as numpy: the
    tiles' arrays side by side in the last two dims) as a Tiles grid of
    ``shape`` of the port's packs (:func:`pack_from_numpy` per tile)."""
    ny, nx = shape
    split = {k: [_tile_slices(np.asarray(a), shape) for a in v]
             for k, v in fields.items()}
    return Tiles([[pack_from_numpy(
        {k: [g[j][i] for g in v] for k, v in split.items()}, real_matrix,
        device=_tile_device(device, j, i), dtype=dtype)
        for i in range(nx)] for j in range(ny)])
