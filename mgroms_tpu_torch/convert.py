"""Carry assembled state into the port as numpy arrays.

The JAX package's assembled operators, fine metrics, smoother packs and
packed-stream sweep operators (converted to numpy by the caller) become
the port's tensors, so a solve can be checked apart from assembly:

    ops, metrics = operators_from_numpy(
        levels, [np.asarray(o.cA) for o in jax_model.ops],
        {f: np.asarray(x) for f, x in jax_model.metrics._asdict().items()})
    model.use_operators(ops, metrics)

Every function puts the tensors on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .assembly import FineMetrics, LevelOperator
from .ops.kernels.sweep_packed import SweepOperator
from .ops.relax_compact import CompactPack, LowPrecision


def _t(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def operators_from_numpy(levels, cA_list: Sequence, metrics: Mapping,
                         device="cuda", dtype=torch.float64):
    """Per-level band stacks ``cA_list[lev]`` (8, nz, ny+2, nx+2) and the
    FineMetrics fields ``metrics`` (name -> array) as the port's
    ``(list[LevelOperator], FineMetrics)``.  Shapes are checked against the
    level plan; the u/v masks are all-ones (no bmask)."""
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
        ops.append(LevelOperator(cA=_t(cA, device, dtype), umask=ones,
                                 vmask=ones))
    fm = FineMetrics(**{f: _t(metrics[f], device, dtype)
                        for f in FineMetrics._fields})
    return ops, fm


def pack_from_numpy(fields: Mapping, real_matrix: bool, device="cuda",
                    dtype=torch.float64) -> CompactPack:
    """A CompactPack from ``fields``: ``blocks``, ``d``, ``ud``, ``bet``
    (and ``rblocks`` when ``real_matrix``), each a sequence of the four
    target quads' arrays in ``_TKEYS`` order.

    With ``blocks_lp`` and ``bet_lp`` (and ``rblocks_lp`` when
    ``real_matrix``) the pack also carries the low-precision smoother
    operator (``pack.lp``, the JAX package's ``attach_lp``): the blocks
    arrive as float32 arrays of bfloat16 values and are stored in bfloat16
    (exact), the pivots in ``dtype``.  The Thomas multipliers ``gam`` are
    not carried for either operator: the port recomputes them as
    ``ud * bet``."""
    conv = {k: tuple(_t(a, device, dtype) for a in fields[k])
            for k in ("blocks", "d", "ud", "bet")}
    rb = (tuple(_t(a, device, dtype) for a in fields["rblocks"])
          if real_matrix else None)
    lp = None
    if "blocks_lp" in fields:
        bf16 = lambda xs: tuple(_t(a, device, torch.float32)
                                .to(torch.bfloat16) for a in xs)
        lp = LowPrecision(
            blocks=bf16(fields["blocks_lp"]),
            rblocks=bf16(fields["rblocks_lp"]) if real_matrix else None,
            bet=tuple(_t(a, device, dtype) for a in fields["bet_lp"]))
    return CompactPack(real_matrix=real_matrix, rblocks=rb, lp=lp, **conv)


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
