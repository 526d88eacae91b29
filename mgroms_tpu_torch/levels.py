"""Multigrid level plan — a copy of ``mgroms_tpu/levels.py``
(``LevelSpec``, ``ShardSpec``, ``find_grid_levels``, ``build_level_plan``,
``build_shard_plan``, ``describe``), held equal to it by
``tests/test_torch_config_levels.py``.

Level-count and per-level-dims logic mirrors the reference's
``find_grid_levels`` (mg_grids.f90:468-500) and ``define_grid_dims``
(mg_grids.f90:503-577, incl. aggressive z-coarsening at :525-531).

Parallel plan: when a level's local tile falls below ``nsmall`` the
bottleneck mesh axis is dropped (the level is replicated along it), and
only when both axes are dropped is the level fully replicated — the
reference's gradual gathers (mg_gather.f90), staged by mesh axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One multigrid level (global geometry)."""

    index: int            # 0-based level (0 = finest; reference lev = index+1)
    nxg: int              # global interior points in x
    nyg: int              # global interior points in y
    nzg: int              # vertical points
    nd: int               # stored stencil bands: 8 (3-D) or 5 (2-D, nz==1)
    aggressive_from_prev: bool = False  # built by 8:1 z-coarsening

    @property
    def two_d(self) -> bool:
        return self.nzg == 1

    @property
    def dofs(self) -> int:
        return self.nxg * self.nyg * self.nzg


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Distribution of one level over an (npx, npy) device mesh (staged
    agglomeration: sharded over a subset of the mesh axes;
    mg_grids.f90:550-575).  ``sharded`` is False only when both axes are
    dropped."""

    sharded: bool         # any mesh axis still splitting the data
    npx: int              # devices along x actually splitting the data (1 if
    npy: int              # that axis is dropped)
    nx: int               # local interior points in x (per device)
    ny: int
    shard_py: bool = False
    shard_px: bool = False


def find_grid_levels(nxg: int, nyg: int, nzg: int,
                     ncoarsest: int = 4, nzmin: int = 2,
                     aggressive: bool = False) -> int:
    """Number of levels (mg_grids.f90:468-500).

    nlevs = min(levels until min(nxg,nyg) reaches ``ncoarsest``,
                levels until nzg reaches ``nzmin``).
    """
    nhoriz = min(nxg, nyg)
    nl1 = 1 + int(math.floor(math.log2(nhoriz / ncoarsest)))
    nl2 = 1 + int(math.floor(math.log2(nzg / nzmin)))
    if aggressive:
        # 8:1 z-coarsening at level 2 consumes 3 vertical halvings at once
        nl2 = 1 + int(math.floor(math.log2((nzg // 8) / nzmin))) + 1
    return max(1, min(nl1, nl2))


def build_level_plan(nxg: int, nyg: int, nzg: int,
                     aggressive: bool = False) -> List[LevelSpec]:
    """Per-level global dims (mg_grids.f90:503-577, global part).

    Regular 3-D coarsening halves (nx, ny, nz); once nz hits 1 the level is
    2-D and only (nx, ny) halve (mg_grids.f90:533-541).  ``aggressive``
    divides nz by 8 at level 2 (mg_grids.f90:525-531).
    """
    nlevs = find_grid_levels(nxg, nyg, nzg, aggressive=aggressive)
    levels = [LevelSpec(0, nxg, nyg, nzg, nd=8 if nzg > 1 else 5)]
    nx, ny, nz = nxg, nyg, nzg
    for lev in range(1, nlevs):
        agg = False
        if aggressive and lev == 1:
            if nz % 8 != 0:
                raise ValueError("aggressive coarsening requires nz % 8 == 0")
            nz //= 8
            agg = True
        else:
            if nz == 1:
                nx //= 2
                ny //= 2
            else:
                nx //= 2
                ny //= 2
                nz //= 2
        levels.append(LevelSpec(lev, nx, ny, nz, nd=8 if nz > 1 else 5,
                                aggressive_from_prev=agg))
    return levels


def build_shard_plan(levels: List[LevelSpec], npx: int, npy: int,
                     nsmall: int = 8) -> List[ShardSpec]:
    """Per-level distribution plan over an (npx, npy) mesh.

    Trigger rule mirrors mg_grids.f90:550: whenever the local tile's
    smaller horizontal dimension would drop below ``nsmall`` (or stop
    dividing evenly), the mesh axis whose local extent is the bottleneck
    is dropped first; axis drops are monotonic down the hierarchy.
    """
    specs: List[ShardSpec] = []
    py, px = npy > 1, npx > 1          # active axes (monotonic)
    for spec in levels:
        while True:
            bad_y = py and (spec.nyg % npy or spec.nyg // npy < nsmall)
            bad_x = px and (spec.nxg % npx or spec.nxg // npx < nsmall)
            if not (bad_y or bad_x):
                break
            # drop the bottleneck axis (smaller local extent first)
            if bad_y and bad_x:
                if spec.nyg // npy <= spec.nxg // npx:
                    py = False
                else:
                    px = False
            elif bad_y:
                py = False
            else:
                px = False
        apy = npy if py else 1
        apx = npx if px else 1
        specs.append(ShardSpec(py or px, apx, apy,
                               spec.nxg // apx, spec.nyg // apy,
                               shard_py=py, shard_px=px))
    return specs


def describe(levels: List[LevelSpec],
             shards: List[ShardSpec] | None = None) -> str:
    """Human-readable level table (reference ``print_grids``,
    mg_grids.f90:741-763)."""
    out = ["lev    nxg    nyg  nzg  nd  dist"]
    for i, l in enumerate(levels):
        if shards is not None:
            s = shards[i]
            if s.sharded:
                ax = ("py" if s.shard_py else "") + \
                     ("px" if s.shard_px else "")
                dist = f"{s.npx}x{s.npy} shard {s.nx}x{s.ny} [{ax}]"
            else:
                dist = "replicated"
        else:
            dist = "-"
        out.append(f"{l.index:3d} {l.nxg:6d} {l.nyg:6d} {l.nzg:4d} "
                   f"{l.nd:3d}  {dist}")
    return "\n".join(out)
