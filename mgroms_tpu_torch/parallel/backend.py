"""The single-device backend over a mesh plan: replicated levels and the
layout changes between levels.

Port of the part of ``mgroms_tpu/parallel/backend.py``'s
``DistributedBackend`` that the shard_map backend inherits (its
``_use_tiled`` gate, here with ``_use_sweep``, and the transfers and zeros
around replicated levels; its ``_use_compact`` has no reader in the port,
whose quad levels are those with a pack).  The JAX class pins every level to its sharding and
lets GSPMD insert the collectives; here a sharded level's state is a
:class:`~.mesh.Tiles` grid, a replicated level's one tensor on the mesh's
first device, and where two neighbouring levels differ in their active
axes (a stage of the agglomeration) :meth:`restrict` and :meth:`prolong`
gather the tiles and split them again — the reference's gather/split
pair (mg_gather.f90:18-220) as one copy each way.  The GSPMD comm layer
itself (``shard_operators``, compiler-inserted collectives) is not ported.
"""

from __future__ import annotations

from typing import List

import torch

from ..assembly import LevelOperator
from ..bc import extend_h1
from ..config import SolverConfig
from ..levels import LevelSpec
from ..ops import transfer
from ..ops.relax_compact import QuadField
from ..solver import SingleDeviceBackend
from .mesh import MeshPlan, Tiles, join_tiles, move, split_tiles


class DistributedBackend(SingleDeviceBackend):
    # its solves stay eager: mesh.shard_map runs the tiles' programs on
    # host threads, which one CUDA graph capture cannot follow
    capturable = False

    def __init__(self, levels: List[LevelSpec], ops: List[LevelOperator],
                 cfg: SolverConfig, plan: MeshPlan, packs: list):
        super().__init__(levels, ops, cfg, packs=packs,
                         on_card=plan.mesh.on_card)
        self.plan = plan
        self.ndevices = plan.mesh.size

    def _sharded(self, lev: int) -> bool:
        return self.plan.shards[lev].sharded

    def _use_tiled(self, lev: int, kind: str) -> bool:
        return not self._sharded(lev) and super()._use_tiled(lev, kind)

    def _use_sweep(self, lev: int) -> bool:
        # K4 builds the mirror halo inside the kernel: replicated levels only
        return not self._sharded(lev) and super()._use_sweep(lev)

    # -- layouts -----------------------------------------------------------
    def _tile_grid(self, lev: int):
        return self.plan.mesh.tile_devices(self.plan.spec(lev))

    def place(self, lev: int, x):
        """A global state (full layout, or a QuadField of global quads) in
        level ``lev``'s layout: its tiles, or one tensor on the first
        device.  Full-layout tiles of another grid are joined first."""
        if isinstance(x, Tiles):
            grid = self._tile_grid(lev)
            if self._sharded(lev) and x.shape == (len(grid), len(grid[0])):
                return x
            x = join_tiles(x, self.plan.mesh.first)
        if not self._sharded(lev):
            return move(x, self.plan.mesh.first)
        devs = self._tile_grid(lev)
        shape = (len(devs), len(devs[0]))
        if isinstance(x, QuadField):
            per_quad = [split_tiles(q, shape, devs) for q in x.quads]
            return Tiles([[QuadField(t.grid[j][i] for t in per_quad)
                           for i in range(shape[1])]
                          for j in range(shape[0])])
        return split_tiles(x, shape, devs)

    def gather(self, lev: int, x) -> torch.Tensor:
        """Level ``lev``'s state as one full-layout tensor on the first
        device."""
        x = self.to_full(lev, x)
        return (join_tiles(x, self.plan.mesh.first) if isinstance(x, Tiles)
                else x)

    # -- transfers ---------------------------------------------------------
    def restrict(self, lev: int, r, as_quads: bool = False):
        """Children sums per tile (a coarse tile's children are exactly
        the fine tile); where the coarse level has other active axes, the
        coarse tiles are joined and split into its layout."""
        if not isinstance(r, Tiles):
            return super().restrict(lev, r, as_quads=as_quads)
        coarse = r.map(lambda x: SingleDeviceBackend.restrict(self, lev, x))
        if self.plan.spec(lev + 1) != self.plan.spec(lev) \
                or not self._sharded(lev + 1):
            coarse = self.place(lev + 1, join_tiles(coarse,
                                                    self.plan.mesh.first))
        if not as_quads:
            return coarse
        return (coarse.map(QuadField.split) if isinstance(coarse, Tiles)
                else QuadField.split(coarse))

    def prolong(self, lev: int, pc, as_quads: bool = False):
        """Across a stage of the agglomeration: the coarse state gathered,
        extended with the physical mirror and prolonged whole, then split
        into the fine layout."""
        if not self._sharded(lev):
            return super().prolong(lev, pc, as_quads=as_quads)
        out = transfer.prolong(extend_h1(self.gather(lev + 1, pc)),
                               self.levels[lev].nzg, self.cfg.interp_type,
                               as_quads=as_quads)
        return self.place(lev, QuadField.fromdict(out) if as_quads else out)

    def zeros(self, lev: int, as_quads: bool = False):
        if not self._sharded(lev):
            return super().zeros(lev, as_quads=as_quads)
        s, sh = self.levels[lev], self.plan.shards[lev]
        dt = getattr(torch, self.cfg.dtype)
        if as_quads:
            z = lambda d: QuadField(torch.zeros(
                (s.nzg, sh.ny // 2, sh.nx // 2), dtype=dt, device=d)
                for _ in range(4))
        else:
            z = lambda d: torch.zeros((s.nzg, sh.ny, sh.nx), dtype=dt,
                                      device=d)
        return Tiles(self._tile_grid(lev)).map(z)

    # -- reductions --------------------------------------------------------
    def norm_sq(self, lev: int, x) -> torch.Tensor:
        """On a sharded level the sum of the tiles' partial sums, in
        row-major order, on the first device."""
        if not isinstance(x, Tiles):
            return super().norm_sq(lev, x)
        first = self.plan.mesh.first
        parts = [SingleDeviceBackend.norm_sq(self, lev, t).to(first)
                 for t in x.flat()]
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return s

    def synchronize(self) -> None:
        if self.on_card:
            for d in {d for row in self.plan.mesh.devices for d in row}:
                torch.cuda.synchronize(d)
