"""The GSPMD comm layer: the single-device ops over a mesh plan, with the
operators replicated.

Port of ``mgroms_tpu/parallel/backend.py``.  There every level's state is
a global array pinned to the level's sharding (``MeshPlan.constrain``) and
XLA partitions each op, inserting the halo collective-permutes; the
operators are replicated on every device (:func:`shard_operators`), each
slicing its window locally.  Here one process drives the mesh
(parallel/mesh.py): a sharded level's state is a :class:`~.mesh.Tiles`
grid, a replicated level's one tensor on the mesh's first device, and
what XLA's partitioner does is written out:

- the ops it partitions run per tile on the lock-step runner
  (:func:`~.mesh.shard_map`): the masked relax (RB/FC/GS masks from the
  tile's origin, Thomas or PCR), the residual, and the prolongation where
  both levels keep the same active axes.  Each tile reads its window of
  the replicated ``cA`` (rows ``j0 .. j0+ny_l+1`` of the (ny+2, nx+2)
  storage) and takes its state's halo ring from ``exchange.halo_extend``
  (the neighbours', or the physical mirror on a domain edge);
- the ops it cannot partition run on the level gathered onto the first
  device, as on one device, and are placed back: K6 under ``use_pallas``,
  the order-exact ``gs_exact`` sweep, and the 'direct' coarsest product
  on a sharded coarsest level;
- a stage of the agglomeration (the next level keeps other axes, or none)
  is one join and split of the grid — the reference's gather/split pair
  (mg_gather.f90:18-220) as one copy each way (:meth:`restrict`,
  :meth:`prolong`);
- replicated levels run the single-device code with their persisted
  packs (K4 or K1-K2, and K3); quad state and the kernels K4 and K5 are
  vetoed on sharded levels (the JAX ``_use_compact``/``_use_tiled``).

The result equals the single-device solve up to the order of the norms'
sums (:meth:`DistributedBackend.norm_sq`: the tiles' partial sums).

The explicit layer (parallel/shardmap_backend.py) inherits all of this
and replaces the per-tile operator (its own blocked tiles) and the quad
levels' routing.
"""

from __future__ import annotations

from typing import List

import torch

from ..assembly import LevelOperator
from ..bc import extend_h1
from ..config import SolverConfig
from ..levels import LevelSpec
from ..ops import relax as relax_ops
from ..ops import stencil, transfer
from ..ops.kernels import stencil_tiled
from ..ops.relax_compact import QuadField
from ..solver import SingleDeviceBackend, gs_exact_wanted
from .exchange import axis_offsets, halo_extend
from .mesh import MeshPlan, Replicated, Tiles, join_tiles, shard_map


def shard_operators(ops: List[LevelOperator], plan: MeshPlan
                    ) -> List[Replicated]:
    """The assembled operators, ``Ainv`` included, held whole once on each
    distinct device of the mesh (one copy on a virtual mesh of one card,
    the model's own where it lies on the first device); no per-tile
    blocks.  The halo-extended (ny+2, nx+2) storage does not tile evenly,
    so the JAX package replicates it and each device slices its window;
    the per-tile blocked storage that saves the replicas is the shard_map
    layer's (shardmap_backend.shard_operators_blocked)."""
    return [Replicated(op, plan.mesh) for op in ops]


class DistributedBackend(SingleDeviceBackend):
    """The GSPMD layer (module docstring); ``ops`` the per-level operators:
    :class:`~.mesh.Replicated` (:func:`shard_operators`), or LevelOperators
    with per-tile ``cA`` on the sharded levels (the shard_map layer)."""

    # its solves stay eager: mesh.shard_map runs the tiles' programs on
    # host threads, which one CUDA graph capture cannot follow
    capturable = False

    def __init__(self, levels: List[LevelSpec], ops: list,
                 cfg: SolverConfig, plan: MeshPlan, packs: list):
        self.replicas = [op if isinstance(op, Replicated) else None
                         for op in ops]
        super().__init__(levels, [op.first if isinstance(op, Replicated)
                                  else op for op in ops],
                         cfg, packs=packs, on_card=plan.mesh.on_card)
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

    def _axes(self, lev: int):
        """Active mesh axis names for this level (None = dropped by staged
        agglomeration: physical mirror instead of seam exchange there)."""
        return self.plan.spec(lev)

    def _map(self, lev: int, fn, *args):
        """``fn`` on every tile of level ``lev`` (mesh.shard_map)."""
        return shard_map(fn, self.plan.mesh, self._axes(lev))(*args)

    def place(self, lev: int, x):
        """``x`` in level ``lev``'s placement (MeshPlan.constrain)."""
        return self.plan.constrain(lev, x)

    def gather(self, lev: int, x) -> torch.Tensor:
        """Level ``lev``'s state as one full-layout tensor on the first
        device."""
        x = self.to_full(lev, x)
        return (join_tiles(x, self.plan.mesh.first) if isinstance(x, Tiles)
                else x)

    def to_state(self, lev: int, x):
        """A state in any placement (a global b included) in level
        ``lev``'s placement and layout."""
        x = self.place(lev, x)
        if isinstance(x, Tiles):
            return (x.map(QuadField.split)
                    if self.state_quads(lev) and not x.is_quads else x)
        return super().to_state(lev, x)

    def to_full(self, lev: int, x):
        if isinstance(x, Tiles) and x.is_quads:
            return x.map(QuadField.merge)
        return super().to_full(lev, x)

    def _tile_cA(self, lev: int) -> Tiles:
        """Each tile's (8, nz, ny_l+2, nx_l+2) operator: the shard_map
        layer's own blocked tiles, or the tile's window (a view) of the
        copy of ``cA`` replicated on its device."""
        cA = self.ops[lev].cA
        if isinstance(cA, Tiles):
            return cA
        sh, rep = self.plan.shards[lev], self.replicas[lev]
        return Tiles([[rep.on(d).cA[..., j * sh.ny:(j + 1) * sh.ny + 2,
                                    i * sh.nx:(i + 1) * sh.nx + 2]
                       for i, d in enumerate(row)]
                      for j, row in enumerate(self._tile_grid(lev))])

    # -- smoothing and residual ---------------------------------------------
    def _gathered(self, lev: int) -> bool:
        """The relax routes no tile can run alone: the 'direct' coarsest
        product, ``gs_exact``'s sequential sweep and K6 (the
        single-device relax's order of routes)."""
        return ((lev == self.nlevs - 1 and self.cfg.coarsest == "direct"
                 and self.ops[lev].Ainv is not None)
                or gs_exact_wanted(self.cfg) or self._use_pallas(lev))

    def relax(self, lev, p, b, nsweeps):
        if not self._sharded(lev):
            return super().relax(lev, p, b, nsweeps)
        if self._gathered(lev):
            return self.place(lev, super().relax(
                lev, self.gather(lev, p), self.gather(lev, b), nsweeps))
        return self._relax_tiles(lev, p, b, nsweeps)

    def _relax_tiles(self, lev, p, b, nsweeps):
        """The masked relax on every tile of a sharded full-layout level:
        the ordering's colours from the tile's global origin, the halo
        ring exchanged before each colour."""
        cfg, real, sh = self.cfg, self.real, self.plan.shards[lev]
        pya, pxa = self._axes(lev)

        def local(p_l, b_l, cA_l):
            j0, i0 = axis_offsets(sh.ny, sh.nx, pya, pxa)
            return relax_ops.relax(
                p_l, b_l, cA_l, nsweeps, cfg.relax_kind, real,
                extend_fn=lambda x: halo_extend(x, pya, pxa),
                j0=j0, i0=i0, tridiag_method=cfg.tridiag)

        return self._map(lev, local, p, b, self._tile_cA(lev))

    def residual(self, lev, p, b):
        if not self._sharded(lev):
            return super().residual(lev, p, b)
        return self._residual_tiles(lev, p, b)

    def _residual_tiles(self, lev, p, b, tiled: bool = False):
        """r = b - A p on every tile of a sharded full-layout level (K5
        per tile with ``tiled``)."""
        real = self.real
        pya, pxa = self._axes(lev)

        def local(p_l, b_l, cA_l):
            pe = halo_extend(p_l, pya, pxa)
            if tiled:
                return stencil_tiled.residual_tiled(pe, b_l, cA_l, real)
            return stencil.residual(pe, b_l, cA_l, real)

        return self._map(lev, local, p, b, self._tile_cA(lev))

    # -- transfers ---------------------------------------------------------
    def _same_axes(self, lev) -> bool:
        """The local coarse tile is exactly the local fine tile's children
        (same active axes, standard 8:1 restriction)."""
        shf, shc = self.plan.shards[lev], self.plan.shards[lev + 1]
        return (shc.sharded and shf.shard_py == shc.shard_py
                and shf.shard_px == shc.shard_px
                and not self.levels[lev + 1].aggressive_from_prev)

    def restrict(self, lev: int, r, as_quads: bool = False):
        """Children sums per tile (a coarse tile's children are exactly
        the fine tile); where the coarse level has other active axes, the
        coarse tiles are joined and split into its layout."""
        if not isinstance(r, Tiles):
            return super().restrict(lev, r, as_quads=as_quads)
        coarse = self.place(lev + 1, r.map(
            lambda x: SingleDeviceBackend.restrict(self, lev, x)))
        if not as_quads:
            return coarse
        return (coarse.map(QuadField.split) if isinstance(coarse, Tiles)
                else QuadField.split(coarse))

    def prolong(self, lev: int, pc, as_quads: bool = False):
        """Per tile where both levels keep the same active axes (the coarse
        state extended by the halo exchange); across a stage of the
        agglomeration the coarse state gathered, extended with the
        physical mirror and prolonged whole, then split into the fine
        layout."""
        if not self._sharded(lev):
            return super().prolong(lev, pc, as_quads=as_quads)
        nz_f, interp = self.levels[lev].nzg, self.cfg.interp_type
        if not self._same_axes(lev):
            out = transfer.prolong(
                extend_h1(self.gather(lev + 1, pc)), nz_f, interp,
                aggressive=self.levels[lev + 1].aggressive_from_prev,
                as_quads=as_quads)
            return self.place(lev,
                              QuadField.fromdict(out) if as_quads else out)
        pya, pxa = self._axes(lev)

        def local(pc_l):
            # quad-persistent coarse state merges locally; the fine output
            # stays in quads when the fine level is quad-persistent
            if isinstance(pc_l, QuadField):
                pc_l = pc_l.merge()
            out = transfer.prolong(halo_extend(pc_l, pya, pxa), nz_f,
                                   interp, as_quads=as_quads)
            return QuadField.fromdict(out) if as_quads else out

        return self._map(lev, local, pc)

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
            for d in self.plan.mesh.distinct:
                torch.cuda.synchronize(d)
