"""Explicit shard_map backend: per-tile operators + neighbour halo exchange.

Port of ``mgroms_tpu/parallel/shardmap_backend.py`` — the reference's
distribution contract (mg_mpi_exchange.f90 / mg_grids.f90) made explicit:

  - every sharded level's operator is stored *per tile, extended*: each
    tile holds its (8, nz, ny_l+2, nx_l+2) band stack, halo ring included
    (the per-rank ``cA(nd,nz,0:ny+1,0:nx+1)`` allocation,
    mg_grids.f90:24-65);
  - the halo is refreshed by the two-phase exchange of parallel/
    exchange.py, once per smoother colour (mg_relax.f90:181);
  - the red-black parity comes from the tile's global origin;
  - levels below the agglomeration threshold stay replicated and run the
    single-device code (replicate-not-idle, mg_gather.f90).

Iterates equal the single-device solver's: seam halos carry neighbour
interior values, domain-edge halos the Neumann mirror — the same extended
array extend_h1 builds globally.

Routing on a sharded level.  Compact (quad-parity) levels
(:func:`compact_shard_eligible`) run the K1-K3 orchestration of
ops/kernels/relax_tiled.py per tile with the seam exchange as its
``extend_fn``, as the single-device port runs its quad levels (the
wrappers take their plain versions on the CPU); K4 never runs here, since
it builds the mirror halo inside the kernel.  Full-layout levels run the
masked relax with the tile's origin and the residual of K5 where the tile
is at least 256 wide (``pallas_tiled``), else ops/stencil.residual — the
per-tile bodies of the GSPMD layer (parallel/backend.py), which the two
layers share: they differ in the operator each tile reads (here its own
blocked tile, there its window of the replicated cA) and in the routes
that layer gathers (K6, ``gs_exact``, the 'direct' coarsest product),
which run per tile here as in the JAX package.  The JAX gates' TPU-only parts (``pallas_tiled_relax``, the Mosaic tile budgets
``supports``, interpret mode) have no counterpart, so the JAX package's
``_use_tiled_shard`` holds on every compact level and its non-tiled
branches are not carried over.
"""

from __future__ import annotations

from typing import List

import torch

from ..assembly import LevelOperator
from ..config import SolverConfig
from ..levels import LevelSpec, ShardSpec
from ..ops.kernels import relax_tiled as kernels
from .. import solver
from ..ops.relax_compact import (QuadField, attach_lp, build_band_pack,
                                 build_compact_pack, residual_quads)
from ..solver import compact_eligible, is_quads
from .backend import DistributedBackend
from .exchange import extend_quads_shard
from .mesh import MeshPlan, split_tiles


def compact_shard_eligible(spec: LevelSpec, sh: ShardSpec,
                           cfg: SolverConfig) -> bool:
    """Quad-parity compact smoothing eligibility for a SHARDED level: the
    single-device rule (solver.compact_eligible) with even local tiles, so
    that local quad parity is the global parity
    (parallel/exchange.extend_quads_shard).  The same on every device: the
    JAX package's further gate on its accelerator (quad tiles >= 128 wide,
    for the TPU's (8, 128) vector registers) has no counterpart on the
    card."""
    return (compact_eligible(spec, cfg)
            and sh.ny % 2 == 0 and sh.nx % 2 == 0)


def default_comm(levels: List[LevelSpec], plan: MeshPlan,
                 cfg: SolverConfig) -> str:
    """Auto comm-layer selection (``NHModel.distribute(comm='auto')``):
    the explicit shard_map backend whenever any sharded level can smooth
    in quad-parity compact form there, else 'gspmd' (parallel/backend.py).  The reference's flagship is such a run (testcuc:
    1024^2 on 2x2, mg_testcuc.f90:34-39)."""
    for lev, spec in enumerate(levels):
        sh = plan.shards[lev]
        if sh.sharded and compact_shard_eligible(spec, sh, cfg):
            return "shard_map"
    return "gspmd"


def shard_packs_blocked(levels: List[LevelSpec], ops_blocked, cfg,
                        plan: MeshPlan, backend: "ShardMapBackend") -> list:
    """Per-tile persisted CompactPacks for the SHARDED compact levels, built
    from the per-tile extended cA (each tile keeps exactly its operator and
    pivots, the reference's per-rank operator economy): the band stack
    where solver.band_stack_wanted holds for the tile (on the card), else
    the gather blocks; a tile's stack and its gather blocks are cut from
    the same quad-sampled bands of its extended cA.  With
    ``fused_bands_bf16`` each also carries the low-precision smoother
    operator, as solver.build_relax_packs gives the single-device levels.
    One Tiles of packs or None per level."""
    real = cfg.cmatrix == "real"
    lp = cfg.fused_bands_bf16 and getattr(torch, cfg.dtype).itemsize <= 4
    packs = []
    for lev in range(len(levels)):
        if not (plan.shards[lev].sharded and backend._use_compact_shard(lev)):
            packs.append(None)
            continue
        build = lambda cA_l: (
            build_band_pack if solver.band_stack_wanted(cfg, cA_l.is_cuda)
            else build_compact_pack)(cA_l, real)
        tiles = ops_blocked[lev].cA.map(build)
        packs.append(tiles.map(attach_lp) if lp else tiles)
    return packs


def shard_operators_blocked(ops: List[LevelOperator], plan: MeshPlan
                            ) -> List[LevelOperator]:
    """Sharded levels: cA as per-tile extended tiles (block_extended's
    blocks), blocked only along the level's ACTIVE mesh axes (staged
    agglomeration).  Replicated levels: cA on the mesh's first device.
    The masks go to the first device."""
    mesh = plan.mesh
    out = []
    for lev, op in enumerate(ops):
        if plan.shards[lev].sharded:
            devs = mesh.tile_devices(plan.spec(lev))
            cA = split_tiles(op.cA, (len(devs), len(devs[0])), devs,
                             extra=(2, 2))
        else:
            cA = op.cA.to(mesh.first)
        out.append(LevelOperator(
            cA=cA, umask=op.umask.to(mesh.first),
            vmask=op.vmask.to(mesh.first),
            Ainv=None if op.Ainv is None else op.Ainv.to(mesh.first)))
    return out


class ShardMapBackend(DistributedBackend):
    """Same cycle math, explicit communication."""

    # -- smoothing ----------------------------------------------------------
    def _use_compact_shard(self, lev) -> bool:
        return compact_shard_eligible(self.levels[lev],
                                      self.plan.shards[lev], self.cfg)

    def _ext(self, lev):
        pya, pxa = self._axes(lev)
        return lambda q: extend_quads_shard(q, py_axis=pya, px_axis=pxa)

    # -- quad-persistent state on SHARDED levels ----------------------------
    def state_quads(self, lev: int) -> bool:
        if lev >= self.nlevs - 1:
            return False
        if not self._sharded(lev):
            return super().state_quads(lev)
        return self._use_compact_shard(lev) and self.packs[lev] is not None

    def _relax_quads_shard(self, lev, p, b, nsweeps):
        """Quad-native smoothing on a sharded level: K1 per colour on
        every tile with the seam exchange per colour — the
        fill_halo-per-colour protocol (mg_relax.f90:181) on QuadField
        state."""
        ext, kind = self._ext(lev), self.cfg.relax_kind

        def local(pq, bq, pack_l):
            return QuadField.fromdict(kernels.relax_compact_tiled_quads(
                pq.asdict(), bq.asdict(), pack_l, nsweeps, kind=kind,
                extend_fn=ext))

        return self._map(lev, local, p, b, self.packs[lev])

    def supports_fused_residual(self, lev: int) -> bool:
        if not self._sharded(lev):
            # replicated levels use the inherited single-device
            # orchestration
            return super().supports_fused_residual(lev)
        # sharded: the orchestration runs per tile with the seam exchange
        # (the emitted-residual patches recompute the one halo-reading row
        # and column per quad fresh from the post-sweep extension, right
        # under both the mirror and the seam exchange).  Not under
        # fused_bands_bf16: the smoother's gather is then of the perturbed
        # operator, as on the single-device path (the JAX package's
        # shard_map backend omits this exclusion)
        return (self.cfg.fused_residual and self.cfg.relax_kind == "RB"
                and self.state_quads(lev) and not self.cfg.fused_bands_bf16)

    def supports_fused_rr(self, lev: int) -> bool:
        if not self._sharded(lev):
            return super().supports_fused_rr(lev)
        if lev + 1 >= self.nlevs:
            return False
        return (self.supports_fused_residual(lev) and self._same_axes(lev)
                and self.levels[lev].nzg % 2 == 0)

    def relax_residual(self, lev, p, b, nsweeps):
        if not self._sharded(lev):
            return super().relax_residual(lev, p, b, nsweeps)
        ext = self._ext(lev)

        def local(pq, bq, pack_l):
            q, rq = kernels.relax_residual_tiled_quads(
                pq.asdict(), bq.asdict(), pack_l, nsweeps, extend_fn=ext)
            return QuadField.fromdict(q), QuadField.fromdict(rq)

        return self._map(lev, local, p, b, self.packs[lev])

    def relax_residual_restrict(self, lev, p, b, nsweeps,
                                as_quads: bool = False):
        if not self._sharded(lev):
            return super().relax_residual_restrict(lev, p, b, nsweeps,
                                                   as_quads=as_quads)
        ext = self._ext(lev)

        def local(pq, bq, pack_l):
            q, full_c = kernels.relax_residual_restrict_tiled_quads(
                pq.asdict(), bq.asdict(), pack_l, nsweeps, extend_fn=ext)
            # coarse tiles are even whenever the coarse level is
            # quad-persistent, so the local split IS the global split
            return (QuadField.fromdict(q),
                    QuadField.split(full_c) if as_quads else full_c)

        return self._map(lev, local, p, b, self.packs[lev])

    def relax(self, lev, p, b, nsweeps):
        if not self._sharded(lev):
            return super().relax(lev, p, b, nsweeps)
        if is_quads(p):
            return self._relax_quads_shard(lev, p, b, nsweeps)
        if self._use_compact_shard(lev):
            # full-layout state on a compact level (the coarsest): K1 per
            # tile on its persisted pack
            ext = self._ext(lev)
            return self._map(lev, lambda p_l, b_l, pack_l:
                             kernels.relax_compact_tiled(
                                 p_l, b_l, pack_l, nsweeps,
                                 kind=self.cfg.relax_kind, extend_fn=ext),
                             p, b, self.packs[lev])
        # the masked relax per tile, every route of it (K6 and gs_exact
        # have no per-tile form: the JAX package's shard_map layer runs
        # the masked relax on its sharded levels)
        return self._relax_tiles(lev, p, b, nsweeps)

    # -- residual -------------------------------------------------------------
    def _use_tiled_residual_shard(self, lev) -> bool:
        """K5 on a sharded full-layout level: the single-device rule
        (``pallas_tiled``, 3-D, at least 256 wide) on the local tile."""
        return (self.cfg.pallas_tiled and self.levels[lev].nd == 8
                and self.plan.shards[lev].nx >= 256)

    def residual(self, lev, p, b):
        if self._sharded(lev) and is_quads(p):
            return self._residual_quads_shard(lev, p, b)
        if not self._sharded(lev):
            return super().residual(lev, p, b)
        return self._residual_tiles(lev, p, b,
                                    self._use_tiled_residual_shard(lev))

    def _residual_quads_shard(self, lev, p, b):
        """r = b - A p in quad layout on a sharded level (per tile, with the
        seam extension)."""
        real, ext = self.real, self._ext(lev)
        return self._map(lev, lambda pq, bq, pack_l: QuadField.fromdict(
            residual_quads(pq.asdict(), bq.asdict(), pack_l, real,
                           extend_fn=ext)), p, b, self.packs[lev])

    def residual_restrict(self, lev, p, b, as_quads: bool = False):
        """Fused residual + restrict (K3 per target quad) on the tiles when
        the coarse level keeps the same active axes.  Stage transitions
        take the quad residual and :meth:`restrict`, which carries the
        re-layout; replicated levels the single-device path."""
        if not self._sharded(lev):
            return super().residual_restrict(lev, p, b, as_quads=as_quads)
        # quad state is what a compact level with a pack holds above the
        # coarsest level, the only levels with a residual_restrict
        fused_ok = (is_quads(p) and self._same_axes(lev)
                    and self.levels[lev].nzg % 2 == 0)
        if not fused_ok:
            return self.restrict(lev, self.residual(lev, p, b),
                                 as_quads=as_quads)
        ext = self._ext(lev)

        def local(p_l, b_l, pack_l):
            full_c = kernels.residual_restrict_tiled_quads(
                p_l.asdict(), b_l.asdict(), pack_l, extend_fn=ext)
            # coarse tiles are even whenever the coarse level is
            # quad-persistent, so the local split IS the global split
            return QuadField.split(full_c) if as_quads else full_c

        return self._map(lev, local, p, b, self.packs[lev])

    # -- transfers ------------------------------------------------------------
    # restrict and prolong: DistributedBackend's (per tile where the two
    # levels keep the same active axes, one join and split at each stage
    # transition).
