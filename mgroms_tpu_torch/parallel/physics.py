"""Distributed physics coupling: RHS, projection, nondivergence check.

Port of ``mgroms_tpu/parallel/physics.py``.  The reference's
``nhydro_solve`` is distributed end to end: compute_rhs and correct_uvw
run on per-rank staggered velocity tiles with the halo exchange and the
``lbc_null`` wall-flux Dirichlet folded into the fill
(mg_compute_rhs.f90:170-172,291-293; mg_mpi_exchange.f90:952-1013).
Here the fine-level metrics and the velocities are cut into per-tile
staggered tiles (overlaps included — the blocks of
exchange.block_overlapped), and the flux and projection code runs
unchanged on each tile inside shard_map, with per-tile face masks from the
mesh position (exchange.shard_face_masks).  Every tile computes what the
global functions compute on the same values, so the distributed RHS and
projection equal their single-device counterparts.

Staggered overlap table (z leading; see ops/rhs.py layout notes):
  u (nz,   ny+2, nx+1): overlap (2, 1)
  v (nz,   ny+1, nx+2): overlap (1, 2)
  w (nz+1, ny+2, nx+2): overlap (2, 2)
  metrics  (..., ny+2, nx+2): overlap (2, 2)
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..assembly import FineMetrics
from ..config import SolverConfig
from ..ops.projection import correct_uvw
from ..ops.kernels.rhs_fused import rhs_fused
from .exchange import (block_overlapped, halo_extend, shard_face_masks,
                       unblock_overlapped)
from .mesh import MeshPlan, Tiles, join_tiles, shard_map, split_tiles

_U_OVL, _V_OVL, _W_OVL, _M_OVL = (2, 1), (1, 2), (2, 2), (2, 2)


def block_velocities(u, v, w, npy: int, npx: int):
    return (block_overlapped(u, npy, npx, *_U_OVL),
            block_overlapped(v, npy, npx, *_V_OVL),
            block_overlapped(w, npy, npx, *_W_OVL))


def unblock_velocities(ub, vb, wb, npy: int, npx: int):
    return (unblock_overlapped(ub, npy, npx, *_U_OVL),
            unblock_overlapped(vb, npy, npx, *_V_OVL),
            unblock_overlapped(wb, npy, npx, *_W_OVL))


class DistributedPhysics:
    """Distributed rhs/project/check bound to a mesh plan.

    Built by ``NHModel.distribute``; holds the per-tile metrics (each on its
    tile's device) and runs the per-tile programs on the whole (npy, npx)
    mesh.  Velocities come and go as global tensors; ``rhs`` returns the
    tiles of b and ``project`` takes the tiles of p (a global p is cut
    first)."""

    AXES = ("py", "px")

    def __init__(self, plan: MeshPlan, metrics: FineMetrics,
                 cfg: SolverConfig):
        self.plan = plan
        self.cfg = cfg
        self.npy, self.npx = plan.mesh.shape
        self.devices = plan.mesh.tile_devices(self.AXES)
        fields = [split_tiles(f, plan.mesh.shape, self.devices, _M_OVL)
                  for f in metrics]
        self.metrics = fields[0].map(lambda *fs: FineMetrics(*fs),
                                     *fields[1:])

    def _tiles(self, a, extra) -> Tiles:
        return split_tiles(a, self.plan.mesh.shape, self.devices, extra)

    def _velocity_tiles(self, u, v, w):
        return (self._tiles(u, _U_OVL), self._tiles(v, _V_OVL),
                self._tiles(w, _W_OVL))

    def _map(self, fn, *args):
        return shard_map(fn, self.plan.mesh, self.AXES)(*args)

    # -- rhs ---------------------------------------------------------------
    def rhs(self, u, v, w) -> Tiles:
        """Distributed divergence RHS: the tiles of b on the whole mesh."""
        bmask = self.cfg.bmask

        def local(mt, u_l, v_l, w_l):
            ny_l = u_l.shape[1] - 2
            nx_l = u_l.shape[2] - 1
            um, vm = shard_face_masks(ny_l, nx_l, u_l.dtype)
            return rhs_fused(mt, u_l, v_l, w_l, bmask, uface_mask=um,
                             vface_mask=vm)

        return self._map(local, self.metrics, *self._velocity_tiles(u, v, w))

    # -- projection ----------------------------------------------------------
    def project(self, p, u, v, w) -> Tuple:
        """Corrected global (u, v, w) from p (its tiles on the whole mesh,
        or a global tensor)."""
        if not isinstance(p, Tiles) or p.shape != self.plan.mesh.shape:
            if isinstance(p, Tiles):
                p = join_tiles(p, self.plan.mesh.first)
            p = self._tiles(p, (0, 0))

        def local(mt, p_l, u_l, v_l, w_l):
            return correct_uvw(mt, halo_extend(p_l), u_l, v_l, w_l)

        ub, vb, wb = self._map(local, self.metrics, p,
                               *self._velocity_tiles(u, v, w))
        first = self.plan.mesh.first
        return unblock_velocities(*(join_tiles(t, first)
                                    for t in (ub, vb, wb)),
                                  self.npy, self.npx)

    # -- nondivergence check --------------------------------------------------
    def check_nondivergence(self, u, v, w) -> torch.Tensor:
        first = self.plan.mesh.first
        return torch.stack([torch.max(torch.abs(b)).to(first)
                            for b in self.rhs(u, v, w).flat()]).max()
