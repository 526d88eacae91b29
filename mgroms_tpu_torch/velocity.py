"""Staggered velocity-array utilities.

Port of ``mgroms_tpu/velocity.py`` (reference
``src/mg_mpi_exchange_ijk.f90``, ``fill_halo_ijk``): the reference fills
the halos of velocity arrays kept in the host model's (i, j, k) layout
with u/v/w staggering, for test set-up.  What remains here is the
physical-edge fill and the shape adaptation for standalone use; the
tensors stay on their device.

Array shapes (see ops/rhs.py):
  u: (nz, ny+2, nx+1), v: (nz, ny+1, nx+2), w: (nz+1, ny+2, nx+2)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _edge_pad(x: torch.Tensor, pad_j: int, pad_i: int) -> torch.Tensor:
    """``x`` with ``pad_j`` rows and ``pad_i`` columns added on both sides
    of its last two dims, copies of the edge (numpy's ``mode="edge"``)."""
    y = F.pad(x[None], (pad_i, pad_i, pad_j, pad_j), mode="replicate")
    return y[0]


def velocities_from_interior(ui: torch.Tensor, vi: torch.Tensor,
                             wi: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Build solver-layout velocity arrays from interior-only fields.

    Inputs: ui (nz, ny, nx+1) u-faces, vi (nz, ny+1, nx) v-faces,
    wi (nz+1, ny, nx) w-faces.  Halo rows/columns are filled with the
    zero-gradient (edge-copy) rule — the value a host model's own halo
    exchange would leave at a physical boundary.
    """
    return _edge_pad(ui, 1, 0), _edge_pad(vi, 0, 1), _edge_pad(wi, 1, 1)


def fill_velocity_halos(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Overwrite the physical-edge halos of solver-layout arrays with the
    edge-copy rule (fill_halo_ijk's MPI_PROC_NULL branch).  Returns new
    tensors; the arguments are not changed."""
    u, v, w = u.clone(), v.clone(), w.clone()
    u[:, 0, :] = u[:, 1, :]
    u[:, -1, :] = u[:, -2, :]
    v[:, :, 0] = v[:, :, 1]
    v[:, :, -1] = v[:, :, -2]
    w[:, 0, :] = w[:, 1, :]
    w[:, -1, :] = w[:, -2, :]
    w[:, :, 0] = w[:, :, 1]
    w[:, :, -1] = w[:, :, -2]
    return u, v, w
