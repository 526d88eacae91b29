"""Public API: the nonhydrostatic pressure solver a host ocean model calls.

Port of the single-device part of ``mgroms_tpu/model.py`` (reference
``src/nhydro.f90``):

  nhydro_init      -> NHModel(nx, ny, nz, cfg, device)   (nhydro.f90:18-33)
  nhydro_matrices  -> NHModel.set_matrices(...)          (:36-50)
  nhydro_solve     -> NHModel.solve(...)                 (:53-102)
  nhydro_check_nondivergence -> NHModel.check_nondivergence(...) (:105-134)

Velocity layout (z leading): u (nz, ny+2, nx+1), v (nz, ny+1, nx+2),
w (nz+1, ny+2, nx+2).  Every tensor the model creates takes its device and
``cfg.dtype``; inputs are converted to them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .assembly import FineMetrics, build_operators
from .bc import extend_h1
from .config import SolverConfig
from .levels import build_level_plan, describe
from .ops.projection import correct_uvw
from .ops.rhs import compute_rhs
from .solver import SingleDeviceBackend, SolveInfo, check_supported, solve_p


class NHModel:
    """Geometric-multigrid solver for the nonhydrostatic pressure Poisson
    equation on a terrain-following ocean grid, on one torch device."""

    def __init__(self, nx: int, ny: int, nz: int,
                 cfg: Optional[SolverConfig] = None, device="cuda",
                 verbose: bool = False):
        self.cfg = cfg or SolverConfig()
        self.device = torch.device(device)
        check_supported(self.cfg, self.device.type == "cuda")
        self.levels = build_level_plan(nx, ny, nz,
                                       aggressive=self.cfg.aggressive)
        self.nx, self.ny, self.nz = nx, ny, nz
        self.backend: Optional[SingleDeviceBackend] = None
        self.metrics: Optional[FineMetrics] = None
        if verbose:
            print(describe(self.levels))

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def tensor(self, a) -> torch.Tensor:
        """``a`` (numpy array, tensor or scalar) as a tensor of the model's
        dtype on its device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def set_matrices(self, dx, dy, zeta, h, rmask=None,
                     hc: float = 0.0, theta_b: float = 0.0,
                     theta_s: float = 0.0) -> None:
        """Assemble all levels from topography (nhydro_matrices,
        nhydro.f90:36-50) and persist the quad-parity smoother packs.
        Inputs are interior (ny, nx) arrays."""
        if rmask is None:
            rmask = np.ones((self.ny, self.nx))
        ops, metrics = build_operators(
            self.levels, self.tensor(dx), self.tensor(dy),
            self.tensor(zeta), self.tensor(h), self.tensor(rmask),
            hc, theta_b, theta_s, self.cfg)
        self.use_operators(ops, metrics)

    def use_operators(self, ops, metrics: FineMetrics, packs=None) -> None:
        """Install assembled operators (and optionally prebuilt packs) —
        :meth:`set_matrices`'s last step, also the entry for operators
        carried over from elsewhere (mgroms_tpu_torch.convert)."""
        self.ops = ops
        self.metrics = metrics
        self.backend = SingleDeviceBackend(self.levels, ops, self.cfg,
                                           packs=packs)

    def _require(self) -> FineMetrics:
        if self.metrics is None:
            raise RuntimeError("call set_matrices first")
        return self.metrics

    # -- pieces ------------------------------------------------------------
    def rhs(self, u, v, w) -> torch.Tensor:
        return compute_rhs(self._require(), self.tensor(u), self.tensor(v),
                           self.tensor(w), self.cfg.bmask)

    def pressure_solve(self, b, tol=None, maxiter=None, verbose=False
                       ) -> Tuple[torch.Tensor, SolveInfo]:
        self._require()
        return solve_p(self.backend, self.tensor(b), self.cfg, tol=tol,
                       maxiter=maxiter, verbose=verbose)

    def project(self, p, u, v, w):
        return correct_uvw(self._require(), extend_h1(self.tensor(p)),
                           self.tensor(u), self.tensor(v), self.tensor(w))

    # -- the reference's three-step solve (nhydro.f90:80-98) ---------------
    def solve(self, u, v, w, tol=None, maxiter=None, verbose=False):
        """compute_rhs -> solve_p -> correct_uvw.  Returns corrected
        (u, v, w), the pressure p, and a SolveInfo."""
        u, v, w = self.tensor(u), self.tensor(v), self.tensor(w)
        b = self.rhs(u, v, w)
        p, info = self.pressure_solve(b, tol=tol, maxiter=maxiter,
                                      verbose=verbose)
        u, v, w = self.project(p, u, v, w)
        return u, v, w, p, info

    def check_nondivergence(self, u, v, w) -> torch.Tensor:
        """max |div| of the corrected velocities
        (nhydro_check_nondivergence, nhydro.f90:105-134)."""
        return torch.max(torch.abs(self.rhs(u, v, w)))
