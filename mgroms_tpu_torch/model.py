"""Public API: the nonhydrostatic pressure solver a host ocean model calls.

Port of the single-device part of ``mgroms_tpu/model.py`` (reference
``src/nhydro.f90``):

  nhydro_init      -> NHModel(nx, ny, nz, cfg, device)   (nhydro.f90:18-33)
  nhydro_matrices  -> NHModel.set_matrices(...)          (:36-50)
  nhydro_solve     -> NHModel.solve(...)                 (:53-102)
  nhydro_check_nondivergence -> NHModel.check_nondivergence(...) (:105-134)

and ``NHModel.distribute`` (the reference's 2-D horizontal decomposition,
npxg x npyg) over a mesh of devices driven from this one process
(mgroms_tpu_torch/parallel).

:meth:`NHModel.offload_metrics` moves the fine-level metrics (the inputs
of rhs and the projection, not of the pressure solve) to host memory, as
the JAX package's timed scripts do before they time a solve; the next
rhs, project, check_nondivergence or distribute brings them back
(:meth:`NHModel._metrics_live`).

Velocity layout (z leading): u (nz, ny+2, nx+1), v (nz, ny+1, nx+2),
w (nz+1, ny+2, nx+2).  Every tensor the model creates takes its device and
``cfg.dtype``; inputs are converted to them.

With ``cfg.netcdf_output`` the model writes the reference's stage dumps
into ``cfg.output_dir`` (io/diagnostics.py): the metrics and every
level's operator at :meth:`NHModel.set_matrices`, the RHS in
:meth:`NHModel.solve`, the divergence in
:meth:`NHModel.check_nondivergence`; solver.solve_p writes the iterates.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .assembly import FineMetrics, build_operators
from .bc import extend_h1
from .config import SolverConfig
from .io.diagnostics import write_field
from .levels import build_level_plan, describe
from .ops.projection import correct_uvw
from .ops.kernels.rhs_fused import rhs_fused
from .parallel.mesh import Tiles
from .solver import SingleDeviceBackend, SolveInfo, _solve_p, solve_p
from .utils.tictoc import span


class NHModel:
    """Geometric-multigrid solver for the nonhydrostatic pressure Poisson
    equation on a terrain-following ocean grid, on one torch device."""

    def __init__(self, nx: int, ny: int, nz: int,
                 cfg: Optional[SolverConfig] = None, device="cuda",
                 verbose: bool = False):
        self.cfg = cfg or SolverConfig()
        self.device = torch.device(device)
        self.levels = build_level_plan(nx, ny, nz,
                                       aggressive=self.cfg.aggressive)
        self.nx, self.ny, self.nz = nx, ny, nz
        self.backend: Optional[SingleDeviceBackend] = None
        self.metrics: Optional[FineMetrics] = None
        self._metrics_offloaded = False
        if verbose:
            print(describe(self.levels))

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def tensor(self, a) -> torch.Tensor:
        """``a`` (numpy array, tensor or scalar) as a contiguous tensor of
        the model's dtype on its device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype).contiguous()
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
        if self.cfg.netcdf_output:
            # the metrics and one cA per level, as the reference writes
            # them in define_matrices (mg_define_matrix.f90:187-194,
            # :668-673; iteration = 1-based level)
            for name in ("dx", "dy", "zr", "zw"):
                self._dump(getattr(metrics, name), name, f"{name}.nc", 1)
            for lev, op in enumerate(ops):
                self._dump(op.cA, "ca", "cA.nc", lev + 1)

    def _dump(self, x, vname: str, fname: str, iteration=None) -> None:
        """One diagnostics dump into ``cfg.output_dir`` (rank 0)."""
        write_field(x, vname, os.path.join(self.cfg.output_dir, fname),
                    rank=0, iteration=iteration)

    def use_operators(self, ops, metrics: FineMetrics, packs=None) -> None:
        """Install assembled operators (and optionally prebuilt packs) —
        :meth:`set_matrices`'s last step, also the entry for operators
        carried over from elsewhere (mgroms_tpu_torch.convert)."""
        self.ops = ops
        self.metrics = metrics
        self._metrics_offloaded = False
        self._physics = None
        # the old backend's CUDA graphs (capture.py) hold its operators'
        # pointers: they go with it, before the new packs are built
        self.backend = None
        self.backend = SingleDeviceBackend(self.levels, ops, self.cfg,
                                           packs=packs)

    def distribute(self, npx: int, npy: int, devices=None,
                   comm: str = "auto") -> None:
        """Distribute the solve over an (npx, npy) device mesh — the
        reference's 2-D horizontal domain decomposition (npxg x npyg,
        nhydro_init, nhydro.f90:18).  Call after :meth:`set_matrices`.
        ``devices`` (default: every visible CUDA device) may repeat a
        device: ``["cuda:0"] * 4`` is a virtual 2x2 mesh on one card.

        ``comm`` selects the communication layer:

        - 'gspmd': the operators replicated once on each distinct device,
          the partitioned ops per tile, the others on the gathered level
          (parallel/backend.py);
        - 'shard_map': explicit halo exchange, per-tile operators
          (parallel/shardmap_backend.py);
        - 'auto' (default): resolves as the JAX package does
          (parallel.shardmap_backend.default_comm): 'shard_map' wherever a
          sharded level can smooth in quad-parity form, else 'gspmd'.

        Distributes the whole solve: rhs, project and check_nondivergence
        run per tile too (parallel/physics.py).  The single-device packs
        of the sharded levels are freed, and under 'shard_map' their
        operators once cut into tiles."""
        from .parallel import (DistributedBackend, DistributedPhysics,
                               MeshPlan, ShardMapBackend, make_mesh,
                               shard_operators, shard_operators_blocked)
        from .parallel.mesh import move
        from .parallel.shardmap_backend import (default_comm,
                                                shard_packs_blocked)
        self._require()
        mesh = make_mesh(npx, npy, devices)
        plan = MeshPlan.create(mesh, self.levels, nsmall=self.cfg.nsmall)
        if comm == "auto":
            comm = default_comm(self.levels, plan, self.cfg)
        if comm not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown comm layer {comm!r}")
        # replicated (agglomerated) levels keep their packs, on the mesh's
        # first device; sharded levels hold none under GSPMD (full layout
        # there) and build per-tile packs under shard_map
        packs = [None if (pk is None or plan.shards[lev].sharded)
                 else move(pk, mesh.first)
                 for lev, pk in enumerate(self.backend.packs)]
        self.backend = None
        if comm == "gspmd":
            backend = DistributedBackend(self.levels,
                                         shard_operators(self.ops, plan),
                                         self.cfg, plan, packs=packs)
        else:
            backend = ShardMapBackend(self.levels,
                                      shard_operators_blocked(self.ops,
                                                              plan),
                                      self.cfg, plan, packs=packs)
            spk = shard_packs_blocked(self.levels, backend.ops, self.cfg,
                                      plan, backend)
            backend.packs = [s if s is not None else packs[lev]
                             for lev, s in enumerate(spk)]
        self.ops = backend.ops
        self.backend = backend
        self.device = mesh.first
        self._physics = DistributedPhysics(plan, self._metrics_live(),
                                           self.cfg)

    @property
    def distributed(self) -> bool:
        return getattr(self, "_physics", None) is not None

    def _require(self) -> FineMetrics:
        if self.metrics is None:
            raise RuntimeError("call set_matrices first")
        return self.metrics

    def offload_metrics(self) -> int:
        """Move the fine-level metric fields (the rhs and projection
        inputs: 6 nz-deep fields and 5 planes of (ny+2) x (nx+2) values)
        to host memory, pinned where the model is on the card, freeing
        device memory for the solve (mgroms_tpu/model.py:168-175).  The
        pressure solve does not read them; rhs, project,
        check_nondivergence and distribute bring them back first
        (:meth:`_metrics_live`).  Returns the bytes moved."""
        mt = self._require()
        pin = self.device.type == "cuda"

        def host(t):
            h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                            pin_memory=pin)
            h.copy_(t)
            return h

        self.metrics = FineMetrics(*(host(t) for t in mt))
        self._metrics_offloaded = True
        return sum(t.numel() * t.element_size() for t in self.metrics)

    def _metrics_live(self) -> FineMetrics:
        """The metrics on the model's device, brought back first where
        :meth:`offload_metrics` moved them (mgroms_tpu/model.py:177-188)."""
        mt = self._require()
        if self._metrics_offloaded:
            self.metrics = FineMetrics(*(t.to(self.device, non_blocking=True)
                                         for t in mt))
            self._metrics_offloaded = False
        return self.metrics

    # -- pieces ------------------------------------------------------------
    def rhs(self, u, v, w) -> torch.Tensor:
        if self.distributed:
            return self.backend.gather(0, self._rhs_state(u, v, w))
        with span("rhs", self.backend):
            return rhs_fused(self._metrics_live(), self.tensor(u),
                             self.tensor(v), self.tensor(w), self.cfg.bmask)

    def _state(self, x):
        """``x`` as a tensor of the model, unless it is already a tile grid
        of a distributed state (parallel.mesh.Tiles)."""
        return x if isinstance(x, Tiles) else self.tensor(x)

    def _rhs_state(self, u, v, w):
        """b in level 0's layout (its tiles when distributed)."""
        if not self.distributed:
            return self.rhs(u, v, w)
        with span("rhs", self.backend):
            b = self._physics.rhs(self.tensor(u), self.tensor(v),
                                  self.tensor(w))
        return self.backend.place(0, b)

    def _solve_state(self, b, tol, maxiter, verbose, graph):
        """solve_p's pressure in level 0's placement (its tiles when
        distributed, which project takes as they are)."""
        self._require()
        return _solve_p(self.backend, self.backend.place(0, self._state(b)),
                        self.cfg, tol=tol, maxiter=maxiter, verbose=verbose,
                        graph=graph)

    def pressure_solve(self, b, tol=None, maxiter=None, verbose=False,
                       graph: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, SolveInfo]:
        """solve_p on the model's backend (``graph``: solver.solve_p): the
        global pressure."""
        self._require()
        return solve_p(self.backend, self._state(b), self.cfg, tol=tol,
                       maxiter=maxiter, verbose=verbose, graph=graph)

    def project(self, p, u, v, w):
        with span("project", self.backend):
            if self.distributed:
                return self._physics.project(
                    self._state(p), self.tensor(u), self.tensor(v),
                    self.tensor(w))
            return correct_uvw(self._metrics_live(),
                               extend_h1(self.tensor(p)), self.tensor(u),
                               self.tensor(v), self.tensor(w))

    # -- the reference's three-step solve (nhydro.f90:80-98) ---------------
    def solve(self, u, v, w, tol=None, maxiter=None, verbose=False,
              graph: Optional[bool] = None):
        """compute_rhs -> solve_p -> correct_uvw.  Returns corrected
        (u, v, w), the pressure p, and a SolveInfo.  On the card the solve
        replays its step as a CUDA graph; ``graph=False`` runs the eager
        loop (solver.solve_p).  With spans on (utils/tictoc.record_spans)
        the call is a ``step`` span over ``rhs``, ``solve`` and
        ``project``."""
        with span("step"):
            u, v, w = self.tensor(u), self.tensor(v), self.tensor(w)
            b = self._rhs_state(u, v, w)
            if self.cfg.netcdf_output:               # nhydro.f90:85-87
                self._dump(self.backend.gather(0, b), "b", "b.nc", 1)
            p, info = self._solve_state(b, tol, maxiter, verbose, graph)
            u, v, w = self.project(p, u, v, w)
            return u, v, w, self.backend.gather(0, p), info

    def check_nondivergence(self, u, v, w) -> torch.Tensor:
        """max |div| of the corrected velocities
        (nhydro_check_nondivergence, nhydro.f90:105-134)."""
        if self.distributed:
            return self._physics.check_nondivergence(
                self.tensor(u), self.tensor(v), self.tensor(w))
        div = self.rhs(u, v, w)
        if self.cfg.netcdf_output:                   # nhydro.f90:130-132
            self._dump(div, "b", "check.nc", 1)
        return torch.max(torch.abs(div))
