"""Multigrid cycle orchestration: V-cycles, F-cycles, outer solve.

Port of the single-device part of ``mgroms_tpu/solver.py`` (reference
``src/mg_solvers.f90``).  The per-level operations live on a backend
object (:class:`SingleDeviceBackend`); the cycle code is plain Python over
the levels, run eagerly, and on the card captured once as a CUDA graph
that the solve replays (capture.py, :func:`solve_p`).

Every non-coarsest level with even ny, nx of an RB or FC solve keeps its
state in quad-parity layout (``QuadField``) — the rule the JAX package
applies on the CPU (``compact_eligible``), here on every device.  On those
levels:

- relax: where :func:`fused_sweep_wanted` holds (``pallas_tiled``,
  ``pallas_fused_sweep``, RB, and the level's tensors on the card or
  ``pallas_interpret`` set — the JAX package's ``platform != "cpu" or
  pallas_interpret``), the colour-fused sweep K4
  (ops/kernels/sweep_fused.py), one launch per sweep; else one K1 launch
  per colour (ops/kernels/relax_tiled.py: RB two colours of two target
  quads, FC four colours of one);
- the down-leg residual and restriction: K3, one launch for the four
  target quads, fused with the last sweep through K2
  (``fused_residual``) on RB levels without K4 and without
  ``fused_bands_bf16``, as in the JAX package;
- the operator: on the card every quad level holds only the band stack,
  which K4, K1-K2 and K3 read (and K3 in its residual mode gives the
  level's quad residual); on the CPU the K4 levels hold the stack and the
  others the gather blocks, as the JAX package keeps them
  (:func:`band_stack_wanted`, :func:`build_relax_packs`).

With ``fused_bands_bf16`` the smoother reads the low-precision operator
(relax_compact.attach_lp: bfloat16 values beside row-sum-consistent
pivots in the state's type) where the JAX package has one: in float32 on
every quad level, read by K4 or K1; in float64 on the levels K4 smooths
(the JAX package's bfloat16 sweep bands), read by K4's (float64,
bfloat16) instance, the other levels keeping the full-precision
operator.  Residuals keep the full-precision operator, and the outer
step runs in defect-correction form (:func:`cycle_step`).

The other levels (the coarsest, every level of a GS solve, or every level
with ``compact=False``) are held in full layout:

- relax: with ``use_pallas`` the K6 kernel in the solve's ordering
  (ops/kernels/relax_fused.py, :meth:`SingleDeviceBackend._use_pallas`),
  else the masked relax of ops/relax.py;
- residual: on levels at least 256 wide with ``pallas_tiled`` the K5
  kernel (ops/kernels/stencil_tiled.py,
  :meth:`SingleDeviceBackend._use_tiled`), else ops/stencil.residual.

The gates keep the JAX package's rules that define the paths and drop
its TPU-only ones: a wrapper takes its plain version on the CPU instead
of a platform test, and ``fits_vmem``, the Mosaic tile budgets
(``stencil_tiled.supports``, ``sweep_fused.supports``) and the K1 tile
gate of bfloat16 blocks have no counterpart (the kernels take any shape).
The glue between kernels (quad halo extension, the emitted-residual
patch, restriction, prolongation) is plain torch.

The secondary modes of the JAX package, none of which has a kernel of its
own:

- ``coarsest='direct'``: the coarsest level is solved by one product with
  the dense inverse its operator carries (``LevelOperator.Ainv``,
  assembly.dense_inverse), checked before every other relax route;
- ``tridiag='pcr'``: the masked relax of the full-layout levels (the
  coarsest) solves its columns by parallel cyclic reduction.  As in the
  JAX package, whose accelerator gates do not read ``tridiag``, the
  kernels keep Thomas: the levels K4, K1-K2 and K6 smooth (on the CPU
  their plain versions) stay on Thomas, on either device.  The CPU route
  is the card's, held to the JAX package run with ``pallas_interpret``
  (its CPU route without it solves every quad level by PCR);
- ``gs_exact`` with GS: the order-exact sequential sweep
  (ops/relax.relax_gs_exact) on every level, routed before K6; such a
  solve runs eagerly (:func:`graph_wanted`);
- ``aggressive``: the 8:1 z-restriction and its transfer routing; both
  packages refuse the assembly of such a plan;
- ``netcdf_output``: the per-iteration and end-of-solve dumps of
  :func:`solve_p` (io/diagnostics.py);
- the diagnostics :func:`vcycle2`, :func:`dot` and :func:`testgalerkin`.

Config fields read: the reference's (``ns_*``, ``cmatrix``,
``relax_method``, ``interp_type``, ``coarsest``, ``tridiag``,
``gs_exact``, ...), ``dtype``, ``compact``, ``use_pallas``,
``pallas_tiled``, ``pallas_fused_sweep``, ``pallas_interpret``,
``fused_bands_bf16`` and ``fused_residual``.  Not read:
``pallas_tiled_relax`` and ``fused_sweep_chunks`` (Mosaic tiles and lane
chunks have no GPU counterpart).
"""

from __future__ import annotations

import math
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

from .assembly import LevelOperator
from .bc import extend_h1
from .config import SolverConfig
from .io.diagnostics import write_field
from .levels import LevelSpec
from .ops import relax as relax_ops
from .ops import stencil, transfer
from .ops.kernels import device_loop as loop_condition
from .ops.kernels import relax_fused, stencil_tiled, sweep_fused
from .ops.kernels import relax_tiled as kernels
from .ops.relax_compact import (QuadField, attach_lp, build_band_pack,
                                build_compact_pack, residual_quads,
                                restrict_quads_to_full)
from .utils.tictoc import span


def fused_sweep_wanted(cfg: SolverConfig, on_card: bool) -> bool:
    """The colour-fused sweep K4 smooths the quad levels: the JAX package's
    rule, with "the level's tensors are on the card" for its
    ``platform != "cpu"``."""
    return (cfg.pallas_tiled and cfg.pallas_fused_sweep
            and cfg.relax_kind == "RB"
            and (on_card or cfg.pallas_interpret))


def gs_exact_wanted(cfg: SolverConfig) -> bool:
    """The order-exact sequential GS sweep smooths every level."""
    return cfg.relax_kind == "GS" and cfg.gs_exact


def compact_eligible(spec: LevelSpec, cfg: SolverConfig) -> bool:
    """Quad-parity compact relax eligibility: 3-D levels of an RB or FC
    solve with even ny, nx (the JAX package's CPU rule, on every device;
    its accelerator gate, quad tiles >= 128 wide for the TPU's vector
    registers, has no counterpart on the card).  GS has no quad form."""
    return (cfg.compact and spec.nd == 8
            and cfg.relax_kind in ("RB", "FC")
            and spec.nyg % 2 == 0 and spec.nxg % 2 == 0)


def band_stack_wanted(cfg: SolverConfig, on_card: bool) -> bool:
    """A quad level holds its gather operator as the band stack only
    (relax_compact.build_band_pack), no gather blocks: on the card every
    quad level (K4, K1-K2 and K3 read the stack in place), on the CPU the
    levels K4 smooths (:func:`fused_sweep_wanted`) — the JAX package's K1
    reads the gather blocks, and the CPU parity tests hold the port to
    it.  The tiles of a distributed level take the same rule."""
    return on_card or fused_sweep_wanted(cfg, on_card)


def build_relax_packs(levels, ops, cfg: SolverConfig) -> list:
    """Persisted operators (CompactPack) for the quad-persistent levels
    (every compact-eligible level but the coarsest); None elsewhere.  Built
    level by level, so only one level's quad-sampled band temporaries
    exist at a time.

    Where :func:`band_stack_wanted` holds the gather operator is held only
    as the 24 band quads (relax_compact.build_band_pack): the kernels and
    the plain versions read it, and no gather blocks are built (3.2 GB at
    CUC level 0 in float32).  Elsewhere it is held as the gather blocks
    (relax_compact.build_compact_pack).

    With ``fused_bands_bf16`` a pack also carries the low-precision
    smoother operator (``pack.lp``) in the layout of its own (bfloat16
    blocks, or a bfloat16 band stack beside the full-precision one that
    the residuals read) where the JAX package builds one
    (mgroms_tpu/solver.py:87-101): on every quad level for a state of at
    most 4 bytes, and for a float64 state on the levels K4 smooths (its
    ``build_sweep_operator(..., band_dtype=bfloat16)`` levels), which hold
    the band stack."""
    small = getattr(torch, cfg.dtype).itemsize <= 4
    real = cfg.cmatrix == "real"
    packs = []
    for lev, spec in enumerate(levels):
        pack = None
        if lev < len(levels) - 1 and compact_eligible(spec, cfg):
            cA = ops[lev].cA
            build = (build_band_pack if band_stack_wanted(cfg, cA.is_cuda)
                     else build_compact_pack)
            pack = build(cA, real)
            if cfg.fused_bands_bf16 and (
                    small or fused_sweep_wanted(cfg, cA.is_cuda)):
                pack = attach_lp(pack)
        packs.append(pack)
    return packs


def is_quads(x) -> bool:
    """A level state in quad-parity layout: a QuadField, or the tiles of
    one on a sharded level (parallel/mesh.Tiles)."""
    return isinstance(x, QuadField) or getattr(x, "is_quads", False)


class SingleDeviceBackend:
    """All per-level ops on one device (physical BCs on every edge)."""

    # its solves on the card replay a captured step (capture.py)
    capturable = True

    def __init__(self, levels: List[LevelSpec], ops: List[LevelOperator],
                 cfg: SolverConfig, packs: Optional[list] = None,
                 on_card: Optional[bool] = None):
        # (a backend built to read its gates may hold no operators)
        self.on_card = (on_card if on_card is not None
                        else ops[0] is not None and ops[0].cA.is_cuda)
        self.levels = tuple(levels)
        self.ops = list(ops)
        self.cfg = cfg
        self.nlevs = len(levels)
        self.real = cfg.cmatrix == "real"
        self.packs = (list(packs) if packs is not None
                      else build_relax_packs(levels, ops, cfg))
        self.fused_sweep = fused_sweep_wanted(cfg, self.on_card)
        # captured steps and device loops (capture.py), built at the first
        # solve that replays them
        self.graphs = {}

    def extend(self, lev: int, x: torch.Tensor) -> torch.Tensor:
        return extend_h1(x)

    # -- quad-persistent state ---------------------------------------------
    def state_quads(self, lev: int) -> bool:
        """Levels whose V-cycle state stays in quad-parity layout: every
        level with a pack but the coarsest (which runs the masked relax)."""
        return lev < self.nlevs - 1 and self.packs[lev] is not None

    def _use_sweep(self, lev: int) -> bool:
        """The quad levels smoothed by K4 (the JAX package's levels with a
        fused-sweep operator, minus its VMEM gate): every quad-persistent
        level where :func:`fused_sweep_wanted` holds."""
        return self.fused_sweep and self.state_quads(lev)

    def to_state(self, lev: int, x):
        if self.state_quads(lev) and not isinstance(x, QuadField):
            return QuadField.split(x)
        return x

    def to_full(self, lev: int, x):
        return x.merge() if isinstance(x, QuadField) else x

    def place(self, lev: int, x):
        """``x`` in level ``lev``'s placement: on one device, as it is
        (the distributed backend cuts it into the level's tiles)."""
        return x

    def gather(self, lev: int, x):
        """Level ``lev``'s state as one full-layout tensor."""
        return self.to_full(lev, x)

    # -- smoothing / residual ----------------------------------------------
    def _use_pallas(self, lev: int) -> bool:
        """K6 on a full-layout level (JAX ``_use_pallas`` without its
        ``fits_vmem`` gate)."""
        return (self.cfg.use_pallas and self.levels[lev].nd == 8
                and getattr(torch, self.cfg.dtype).itemsize <= 4)

    def _use_tiled(self, lev: int, kind: str) -> bool:
        """K5 for ``kind == 'residual'`` on a full-layout level (JAX
        ``_use_tiled`` without its platform test and tile budget).  For
        ``kind == 'relax'`` False: the quad levels always run the quad
        kernels (K4, or K1-K2, and K3)."""
        spec = self.levels[lev]
        return (kind == "residual" and self.cfg.pallas_tiled
                and spec.nd == 8 and spec.nxg >= 256)

    def relax(self, lev: int, p, b, nsweeps: int):
        if isinstance(p, QuadField):
            if self._use_sweep(lev):
                q = sweep_fused.relax_fused_sweep(p.asdict(), b.asdict(),
                                                  self.packs[lev], nsweeps)
            else:
                q = kernels.relax_compact_tiled_quads(
                    p.asdict(), b.asdict(), self.packs[lev], nsweeps,
                    kind=self.cfg.relax_kind)
            return QuadField.fromdict(q)
        spec = self.levels[lev]
        Ainv = self.ops[lev].Ainv
        if (lev == self.nlevs - 1 and self.cfg.coarsest == "direct"
                and Ainv is not None):
            # the exact coarse solve: one (n, n) matvec replaces
            # ns_coarsest sweeps (mgroms_tpu/solver.py:213-219)
            n = spec.nzg * spec.nyg * spec.nxg
            return (Ainv @ b.reshape(n)).reshape(spec.nzg, spec.nyg,
                                                 spec.nxg)
        if spec.nd == 5:
            raise NotImplementedError(
                "2-D (nz==1) levels are unreachable under the standard plan "
                "and have no assembly path (parity with the reference)")
        kind = self.cfg.relax_kind
        if gs_exact_wanted(self.cfg):
            return relax_ops.relax_gs_exact(
                p, b, self.ops[lev].cA, nsweeps, self.real,
                extend_fn=lambda x: self.extend(lev, x))
        if self._use_pallas(lev):
            return relax_fused.fused_relax(p, b, self.ops[lev].cA, nsweeps,
                                           kind, self.real)
        return relax_ops.relax(p, b, self.ops[lev].cA, nsweeps, kind,
                               self.real,
                               extend_fn=lambda x: self.extend(lev, x),
                               tridiag_method=self.cfg.tridiag)

    def supports_fused_residual(self, lev: int) -> bool:
        """Relax at this level can emit the post-sweep residual from its
        last colour update (cfg.fused_residual, quad-persistent RB
        levels).  Not under ``fused_bands_bf16`` (the smoother's gather is
        then of the perturbed operator, not the true A) nor on K4 levels
        (they keep their one-launch sweep), as in the JAX package."""
        return (self.cfg.fused_residual and self.cfg.relax_kind == "RB"
                and self.state_quads(lev)
                and not self.cfg.fused_bands_bf16
                and not self._use_sweep(lev))

    def supports_fused_rr(self, lev: int) -> bool:
        """Fused relax + residual + restrict down-leg applicability."""
        return (self.supports_fused_residual(lev)
                and lev + 1 < self.nlevs
                and not self.levels[lev + 1].aggressive_from_prev
                and self.levels[lev].nzg % 2 == 0)

    def relax_residual(self, lev: int, p, b, nsweeps: int):
        """``nsweeps`` sweeps + the fresh post-sweep residual (p, b
        QuadFields); equal to relax then residual in exact arithmetic."""
        q, rq = kernels.relax_residual_tiled_quads(
            p.asdict(), b.asdict(), self.packs[lev], nsweeps)
        return QuadField.fromdict(q), QuadField.fromdict(rq)

    def relax_residual_restrict(self, lev: int, p, b, nsweeps: int,
                                as_quads: bool = False):
        """``nsweeps`` sweeps + coarse b = restrict(b - A p) — the V-cycle
        down-leg; equal to relax then residual_restrict in exact
        arithmetic."""
        q, full = kernels.relax_residual_restrict_tiled_quads(
            p.asdict(), b.asdict(), self.packs[lev], nsweeps)
        return (QuadField.fromdict(q),
                QuadField.split(full) if as_quads else full)

    def residual(self, lev: int, p, b):
        if isinstance(p, QuadField):
            pack = self.packs[lev]
            if pack.ebands is not None:
                # a band-stack level: K3 in its residual mode
                return QuadField.fromdict(kernels.residual_tiled_quads(
                    p.asdict(), b.asdict(), pack))
            return QuadField.fromdict(residual_quads(
                p.asdict(), b.asdict(), pack, self.real))
        pe = self.extend(lev, p)
        if self._use_tiled(lev, "residual"):
            return stencil_tiled.residual_tiled(pe, b, self.ops[lev].cA,
                                                self.real)
        return stencil.residual(pe, b, self.ops[lev].cA, self.real)

    # -- transfers ---------------------------------------------------------
    def restrict(self, lev: int, r, as_quads: bool = False):
        """grid(lev)%r -> grid(lev+1)%b (fine2coarse, mg_intergrids.f90:16);
        8:1 in z alone where level ``lev + 1`` is aggressively coarsened
        (the quads are then independent in (y, x))."""
        aggressive = self.levels[lev + 1].aggressive_from_prev
        if isinstance(r, QuadField):
            if aggressive:
                out = QuadField(transfer.restrict_aggressive(q)
                                for q in r.quads)
                return out if as_quads else out.merge()
            full = restrict_quads_to_full(r.asdict())
        else:
            full = transfer.restrict(r, aggressive=aggressive)
        return QuadField.split(full) if as_quads else full

    def residual_restrict(self, lev: int, p, b, as_quads: bool = False):
        """Coarse b = restrict(b - A p) — the V-cycle down-leg pair
        (mg_solvers.f90:137-140); one K3 launch for the four target quads
        on quad-persistent levels with even nz."""
        if (isinstance(p, QuadField) and self.levels[lev].nzg % 2 == 0
                and not self.levels[lev + 1].aggressive_from_prev):
            full = kernels.residual_restrict_tiled_quads(
                p.asdict(), b.asdict(), self.packs[lev])
            return QuadField.split(full) if as_quads else full
        return self.restrict(lev, self.residual(lev, p, b),
                             as_quads=as_quads)

    def prolong(self, lev: int, pc, as_quads: bool = False):
        """grid(lev+1)%p -> correction on lev (coarse2fine, :167-228)."""
        pce = self.extend(lev + 1, self.to_full(lev + 1, pc))
        out = transfer.prolong(
            pce, self.levels[lev].nzg, self.cfg.interp_type,
            aggressive=self.levels[lev + 1].aggressive_from_prev,
            as_quads=as_quads)
        return QuadField.fromdict(out) if as_quads else out

    def synchronize(self) -> None:
        """Wait for the device's queued work (the solve's end)."""
        if self.on_card:
            torch.cuda.synchronize(self.ops[0].cA.device)

    # -- reductions --------------------------------------------------------
    def norm_sq(self, lev: int, x) -> torch.Tensor:
        if isinstance(x, QuadField):
            return sum(torch.sum(q * q) for q in x.quads)
        return torch.sum(x * x)

    def zeros(self, lev: int, as_quads: bool = False):
        s = self.levels[lev]
        cA = self.ops[lev].cA
        if as_quads:
            return QuadField(cA.new_zeros((s.nzg, s.nyg // 2, s.nxg // 2))
                             for _ in range(4))
        return cA.new_zeros((s.nzg, s.nyg, s.nxg))


def _fused_rr_ok(backend, lev: int, nsweeps: int, p) -> bool:
    return (nsweeps >= 1 and is_quads(p)
            and backend.supports_fused_rr(lev))


def _fused_res_ok(backend, lev: int, nsweeps: int, p) -> bool:
    return (nsweeps >= 1 and is_quads(p)
            and backend.supports_fused_residual(lev))


def vcycle(backend, ps: list, bs: list, top: int, cfg: SolverConfig,
           emit_top_residual: bool = False):
    """One V-cycle from level ``top`` down (``Vcycle``,
    mg_solvers.f90:129-151).  Returns ``(ps, r_top)`` — ``r_top`` is the
    fresh level-``top`` residual when ``emit_top_residual`` and the
    backend fuses it into the final post-smoothing sweep, else None."""
    L = backend.nlevs
    q = backend.state_quads
    for lev in range(top, L - 1):
        if _fused_rr_ok(backend, lev, cfg.ns_pre, ps[lev]):
            ps[lev], bs[lev + 1] = backend.relax_residual_restrict(
                lev, ps[lev], bs[lev], cfg.ns_pre, as_quads=q(lev + 1))
        else:
            ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_pre)
            bs[lev + 1] = backend.residual_restrict(
                lev, ps[lev], bs[lev], as_quads=q(lev + 1))
        ps[lev + 1] = backend.zeros(lev + 1, as_quads=q(lev + 1))
    ps[L - 1] = backend.relax(L - 1, ps[L - 1], bs[L - 1], cfg.ns_coarsest)
    r_top = None
    for lev in range(L - 2, top - 1, -1):
        ps[lev] = ps[lev] + backend.prolong(lev, ps[lev + 1],
                                            as_quads=q(lev))
        if (lev == top and emit_top_residual
                and _fused_res_ok(backend, lev, cfg.ns_post, ps[lev])):
            ps[lev], r_top = backend.relax_residual(lev, ps[lev], bs[lev],
                                                    cfg.ns_post)
        else:
            ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_post)
    return ps, r_top


def fcycle(backend, p0, b0, r0, cfg: SolverConfig,
           emit_residual: bool = False):
    """One F-cycle (``Fcycle``, mg_solvers.f90:104-126): restrict the
    current residual down all levels, relax the coarsest, then per level
    apply the coarse correction and run a V-cycle from there.

    Arguments and result are in level 0's state layout (QuadField on a
    quad-persistent level 0).  With ``emit_residual`` returns ``(p, r)``,
    ``r`` the fresh level-0 residual when the last post-smoothing emitted
    it (else None)."""
    L = backend.nlevs
    q = backend.state_quads
    ps = [None] * L
    bs = [None] * L
    ps[0], bs[0] = p0, b0
    r = r0
    for lev in range(0, L - 1):
        bs[lev + 1] = backend.restrict(lev, r, as_quads=q(lev + 1))
        ps[lev + 1] = backend.zeros(lev + 1, as_quads=q(lev + 1))
        r = bs[lev + 1]           # coarse residual (p=0) == b (:114)
    ps[L - 1] = backend.relax(L - 1, ps[L - 1], bs[L - 1], cfg.ns_coarsest)
    r_top = None
    for lev in range(L - 2, -1, -1):
        ps[lev] = ps[lev] + backend.prolong(lev, ps[lev + 1],
                                            as_quads=q(lev))
        ps, r_top = vcycle(backend, ps, bs, lev, cfg,
                           emit_top_residual=emit_residual and lev == 0)
    return (ps[0], r_top) if emit_residual else ps[0]


def vcycle2(backend, ps: list, bs: list, top: int, bottom: int,
            cfg: SolverConfig) -> list:
    """Partial-depth V-cycle: descend only to level ``bottom``
    (``Vcycle2``, mg_solvers.f90:155-177), every level in full layout
    (JAX ``vcycle2``: zeros and coarse right-hand sides in full layout)."""
    for lev in range(top, bottom):
        if _fused_rr_ok(backend, lev, cfg.ns_pre, ps[lev]):
            ps[lev], bs[lev + 1] = backend.relax_residual_restrict(
                lev, ps[lev], bs[lev], cfg.ns_pre)
        else:
            ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_pre)
            bs[lev + 1] = backend.residual_restrict(lev, ps[lev], bs[lev])
        ps[lev + 1] = backend.zeros(lev + 1)
    ps[bottom] = backend.relax(bottom, ps[bottom], bs[bottom],
                               cfg.ns_coarsest)
    for lev in range(bottom - 1, top - 1, -1):
        ps[lev] = ps[lev] + backend.prolong(lev, ps[lev + 1])
        ps[lev] = backend.relax(lev, ps[lev], bs[lev], cfg.ns_post)
    return ps


def dot(backend, lev: int, x, y) -> torch.Tensor:
    """<x, y> over the interior (``norm``, mg_solvers.f90:180-200); on one
    device the plain sum."""
    del backend, lev
    return torch.sum(x * y)


def testgalerkin(backend, lev: int, cfg: SolverConfig, seed: int = 0,
                 field: str = "smooth"):
    """Inter-grid and operator consistency (``testgalerkin``,
    mg_solvers.f90:203-288; JAX ``testgalerkin``): a coarse field p on
    level ``lev``, <p, A_c p> against <P p, A_f P p> on level ``lev - 1``.
    For a smooth field both approximate the same energy integral, so
    ratio = norm_c / norm_f * 4 is near 4 (:281-286).  ``field='smooth'``
    is the Gaussian bump of the reference's commented variant (:226-232);
    ``'random'`` draws uniform values from a ``torch.Generator`` seeded by
    ``seed`` (the live code, :224; not the JAX package's numbers), whose
    rough modes trilinear interpolation damps, so the ratio comes out
    larger.  Returns (norm_coarse, norm_fine, ratio)."""
    s = backend.levels[lev]
    cA = backend.ops[lev].cA
    dt, dev = cA.dtype, cA.device
    if field == "random":
        g = torch.Generator(device=dev).manual_seed(seed)
        p_c = torch.rand((s.nzg, s.nyg, s.nxg), generator=g, dtype=dt,
                         device=dev)
    else:
        ax = lambda n, c: ((torch.arange(n, dtype=dt, device=dev) + 0.5) / n
                           - c)
        x, y, z = ax(s.nxg, 0.3), ax(s.nyg, 0.4), ax(s.nzg, 0.2)
        p_c = torch.exp(-30.0 * (x[None, None, :] ** 2
                                 + y[None, :, None] ** 2
                                 + z[:, None, None] ** 2))
    r_c = -backend.residual(lev, p_c, torch.zeros_like(p_c))   # A_c p
    norm_c = torch.sum(p_c * r_c)
    p_f = backend.prolong(lev - 1, p_c)                        # P p
    r_f = -backend.residual(lev - 1, p_f, torch.zeros_like(p_f))
    norm_f = torch.sum(p_f * r_f)
    return float(norm_c), float(norm_f), float(norm_c / norm_f * 4.0)


def _init_state(be, b):
    """p = 0, b and the initial residual in level 0's state layout, ||r||^2
    and ||b|| (solve_p's prologue, mg_solvers.f90:35-57)."""
    p = be.zeros(0, as_quads=be.state_quads(0))
    bnorm = torch.sqrt(be.norm_sq(0, b))
    bs = be.to_state(0, b)
    r = be.residual(0, p, bs)
    return p, bs, r, be.norm_sq(0, r), bnorm


def solve_init(be, b):
    """p = 0, ||b||, initial residual and relative norm (solve_p prologue,
    mg_solvers.f90:35-57), with (p, b, r) in level 0's state layout."""
    p, bs, r, rsq, bnorm = _init_state(be, b)
    return p, bs, r, torch.sqrt(rsq) / bnorm, bnorm


def cycle_step(be, p, b, r, cfg):
    """One F-cycle + fresh residual.

    Default: the direct form p = Fcycle(p, b) (mg_solvers.f90:61-79).
    With the low-precision smoother operator (``fused_bands_bf16``) the
    defect-correction form p += Fcycle(0, r, r) instead.  The two are equal
    in exact arithmetic (relaxation is shift-invariant), but with a
    perturbed smoother operator A' the direct form's fixed point is biased
    from A^-1 b by O(|A - A'|), a floor of the relative residual, while in
    defect form the perturbation multiplies the current error and only
    slows the convergence factor; the true-A residual steers."""
    if cfg.fused_bands_bf16:
        z = be.zeros(0, as_quads=is_quads(p))
        p = p + fcycle(be, z, r, r, cfg)
        return p, be.residual(0, p, b)
    p, r = fcycle(be, p, b, r, cfg, emit_residual=True)
    if r is None:
        r = be.residual(0, p, b)
    return p, r


def step_norm(be, p, b, r, cfg):
    """One convergence-loop iteration: ``cycles_per_check`` F-cycles with
    their fresh residual (mgroms_tpu/solver.py:696-703), ||r||^2 and
    ||r||."""
    for _ in range(cfg.cycles_per_check):
        p, r = cycle_step(be, p, b, r, cfg)
    rsq = be.norm_sq(0, r)
    return p, r, rsq, torch.sqrt(rsq)


def solve_step(be, p, b, r, cfg):
    """One convergence-loop iteration: ``cycles_per_check`` F-cycles +
    fresh residual + norm (the step a CUDA graph captures, capture.py)."""
    p, r, _, rnorm = step_norm(be, p, b, r, cfg)
    return p, r, rnorm


class SolveInfo(NamedTuple):
    niter: int
    res: float                 # final relative residual ||r||/||b||
    history: tuple             # relative residual after each F-cycle
    time_s: float
    rescaled_perf: float       # reference figure of merit (mg_solvers.f90:92)


def graph_wanted(backend, graph: Optional[bool],
                 cfg: Optional[SolverConfig] = None) -> bool:
    """Whether a solve replays its step as a CUDA graph (capture.py): by
    default on a single-device backend on the card; ``graph=False`` runs
    the eager loop; ``graph=True`` raises where no graph can run (the CPU,
    a distributed backend) and for an order-exact GS solve, which runs
    eagerly: its nx*ny dependent column steps a sweep, each a few dozen
    small operations, would make a graph of millions of nodes at the
    grids a card is for (ops/relax.relax_gs_exact)."""
    if gs_exact_wanted(cfg or backend.cfg):
        if graph:
            raise ValueError("an order-exact GS solve (gs_exact) runs "
                             "eagerly: graph=True is refused")
        return False
    can = backend.on_card and backend.capturable
    if graph and not can:
        raise ValueError("a CUDA graph replays a single-device solve on "
                         "the card only")
    return can if graph is None else graph


def _dump(backend, cfg: SolverConfig, x, vname: str, fname: str,
          iteration: Optional[int] = None) -> None:
    """A level-0 state (either layout; its tiles on a distributed backend)
    written whole to ``cfg.output_dir`` (io/diagnostics.write_field, rank
    0)."""
    write_field(backend.gather(0, x), vname,
                os.path.join(cfg.output_dir, fname), rank=0,
                iteration=iteration)


def _rescaled_perf(backend, dt: float, res: float, res0: float,
                   niter: int) -> float:
    """The reference's figure of merit (mg_solvers.f90:84-97): seconds per
    DOF per decade of residual reduction."""
    s = backend.levels[0]
    decades = (-math.log10(max(res / res0, 1e-300)) if niter
               else float("nan"))
    return (dt / decades / (s.nxg * s.nyg * s.nzg)
            if decades and decades > 0 else float("nan"))


def _device_loop(backend, b, cfg: SolverConfig, tol: float, maxiter: int,
                 graph: bool):
    """JAX's ``_solve_device_loop`` (mgroms_tpu/solver.py:706-748): the
    prologue, then checks of ``cycles_per_check`` F-cycles while the
    condition (ops/kernels/device_loop.py) holds, the history kept on the
    device.  With ``graph`` the loop is one CUDA graph with a WHILE node
    (capture.DeviceLoop); else the same body and condition in a Python
    loop, which reads the condition once a check.  Returns the pressure in
    full layout, the cycles run and the history to them (NaN where no
    check landed)."""
    if graph:
        from .capture import captured_loop
        loop = captured_loop(backend, cfg, maxiter)
        with span("prologue", backend):
            loop.load(*_init_state(backend, b), maxiter, tol)
        with span("fcycle", backend):
            loop.launch()
        with span("read"):
            niter, hist = loop.read()
        with span("result", backend):
            p = loop.step.result()
        return p, niter, hist
    cpc = cfg.cycles_per_check
    with span("prologue", backend):
        p, bs, r, rsq, bnorm = _init_state(backend, b)
        buf = loop_condition.LoopBuffers(rsq, maxiter + cpc)
        buf.reset(maxiter, tol, cpc)
        loop_condition.loop_condition(rsq, bnorm, buf.it, buf.hist,
                                      buf.lim, cpc, True, buf.cont,
                                      buf.runs)
    while True:
        with span("read"):
            go = bool(buf.cont)
        if not go:
            break
        with span("fcycle", backend):
            p, r, rsq, _ = step_norm(backend, p, bs, r, cfg)
            loop_condition.loop_condition(rsq, bnorm, buf.it, buf.hist,
                                          buf.lim, cpc, False, buf.cont,
                                          buf.runs)
    with span("read"):
        niter, hist, _ = buf.read()
    with span("result", backend):
        p = backend.to_full(0, p)
    return p, niter, hist


def solve_p(backend, b: torch.Tensor, cfg: Optional[SolverConfig] = None,
            tol: Optional[float] = None, maxiter: Optional[int] = None,
            verbose: bool = False, device_loop: Optional[bool] = None,
            graph: Optional[bool] = None) -> Tuple[torch.Tensor, SolveInfo]:
    """Outer convergence loop (``solve_p``, mg_solvers.f90:17-101).

    ``b`` is the global right-hand side in full layout and the pressure
    comes back so, on a distributed backend too (``b`` placed by
    ``MeshPlan.constrain``, ``p`` gathered onto the mesh's first device),
    as the JAX package's solve_p takes and gives global arrays.

    Starts from p = 0 (:35) and runs F-cycles until the relative residual
    ||b - Ap|| / ||b|| drops under ``tol`` or ``maxiter`` cycles (:61-79).
    The host reads the norm once a check of ``cfg.cycles_per_check``
    F-cycles (once a cycle by default, as the reference does), so
    ``niter`` may pass ``maxiter`` by less than a check.

    ``device_loop`` (default: ``cfg.device_loop``) runs the whole loop on
    the device with its history kept there, one host read a solve, as the
    JAX package's ``_solve_device_loop`` (:func:`_device_loop`); with
    ``verbose`` the host loop runs instead, as there.

    ``graph`` is the counterpart of ``jax.disable_jit``
    (:func:`graph_wanted`): on a single-device backend on the card the
    step is captured as a CUDA graph at the first solve and replayed
    (capture.py; the device loop as one graph with a WHILE node), with the
    same kernels on the same inputs as the eager loop, so the same
    history to every digit; ``graph=False`` runs the eager loop.  On the
    CPU and on a distributed backend (parallel/: ``mesh.shard_map`` runs
    the tiles' programs on host threads, which one capture cannot follow)
    the loop is eager."""
    p, info = _solve_p(backend, backend.place(0, b), cfg, tol=tol,
                       maxiter=maxiter, verbose=verbose,
                       device_loop=device_loop, graph=graph)
    return backend.gather(0, p), info


def _solve_p(backend, b, cfg: Optional[SolverConfig] = None,
             tol: Optional[float] = None, maxiter: Optional[int] = None,
             verbose: bool = False, device_loop: Optional[bool] = None,
             graph: Optional[bool] = None):
    """:func:`solve_p` on ``b`` in level 0's placement (its tiles on a
    distributed backend), the pressure returned in full layout in the same
    placement (NHModel.solve's projection takes the tiles).

    With spans on (utils/tictoc.record_spans) the solve is a ``solve``
    span over its ``prologue`` (the initial residual and the loads into
    the graph's buffers), one ``fcycle`` a convergence step, a ``read``
    for each blocking read of the device by the host and the
    ``result``."""
    cfg = cfg or backend.cfg
    tol = cfg.solver_prec if tol is None else tol
    maxiter = cfg.solver_maxiter if maxiter is None else maxiter
    if device_loop is None:
        device_loop = cfg.device_loop
    graph = graph_wanted(backend, graph, cfg)

    with span("solve"):
        if device_loop and not (verbose or cfg.netcdf_output):
            t0 = time.perf_counter()
            p, niter, hist = _device_loop(backend, b, cfg, tol, maxiter,
                                          graph)
            with span("read"):
                backend.synchronize()
            dt = time.perf_counter() - t0
            hist = [h for h in hist if not math.isnan(h)]
            # b == 0 makes every entry 0/0 = NaN (the host loop returns
            # the same degenerate history=(nan,)); keep the shape of that
            # contract
            if not hist:
                hist = [float("nan")]
            return p, SolveInfo(niter=niter, res=hist[-1],
                                history=tuple(hist), time_s=dt,
                                rescaled_perf=_rescaled_perf(
                                    backend, dt, hist[-1], hist[0], niter))

        t0 = time.perf_counter()
        step = None
        if graph:
            from .capture import captured_step
            step = captured_step(backend, cfg)
        with span("prologue", backend):
            p, bs, r, res0, bnorm = solve_init(backend, b)
            if step is not None:
                step.load(p, bs, r)
                del p, bs, r
        with span("read"):
            res0 = float(res0)
        with span("read"):
            bnorm = float(bnorm)
        r0val = res0
        history = [res0]
        nite = 0
        while nite < maxiter and res0 > tol:
            with span("fcycle", backend):
                if step is not None:
                    rnorm = step.replay()
                else:
                    p, r, rnorm = solve_step(backend, p, bs, r, cfg)
            with span("read"):
                rnorm = float(rnorm) / bnorm
            conv = res0 / rnorm if rnorm > 0 else float("inf")
            res0 = rnorm
            nite += cfg.cycles_per_check
            history.append(rnorm)
            if verbose:
                print(f"ite = {nite:2d}: res = {rnorm:10.3e} / "
                      f"conv = {conv:10.3f}")
            if cfg.netcdf_output:
                # per-iteration dumps (mg_solvers.f90:74-77); a replayed
                # step leaves its iterates in its static buffers
                _dump(backend, cfg, step.p if step is not None else p, "p",
                      "p.nc", nite)
                _dump(backend, cfg, step.r if step is not None else r, "r",
                      "r.nc", nite)
        with span("result", backend):
            p = step.result() if step is not None else backend.to_full(0, p)
        with span("read"):
            backend.synchronize()
        dt = time.perf_counter() - t0
        if cfg.netcdf_output:
            # end-of-solve dumps (nhydro.f90:92-95)
            _dump(backend, cfg, p, "p", "p_end.nc")
            _dump(backend, cfg, step.r if step is not None else r, "r",
                  "r_end.nc")
        return p, SolveInfo(niter=nite, res=res0, history=tuple(history),
                            time_s=dt,
                            rescaled_perf=_rescaled_perf(backend, dt, res0,
                                                         r0val, nite))
