"""Mixed-precision defect correction (iterative refinement).

Port of ``mgroms_tpu/refine.py``.  An extension with no reference
equivalent: the Fortran reference runs float64 end to end (``rp=8``,
mg_namelist.f90:8) and its shipped namelist asks for ``solver_prec=1e-12``
(src/nh_namelist:3), which a pure float32 solve cannot reach (its
relative residual floors near 4e-5 on the seamount case).  Defect
correction reaches float64 accuracy while every multigrid cycle stays
float32:

    r_k = b - A p_k              float64 (the reference model)
    solve A e ~= r_k / s         float32 multigrid F-cycles, s = max|r_k|
    p_{k+1} = p_k + s e          float64

Each round gains the float32 solve's residual reduction, so a few rounds
reach 1e-12.  The float64 work of a round is one residual and its norm.

Both models live on one device, the card by default.  The JAX package
keeps its float64 reference model on the host CPU only because the TPU
lacks float64; the H100 computes float64 itself, so here a round moves
nothing between host and device: ``r / s`` and ``e`` pass between the two
models as casts on the device.  The float64 model takes the JAX package's
configuration: ``use_pallas`` and ``pallas_tiled`` off (no kernel; its
residual is plain torch), ``compact``, ``cmatrix``, ``bmask`` and
``aggressive`` from the float32 one.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from .config import SolverConfig
from .model import NHModel
from .solver import solve_p


def build_pair(nx: int, ny: int, nz: int, case,
               cfg32: Optional[SolverConfig] = None, device="cuda"
               ) -> Tuple[NHModel, NHModel]:
    """Assemble the (float32 solve, float64 reference) model pair from one
    case (a ``cases`` setup: float64 numpy geometry), both on ``device``.
    Both see the same float64 geometry, so the float32 operator is the
    rounding of the float64 one."""
    cfg32 = cfg32 or SolverConfig(dtype="float32")
    if cfg32.dtype != "float32":
        raise ValueError(f"the inner solve runs in float32, got "
                         f"{cfg32.dtype}")
    cfg64 = SolverConfig(
        dtype="float64", compact=cfg32.compact, cmatrix=cfg32.cmatrix,
        bmask=cfg32.bmask, aggressive=cfg32.aggressive, use_pallas=False,
        pallas_tiled=False)
    pair = []
    for cfg in (cfg32, cfg64):
        m = NHModel(nx, ny, nz, cfg=cfg, device=device)
        m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                       theta_b=case.theta_b, theta_s=case.theta_s)
        pair.append(m)
    return pair[0], pair[1]


class RefineInfo(NamedTuple):
    rounds: int
    res: float                  # final float64 relative residual ||r||/||b||
    history: tuple              # float64 relative residual after each round
    inner_cycles: tuple         # F-cycles spent in each inner float32 solve
    time_s: float


def refined_pressure_solve(m32: NHModel, m64: NHModel, b64,
                           tol: float = 1.0e-12, max_rounds: int = 10,
                           inner_tol: float = 1.0e-4,
                           inner_maxiter: int = 4,
                           verbose: bool = False
                           ) -> Tuple[torch.Tensor, RefineInfo]:
    """Solve A p = b to float64 accuracy with float32 multigrid cycles.

    ``b64`` is taken to the float64 model's device and type.  The inner
    float32 solves run until ``inner_tol`` (the float32 floor) or
    ``inner_maxiter`` F-cycles on the float32 model's backend.  Returns
    the float64 pressure on the float64 model's device."""
    be64 = m64.backend
    t0 = time.perf_counter()
    b64 = m64.tensor(b64)
    bnorm = float(torch.sqrt(be64.norm_sq(0, b64)))
    p64 = torch.zeros_like(b64)
    history = []
    inner_cycles = []
    res = float("inf")
    rounds = 0
    for rounds in range(max_rounds + 1):
        r64 = be64.residual(0, p64, b64)
        res = float(torch.sqrt(be64.norm_sq(0, r64))) / bnorm
        history.append(res)
        if verbose:
            print(f"refine round {rounds}: f64 rel residual = {res:.3e}")
        if res <= tol or rounds == max_rounds:
            break
        # scale so the float32 inner solve works near unit magnitude
        # (residuals shrink by decades a round; unscaled they would
        # underflow float32)
        s = float(r64.abs().max())
        if s == 0.0:
            break
        r32 = m32.tensor(r64 / s)
        e32, info = solve_p(m32.backend, r32, m32.cfg, tol=inner_tol,
                            maxiter=inner_maxiter)
        inner_cycles.append(info.niter)
        p64 = p64 + m64.tensor(e32) * s
    be64.synchronize()
    dt = time.perf_counter() - t0
    return p64, RefineInfo(rounds=rounds, res=res, history=tuple(history),
                           inner_cycles=tuple(inner_cycles), time_s=dt)
