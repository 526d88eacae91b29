"""The comparison that decides ``correct``.

After the window, once the program's state is freed, the plain reference
(``reference/``) works the level-0 operator and the metrics out again in
float64 from the case fields, and for each sampled step the right-hand
side from the step's input velocities, all of them the tensors the
benchmark handed to the program.  It then judges what the step gave back:

- ``res``: ||b - A p|| / ||b||, the pressure's relative residual (2-norm)
  in the reference's operator against the reference's right-hand side.  It
  covers the operator's assembly, the right-hand side and the pressure
  solve: a fault in any of them leaves p solving another equation.
- ``proj_gap``: max |x - x_ref| / max |x_ref| over the corrected u, v and
  w, where x_ref is the reference's projection of the input velocities by
  the program's pressure.  It covers the projection.

- ``res_max``: max |b - A p| / max |b|, the same residual's largest
  point.  It separates a solve stopped one F-cycle short, which ``res``
  does not.

Each number is the worst over the sampled steps.  Beside them the harness
holds ``failed``, the window's steps whose solve reported a residual over
its tolerance (``SolveInfo.res``).  Each is held at or under its limit from
``limits/<workload>.json``.

The control (:func:`control_outputs`) is the reference put in the program's
place one precision lower, in bfloat16: the pressure stored in bfloat16
and the projection worked out in bfloat16 from metrics assembled in
bfloat16.  ``control.py`` reads it on the chip and the tests hold it to
come out not correct.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from . import reference

HERE = Path(__file__).resolve().parent
HELD = ("res", "res_max", "proj_gap", "failed")


def limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


class Reference:
    """The reference's level-0 operator and metrics for a case, in
    ``dtype`` on ``device``."""

    def __init__(self, case, nz: int, device, dtype=torch.float64):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.dtype = dtype
        self.cA, self.metrics = reference.assemble(
            t(case.dx), t(case.dy), t(case.zeta), t(case.h), nz, case.hc,
            case.theta_b, case.theta_s)


def readings(ref: Reference, inputs, outputs) -> dict:
    """The numbers of one step: ``inputs`` its (u, v, w), ``outputs`` the
    (u, v, w, p) it gave back."""
    f = lambda x: x.to(device=ref.cA.device, dtype=ref.dtype)
    u, v, w = (f(x) for x in inputs)
    p = f(outputs[3])
    b = reference.divergence(ref.metrics, u, v, w)
    r = reference.residual(p, b, ref.cA)
    out = {"res": float(torch.linalg.vector_norm(r)
                        / torch.linalg.vector_norm(b)),
           "res_max": float(r.abs().max() / b.abs().max())}
    del r, b
    want = reference.project(ref.metrics, p, u, v, w)
    gap = 0.0
    for got, x in zip(outputs[:3], want):
        gap = max(gap, float((f(got) - x).abs().max() / x.abs().max()))
    out["proj_gap"] = gap
    return out


def worst(per_step: list) -> dict:
    return {k: max(r[k] for r in per_step) for k in per_step[0]}


def judge(numbers: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the held numbers; a
    number that is not finite fails."""
    shown = {k: {"value": numbers[k], "limit": lim[k]} for k in HELD}
    ok = all(numbers[k] == numbers[k] and numbers[k] <= lim[k]
             for k in HELD)
    return ok, shown


def control_outputs(case, nz: int, inputs, outputs,
                    dtype=torch.bfloat16) -> tuple:
    """The control's (u, v, w, p) for a step: the step's pressure stored
    in ``dtype``, and the reference's projection in ``dtype`` of the
    inputs by it, on metrics the reference assembles in ``dtype``."""
    dev = outputs[3].device
    low = Reference(case, nz, dev, dtype)
    p = outputs[3].to(dtype)
    u, v, w = reference.project(low.metrics, p,
                                *(x.to(dtype) for x in inputs))
    return u, v, w, p
