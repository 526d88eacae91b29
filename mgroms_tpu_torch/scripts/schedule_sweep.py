"""Smoothing-schedule sweep at CUC scale on the card: time to the floor,
not ms per F-cycle.

Port of the JAX package's ``scripts/schedule_sweep.py``: fewer smoothing
sweeps a level make an F-cycle cheaper, and pay if the convergence
factor holds.  The reference schedule (ns_pre=3, ns_post=2,
mg_namelist.f90:13-15) stays the default; this measures (3, 2), (2, 1),
(2, 2) and (1, 1) on the reference's own figure of merit, the time per
decade of residual reduction.

One model is built (solve_wall.build: ``SolverConfig(dtype="float32",
coarsest="direct")``, the right-hand side of the initial velocities, then
``offload_metrics``, as :44-50 there) and each schedule runs on a
``SingleDeviceBackend`` over
its operators and packs (:53-57): two CUC models do not fit on one card
beside their solves, which the JAX script's first run found.  Per
schedule, the captured step (capture.py; one F-cycle, the fresh residual
and its norm) is replayed 6 times from p = 0 for the residual history,
then ``reps`` more times, timed with CUDA events (the median).  Prints one
JSON line a schedule: ms per F-cycle, the relative residual history (at
p = 0, then after each F-cycle), F-cycles and ms to
1e-4, ms per decade at the floor (6 F-cycles' time over the decades the
history fell), and the card's name and power limit.

    python -m mgroms_tpu_torch.scripts.schedule_sweep [--nx 1024
        --ny 1024 --nz 64] [--reps 10]

Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math

import torch

from ..capture import captured_step
from ..solver import SingleDeviceBackend, solve_init
from ._timing import card, card_line, median_ms
from .solve_wall import build

SCHEDULES = ((3, 2), (2, 1), (2, 2), (1, 1))
CYCLES = 6


def run(nx=1024, ny=1024, nz=64, reps=10, device=None) -> list:
    """One row a schedule (the module docstring's JSON lines), printed and
    returned."""
    dev = card(device)
    m, b, _ = build(nx, ny, nz, dev)
    base = m.backend
    line = card_line()
    rows = []
    for ns_pre, ns_post in SCHEDULES:
        cfg = dataclasses.replace(m.cfg, ns_pre=ns_pre, ns_post=ns_post)
        # the same operators and packs, another schedule
        be = SingleDeviceBackend(list(base.levels), list(base.ops), cfg,
                                 packs=list(base.packs))
        p, bs, r, res0, bnorm = solve_init(be, b)
        step = captured_step(be, cfg)
        step.load(p, bs, r)
        del p, bs, r
        hist = [float(step.replay()) / float(bnorm)
                for _ in range(CYCLES)]
        ms = median_ms(step.replay, reps=reps, warm=0)
        ncyc = next((i + 1 for i, h in enumerate(hist) if h <= 1e-4), None)
        decades = -math.log10(max(min(hist), 1e-30))
        rows.append({
            "ns_pre": ns_pre, "ns_post": ns_post, "fcycle_ms": ms,
            "history": [float(res0)] + hist,
            "cycles_to_1e-4": ncyc,
            "time_to_1e-4_ms": ms * ncyc if ncyc else None,
            "ms_per_decade_at_floor": ms * CYCLES / decades,
            "card": line})
        print(json.dumps(rows[-1]), flush=True)
        del be, step
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run(args.nx, args.ny, args.nz, args.reps, args.device)


if __name__ == "__main__":
    main()
