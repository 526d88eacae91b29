"""The per-(level, section) F-cycle breakdown at CUC scale on the card.

Port of the JAX package's ``scripts/profile_cuc.py`` in its
configuration (:func:`build`: CUC 1024^2 x 64, ``SolverConfig(dtype=
"float32", coarsest="direct")``, then ``offload_metrics``; :45-60
there).  Runs utils/tictoc.profile_fcycle on the model's backend: one
eager F-cycle through the InstrumentedBackend records every per-level op
with its argument layout (QuadField on the quad levels) and times it on
the host (waiting for the card) and on the card (a pair of CUDA events);
then each distinct (op, level, statics, shapes) is re-timed with CUDA
events over ``iters`` calls back to back.  The whole F-cycle (one
convergence step: solver.solve_step, the F-cycle, the fresh residual and
its norm) is also timed as one call, replayed (the captured step) and
eagerly (CUDA events, median of 5 each), so the rows can be reconciled
against it.

Prints the re-timed table (print_tictoc's layout), the eager pass's
device and host tables, one JSON line a row, and one JSON line with the
rows, their device-time sum, both F-cycle medians and the card's name and
power limit (``nvidia-smi``).

    python -m mgroms_tpu_torch.scripts.profile_cuc [--nx 1024 --ny 1024
        --nz 64] [--case cuc|seamount] [--iters 5]

The JAX script's ``--chunks`` (``fused_sweep_chunks``, Mosaic lane
chunks) is left out: the port's SolverConfig keeps the field, equal to
the JAX package's, but no route reads it (solver.py).  Needs a card.

Reference: the per-(level, routine) table of mg_tictoc.f90:114-153,
bracketed at mg_relax.f90:128,146,167,188 and mg_solvers.f90:45,82,108,124.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import NHModel
from ..capture import captured_step
from ..cases.cuc import setup_cuc_synthetic
from ..cases.seamount import setup_seamount
from ..solver import solve_init, solve_step
from ..utils.tictoc import TicToc, profile_fcycle
from . import solve_wall
from ._timing import card, card_line, median_ms

SETUPS = {"cuc": setup_cuc_synthetic, "seamount": setup_seamount}


def build(nx=1024, ny=1024, nz=64, case="cuc", device="cuda") -> NHModel:
    """The model of the JAX script (scripts/profile_cuc.py:54-59, the
    configuration of solve_wall.build): ``case``'s operators at this grid,
    the metrics offloaded."""
    m, _, _ = solve_wall.build(nx, ny, nz, device, SETUPS[case](nx, ny, nz))
    return m


def fcycle_ms(m: NHModel, b: torch.Tensor, reps: int = 5):
    """Median ms of one convergence step (solver.solve_step) of ``m`` on
    ``b`` (level 0's right-hand side in full layout, its tiles on a
    distributed backend) from a fresh start
    (CUDA events, one warm-up call each): replayed (its captured step;
    None on a backend a graph cannot capture) and eagerly."""
    be = m.backend
    p, bs, r, _, _ = solve_init(be, b)
    replay = None
    if be.capturable:
        step = captured_step(be, m.cfg)
        step.load(p, bs, r)
        replay = median_ms(step.replay, reps=reps, warm=1)
    state = [p, r]

    def eager():
        state[0], state[1], _ = solve_step(be, state[0], bs, state[1],
                                           m.cfg)

    return replay, median_ms(eager, reps=reps, warm=1)


def run(nx=1024, ny=1024, nz=64, case="cuc", iters=5, device=None,
        model=None) -> dict:
    """The tables and JSON lines of the module docstring, on ``model``
    (default: :func:`build`'s); returns the last JSON line's object."""
    dev = card(device)
    m = model or build(nx, ny, nz, case, dev)
    b = torch.ones((m.nz, m.ny, m.nx), dtype=m.dtype, device=dev)
    replay, eager = fcycle_ms(m, b)
    print(json.dumps({"fcycle_ms_replay": replay, "fcycle_ms_eager": eager}),
          flush=True)
    tt = TicToc()
    profile_fcycle(m.backend, b, m.cfg, device_timer=True, iters=iters,
                   tictoc=tt)
    print(f"re-timed on the card (CUDA events, {iters} calls a group), "
          "seconds / calls:")
    print(tt.report(), flush=True)
    print("the eager pass, CUDA events around each call:")
    print(tt.report(tt.device))
    print("the eager pass, host wall (waiting for the card):")
    print(tt.report(tt.host), flush=True)
    rows = []
    for key, (secs, calls) in sorted(tt.table.items()):
        rows.append({"lev": key[0], "op": key[1], "ms": secs * 1e3,
                     "calls": calls,
                     "eager_device_ms": tt.device[key][0] * 1e3,
                     "eager_host_ms": tt.host.get(key, [0.0])[0] * 1e3})
        print(json.dumps(rows[-1]), flush=True)
    out = {"grid": [m.nz, m.ny, m.nx], "case": case,
           "levels": len(m.levels),
           "config": {"dtype": m.cfg.dtype, "coarsest": m.cfg.coarsest,
                      "offload_metrics": True},
           "rows": rows, "device_ms_sum": sum(r["ms"] for r in rows),
           "eager_device_ms_sum": sum(r["eager_device_ms"] for r in rows),
           "eager_host_ms_sum": sum(r["eager_host_ms"] for r in rows),
           "fcycle_ms_replay": replay, "fcycle_ms_eager": eager,
           "card": card_line(),
           "note": "device_ms_sum: the rows re-timed (one F-cycle, the "
                   "F-cycle boundary's layout conversions and the outer "
                   "loop's residual, each op timed alone); fcycle_ms: "
                   "one convergence step timed as one call"}
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--case", default="cuc", choices=sorted(SETUPS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run(args.nx, args.ny, args.nz, args.case, args.iters, args.device)


if __name__ == "__main__":
    main()
