"""The solve to tolerance on the card, three ways: the eager host loop,
the host loop replaying the captured step, and the device loop.

Port of the JAX package's ``scripts/solve_wall.py`` (host loop against
``device_loop``, CUC 1024^2 x 64 to 1e-4) in its configuration
(:func:`build`: ``SolverConfig(dtype="float32", coarsest="direct")``,
set_matrices, the right-hand side of the initial velocities, then
``offload_metrics``; scripts/solve_wall.py:41-49 there).  Times, on one
model and one right-hand side, in turns:

  eager        solver.solve_p(graph=False): the F-cycle's operations
               enqueued one by one from Python, a host read a cycle
  replay       solve_p(): the step captured once (capture.CapturedStep)
               and replayed, a host read a cycle
  device_loop  solve_p(device_loop=True): the whole loop as one CUDA graph
               with a WHILE node (capture.DeviceLoop), a host read a solve

Each mode's first solve is not timed (the replayed modes capture there);
``reps`` more are.  All three histories must be equal to every digit (the
same kernels on the same inputs).  Prints one JSON line: the
configuration and the bytes ``offload_metrics`` moved; per mode the
cycles, the final residual, the history and the walls (mean, median,
all); the one-off seconds of the warm-up, the capture and the
instantiation of the step, and of the device loop's graph (the step's
clone into its WHILE body and the instantiation); the peak device memory
from a card that held nothing of this model (set-up and the three
modes).

    python -m mgroms_tpu_torch.scripts.solve_wall [--nx 1024 --ny 1024
        --nz 64 --tol 1e-4 --maxiter 12 --reps 3]

Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import torch

from .. import NHModel, SolverConfig
from ..capture import captured_loop, captured_step
from ..cases.cuc import setup_cuc_synthetic
from ..cases.seamount import initial_velocities
from ..solver import solve_p
from ._timing import card, card_line

MODES = {"eager": dict(graph=False), "replay": dict(),
         "device_loop": dict(device_loop=True)}
# the JAX script's solver configuration (scripts/solve_wall.py:41)
CONFIG = SolverConfig(dtype="float32", coarsest="direct")


def build(nx, ny, nz, device="cuda", case=None):
    """The JAX script's set-up: the model in :data:`CONFIG`, its operators
    from ``case`` (the CUC case at this grid, made here when not given),
    b the right-hand side of the initial velocities, then the metrics
    offloaded (they are not read again).  Returns (model, b, the bytes
    offloaded)."""
    case = case or setup_cuc_synthetic(nx, ny, nz)
    m = NHModel(nx, ny, nz, cfg=CONFIG, device=device)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    b = m.rhs(*initial_velocities(nx, ny, nz, dtype=m.dtype, device=device))
    return m, b, m.offload_metrics()


def run(nx=1024, ny=1024, nz=64, tol=1e-4, maxiter=12, reps=3,
        device=None, case=None) -> dict:
    """The JSON row of the module docstring (``case``: as :func:`build`)."""
    dev = card(device)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    m, b, offloaded = build(nx, ny, nz, dev, case)
    row = {"grid": [nz, ny, nx], "tol": tol, "maxiter": maxiter,
           "config": {"dtype": CONFIG.dtype, "coarsest": CONFIG.coarsest,
                      "offload_metrics": True},
           "offloaded_bytes": offloaded,
           "card": card_line(), "torch": torch.__version__}
    for mode, kw in MODES.items():
        walls, info = [], None
        for rep in range(reps + 1):
            t0 = time.perf_counter()
            _, info = solve_p(m.backend, b, m.cfg, tol=tol, maxiter=maxiter,
                              **kw)
            if rep > 0:              # the first solve captures
                walls.append(time.perf_counter() - t0)
        row[mode] = {"niter": info.niter, "final_rel_residual": info.res,
                     "history": list(info.history),
                     "wall_s_per_solve": sum(walls) / len(walls),
                     "wall_s_median": statistics.median(walls),
                     "wall_s_all": walls}
    for mode in ("replay", "device_loop"):
        if row[mode]["history"] != row["eager"]["history"]:
            raise AssertionError(f"{mode} history {row[mode]['history']} "
                                 f"!= eager {row['eager']['history']}")
    step = captured_step(m.backend, m.cfg)
    row["step_warmup_s"] = step.warmup_s
    row["step_capture_s"] = step.capture_s
    row["step_instantiate_s"] = step.instantiate_s
    loop = captured_loop(m.backend, m.cfg, maxiter)
    row["loop_clone_s"] = loop.clone_s
    row["loop_instantiate_s"] = loop.instantiate_s
    row["held_gib"] = held / 2**30
    row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del m, b, step, loop
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--maxiter", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    print(json.dumps(run(args.nx, args.ny, args.nz, args.tol, args.maxiter,
                         args.reps, args.device)), flush=True)


if __name__ == "__main__":
    main()
