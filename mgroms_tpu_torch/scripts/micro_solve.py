"""The solve path at full size on the card: peak device memory per
configuration, and what one K1 launch per RB colour saves end to end.

  memory     peak device memory (set-up and solve, as chip_smoke.py's
             run_model takes it: NHModel -> set_matrices [-> distribute]
             -> solve -> check_nondivergence -> rhs) of the quad-level
             configurations of chip_smoke.py's phases, each from a card
             that holds nothing of an earlier solve:

               phase{n}_held_gib   device memory allocated before the
                                   configuration starts
               phase{n}_peak_gib   its peak

             the solve replays its captured step (capture.py) as
             chip_smoke.py's does; with --eager it runs the eager loop
             (graph=False) and the rows are named phase{n}_eager_*

  launches   the K1-K2 route (phase 8: CUC 1024^2 x 64, pallas_fused_sweep
             =False; phase 10: seamount 64^3, perf mode, the same): wall
             time of one F-cycle (solver.solve_step, synchronized) with K1
             one launch per RB colour (as the solver runs it, "one")
             against the same colour as two one-target launches ("two"),
             the two in turns on one model, the order swapped every
             round:

               phase{n}_{one,two}_fcycle_ms          every F-cycle's wall
               phase{n}_{one,two}_fcycle_median_ms   their median
               phase{n}_{one,two}_k1k2_host_ms       median host time a
                                                     F-cycle spends in the
                                                     K1 and K2 wrappers
               phase{n}_{one,two}_launches           K1 and K2 launches
                                                     an F-cycle
               phase{n}_two_minus_one_ms             median of the paired
                                                     differences

    python -m mgroms_tpu_torch.scripts.micro_solve memory [--phases 4 8 ...]
        [--eager]
    python -m mgroms_tpu_torch.scripts.micro_solve launches [--rounds N]

Both need a card.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import time

import torch

from .. import NHModel, SolverConfig
from ..cases.cuc import setup_cuc_synthetic
from ..cases.seamount import initial_velocities, setup_seamount
from ..ops.kernels import relax_tiled as kt
from ..solver import solve_init, solve_step
from ._timing import card, card_line, emit

PERF = dict(fused_bands_bf16=True, ns_pre=1, ns_post=1)
# phase -> (grid, SolverConfig options, virtual mesh, F-cycle limit), as
# chip_smoke.py runs them
PHASES = {
    4: ("cuc", {}, None, 8),
    8: ("cuc", dict(pallas_fused_sweep=False), None, 8),
    9: ("cuc", PERF, None, 12),
    10: ("seamount", dict(PERF, pallas_fused_sweep=False), None, 6),
    12: ("cuc", {}, (2, 2), 8),
    14: ("cuc", dict(relax_method="FC"), None, 3),
}
GRIDS = {"cuc": ((1024, 1024, 64), setup_cuc_synthetic),
         "seamount": ((64, 64, 64), setup_seamount)}


def model(dev, phase):
    """The phase's NHModel with its matrices set (and distributed)."""
    grid, cfg, mesh, _ = PHASES[phase]
    (nx, ny, nz), setup = GRIDS[grid]
    case = setup(nx, ny, nz)
    m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype="float32", **cfg),
                device=dev)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    if mesh:
        m.distribute(*mesh, devices=[dev] * (mesh[0] * mesh[1]),
                     comm="shard_map")
    return m


def memory(dev=None, phases=(4, 8, 9, 12, 14), eager=False) -> dict:
    """The ``memory`` rows of the module docstring."""
    dev = card(dev)
    print(card_line(), flush=True)
    rows = {}
    name = "_eager" if eager else ""
    for phase in phases:
        gc.collect()
        torch.cuda.empty_cache()
        emit(rows, f"phase{phase}{name}_held_gib",
             torch.cuda.memory_allocated(dev) / 2**30)
        torch.cuda.reset_peak_memory_stats(dev)
        m = model(dev, phase)
        u, v, w = initial_velocities(m.nx, m.ny, m.nz, dtype=m.dtype,
                                     device=dev)
        uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-4,
                                      maxiter=PHASES[phase][3],
                                      graph=False if eager else None)
        float(m.check_nondivergence(uc, vc, wc))
        float(m.rhs(uc, vc, wc).abs().max())
        emit(rows, f"phase{phase}{name}_peak_gib",
             torch.cuda.max_memory_allocated(dev) / 2**30)
        del m, u, v, w, uc, vc, wc, p, info
    return rows


def _timed(fn, acc):
    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        acc[0] += time.perf_counter() - t0
        return out
    return call


def _split(fn):
    """``fn`` with an RB colour as two one-target launches."""
    def call(e, bq, pack, targets):
        out = {}
        for t in targets:
            out.update(fn(e, bq, pack, (t,)))
        return out
    return call


def launches(dev=None, phases=(8, 10), rounds=10) -> dict:
    """The ``launches`` rows of the module docstring; the module's
    wrappers are restored after."""
    dev = card(dev)
    print(card_line(), flush=True)
    rows = {}
    k1, k2 = kt.color_update, kt.color_update_emit
    keys = ("color_update", "color_update_bf16", "color_update_emit")
    try:
        for phase in phases:
            m = model(dev, phase)
            be = m.backend
            u, v, w = initial_velocities(m.nx, m.ny, m.nz, dtype=m.dtype,
                                         device=dev)
            p, bs, r, _, _ = solve_init(be, m._rhs_state(u, v, w))
            acc = [0.0]
            wrap = {"one": (_timed(k1, acc), _timed(k2, acc)),
                    "two": (_timed(_split(k1), acc), _timed(k2, acc))}
            got = {mode: {"wall": [], "host": [], "n": None}
                   for mode in wrap}
            for rnd in range(rounds + 1):
                order = ("one", "two") if rnd % 2 else ("two", "one")
                for mode in order:
                    kt.color_update, kt.color_update_emit = wrap[mode]
                    acc[0] = 0.0
                    before = dict(kt.LAUNCHES)
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    p, r, _ = solve_step(be, p, bs, r, m.cfg)
                    torch.cuda.synchronize(dev)
                    wall = (time.perf_counter() - t0) * 1e3
                    if rnd == 0:        # warm-up round
                        continue
                    got[mode]["wall"].append(wall)
                    got[mode]["host"].append(acc[0] * 1e3)
                    got[mode]["n"] = sum(kt.LAUNCHES[k] - before[k]
                                         for k in keys)
            for mode, g in got.items():
                pre = f"phase{phase}_{mode}"
                emit(rows, f"{pre}_fcycle_ms", g["wall"])
                emit(rows, f"{pre}_fcycle_median_ms",
                     statistics.median(g["wall"]))
                emit(rows, f"{pre}_k1k2_host_ms",
                     statistics.median(g["host"]))
                emit(rows, f"{pre}_launches", g["n"])
            emit(rows, f"phase{phase}_two_minus_one_ms", statistics.median(
                b - a for a, b in zip(got["one"]["wall"],
                                      got["two"]["wall"])))
            del m, be, p, bs, r, u, v, w
            torch.cuda.empty_cache()
    finally:
        kt.color_update, kt.color_update_emit = k1, k2
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("memory", "launches"))
    ap.add_argument("--phases", type=int, nargs="*")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args(argv)
    if args.what == "memory":
        memory(None, tuple(args.phases or (4, 8, 9, 12, 14)), args.eager)
    else:
        launches(None, tuple(args.phases or (8, 10)), args.rounds)


if __name__ == "__main__":
    main()
