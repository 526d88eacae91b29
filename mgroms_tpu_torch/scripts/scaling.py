"""Weak/strong scaling harness: the port of ``examples/scaling.py``.

The reference's cluster experiment scripts
(``examples/perf_caparmor/nh_perf_1.sh`` / ``nh_perf_2.sh``) sweep
npx = npy over the grid sizes.  Here each (grid, mesh) pair builds the
seamount case with ``SolverConfig(dtype, coarsest='direct')``, distributes
it (``NHModel.distribute``, ``--comm``) and times ``solver.cycle_step``
over 5 steps after one warm-up step (on the card with CUDA events on the
first device's stream, which every tile's program uses on a virtual
mesh; on the CPU the host clock), eagerly on every mesh, 1x1 included
(a distributed step cannot replay as a CUDA graph, so the overhead column
compares like with like); on the card the 1x1 replayed step
(capture.py) is an extra column.  Beside the times, the lock-step
runner's work per F-cycle by kind (parallel/mesh.COLLECTIVES: ppermute
rounds, psum/all-tile rounds, joins and splits of whole grids).

    python -m mgroms_tpu_torch.scripts.scaling --grids 128,256 \\
        --meshes 1x1,2x2 --nz 64 [--comm auto|gspmd|shard_map]

``--simulate N`` is a mesh of N copies of the card (a virtual mesh of one
card), or of the CPU under ``--device cpu``; without it the mesh takes
the visible cards.  On a virtual mesh the same silicon does the same work
whatever the mesh, so the last column is the overhead factor
``ovh = t / t_base`` (1.00 is free); on distinct cards the parallel
efficiency ``eff``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..cases.seamount import initial_velocities, setup_seamount
from ..config import SolverConfig
from ..model import NHModel
from ..parallel import mesh as pmesh
from ..solver import cycle_step, solve_init

REPS = 5
KINDS = ("ppermute", "psum", "join", "split")


class Row(NamedTuple):
    t: float                      # s per F-cycle, eager
    replay: Optional[float]       # s per replayed step (1x1 on the card)
    counts: dict                  # the runner's work per F-cycle, by kind
    backend: str                  # the backend's class
    probe: Any = None             # what run_one's ``probe`` returned


def _timed(fn, sync, on_card: bool) -> float:
    """Seconds per call of ``fn``, the mean of REPS after one warm-up."""
    fn()
    sync()
    if on_card:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    if on_card:
        b.record()
    sync()
    if on_card:
        return a.elapsed_time(b) / 1e3 / REPS
    return (time.perf_counter() - t0) / REPS


def run_one(nxg, nyg, nz, npx, npy, dtype, comm="auto", device="cuda",
            devices=None, probe: Optional[Callable] = None) -> Row:
    """One (grid, mesh) point: the model built and distributed over the
    first npx*npy of ``devices`` (default: ``device`` repeated), then
    :class:`Row`.  ``probe``, given the eager step (a callable) after the
    timed steps, e.g. a profiler trace: its result is ``Row.probe``."""
    device = torch.device(device)
    cfg = SolverConfig(dtype=dtype, coarsest="direct")
    m = NHModel(nxg, nyg, nz, cfg=cfg, device=device)
    c = setup_seamount(nxg, nyg, nz)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    if npx * npy > 1:
        m.distribute(npx, npy, devices=devices or [device] * (npx * npy),
                     comm=comm)
    be = m.backend
    u, v, w = initial_velocities(nxg, nyg, nz, dtype=m.dtype, device=device)
    p, b, r, _, _ = solve_init(be, be.place(0, m.rhs(u, v, w)))
    state = [p, r]

    def step():
        state[0], state[1] = cycle_step(be, state[0], b, state[1], cfg)

    be.synchronize()
    pmesh.reset_collectives()
    t = _timed(step, be.synchronize, be.on_card)
    done = pmesh.collectives()
    counts = {k: done[k] / (REPS + 1) for k in KINDS}
    probed = probe(step) if probe is not None else None
    replay = None
    if be.on_card and be.capturable:
        from ..capture import captured_step
        cs = captured_step(be, cfg)
        cs.load(state[0], b, state[1])
        replay = _timed(cs.replay, be.synchronize, True)
    return Row(t, replay, counts, type(be).__name__, probed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grids", default="128,256")
    ap.add_argument("--meshes", default="1x1,2x2")
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--dtype", default=None,
                    help="float32 on cuda, else float64")
    ap.add_argument("--simulate", type=int, default=0,
                    help="a virtual mesh of N copies of the device")
    ap.add_argument("--comm", default="auto",
                    choices=["auto", "gspmd", "shard_map"],
                    help="communication layer (NHModel.distribute)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "path")
    if args.simulate:
        devices = [device] * args.simulate
    elif on_card:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    dtype = args.dtype or ("float32" if on_card else "float64")
    virtual = len(set(devices)) < len(devices) or not on_card
    effcol = "ovh" if virtual else "eff"
    platform = "gpu" if on_card else "cpu"
    print(f"platform={platform} dtype={dtype} nz={args.nz} comm={args.comm}"
          f"{' (virtual mesh: ovh = t/t_base, ideal 1.00)' if virtual else ''}")
    print(f"{'grid':>6} {'mesh':>6} {'t/Fcycle':>10} {'Mdof/s':>8} "
          f"{'replay':>8} " + " ".join(f"{k:>8}" for k in KINDS)
          + f" {effcol:>6}")
    grids = [int(g) for g in args.grids.split(",")]
    meshes = [tuple(int(v) for v in mm.split("x"))
              for mm in args.meshes.split(",")]
    rows = []
    for g in grids:
        tbase = None
        for npx, npy in meshes:
            if len(devices) < npx * npy or g % npx or g % npy:
                continue
            row = run_one(g, g, args.nz, npx, npy, dtype, comm=args.comm,
                          device=device, devices=devices[:npx * npy])
            t = row.t
            n = npx * npy
            if tbase is None:
                tbase, nbase = t, n
                eff = 1.0
            elif virtual:
                eff = t / tbase
            else:
                eff = (tbase / t) * (nbase / n)
            replay = "-" if row.replay is None else f"{row.replay:8.4f}"
            print(f"{g:6d} {npx}x{npy:<4d} {t:10.4f} "
                  f"{g * g * args.nz / t / 1e6:8.1f} {replay:>8} "
                  + " ".join(f"{row.counts[k]:8.1f}" for k in KINDS)
                  + f" {eff:6.2f}", flush=True)
            rows.append(((g, npx, npy), row, eff))
    return rows


if __name__ == "__main__":
    main()
