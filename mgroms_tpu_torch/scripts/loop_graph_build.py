"""The one-off cost of the device loop's CUDA graph against its node count,
and the device loop's solve wall against the replayed host loop's.

For one model (seamount or CUC at the given grid, float32, the default
configuration or ``--use-pallas``) and each ``cycles_per_check``:

- the captured step (capture.CapturedStep): warm-up, capture and
  instantiation seconds, its node count;
- the device loop's graph as solve_p builds it (capture.DeviceLoop: the
  captured step cloned into the WHILE body as a child graph node): clone
  and instantiation seconds, the body's node count;
- the same graph built the other way, the step and the condition
  captured straight into the body (csrc/device_loop.cu's
  ``mg_capture_begin``: cudaStreamBeginCaptureToGraph): capture and
  instantiation seconds, the body's node count;
- ``--reps`` solves of ``--cycles`` F-cycles (tol 0) in the device loop
  and in the replayed host loop, in turns, after the build: their walls
  and equal histories.

One JSON line per ``cycles_per_check``.

    python -m mgroms_tpu_torch.scripts.loop_graph_build [--case seamount
        --nx 64 --ny 64 --nz 64 --cpc 1 2 --cycles 4 --reps 3
        --use-pallas]

Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import statistics
import time

import torch

from .. import NHModel, SolverConfig
from ..capture import (captured_loop, captured_step, graph_launches,
                       step_body)
from ..cases.cuc import setup_cuc_synthetic
from ..cases.seamount import initial_velocities, setup_seamount
from ..ops.kernels import _build, launches, set_launches
from ..ops.kernels import device_loop as kdl
from ..ops.kernels._build import check_launch, ptr
from ..solver import solve_p
from ._timing import card, card_line


def captured_build(be, step, cfg) -> dict:
    """The device loop's graph with the step and the condition captured
    straight into the WHILE body (cudaStreamBeginCaptureToGraph, torch's
    allocations routed to a memory pool of its own), not launched: the
    capture's and the instantiation's seconds, the body's node count (its
    kernel nodes held to the step's)."""
    lib = _build.load()
    dev = step.device
    bnorm = torch.zeros_like(step.rsq)
    buf = kdl.LoopBuffers(step.rsq, cfg.solver_maxiter + cfg.cycles_per_check)
    f64 = int(step.rsq.dtype == torch.float64)
    args = (ptr(step.rsq), ptr(bnorm), ptr(buf.it), ptr(buf.hist),
            ptr(buf.lim), cfg.cycles_per_check, ptr(buf.cont),
            ptr(buf.runs))
    g, body, h = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_ulonglong()
    e, inst_s = ctypes.c_void_p(), ctypes.c_double()
    saved = launches()
    pool = torch.cuda.MemPool()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    try:
        with torch.cuda.device(dev):
            rc = lib.mg_loop_graph_open(f64, *args, ctypes.byref(g),
                                        ctypes.byref(body), ctypes.byref(h))
        check_launch(rc, "mg_loop_graph_open")
        t0 = time.perf_counter()
        with torch.cuda.device(dev), torch.cuda.use_mem_pool(pool), \
                torch.cuda.stream(side):
            check_launch(lib.mg_capture_begin(side.cuda_stream, body.value),
                         "capture into the WHILE body")
            try:
                step_body(be, cfg, step)()
                rc = lib.mg_loop_condition_node(f64, *args, h.value,
                                                side.cuda_stream)
            finally:
                end = lib.mg_capture_end(side.cuda_stream)
            check_launch(rc or end, "capture into the WHILE body")
        torch.cuda.current_stream(dev).wait_stream(side)
        capture_s = time.perf_counter() - t0
        got, nodes = graph_launches(body.value)
        want = step.launches + collections.Counter(loop_condition=1)
        if got != want:
            raise AssertionError(f"captured body {dict(got)} != {dict(want)}")
        with torch.cuda.device(dev):
            check_launch(lib.mg_graph_instantiate(g.value, ctypes.byref(e),
                                                  ctypes.byref(inst_s)),
                         "mg_graph_instantiate")
    finally:
        set_launches(saved)
        lib.mg_graph_destroy(g.value, e.value)
    del pool
    return {"body_nodes": nodes, "capture_s": capture_s,
            "instantiate_s": inst_s.value}


def run(case="seamount", nx=64, ny=64, nz=64, cpcs=(1, 2), cycles=4,
        reps=3, use_pallas=False, device=None, setup=None) -> list:
    """One row (the module docstring) per ``cycles_per_check``
    (``setup``: the case at this grid, made here when not given)."""
    dev = card(device)
    c = setup or (setup_seamount(nx, ny, nz) if case == "seamount"
                  else setup_cuc_synthetic(nx, ny, nz))
    m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype="float32",
                                             use_pallas=use_pallas),
                device=dev)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    b = m.rhs(*initial_velocities(nx, ny, nz, dtype=m.dtype, device=dev))
    rows = []
    for cpc in cpcs:
        cfg = SolverConfig(dtype="float32", use_pallas=use_pallas,
                           cycles_per_check=cpc)
        step = captured_step(m.backend, cfg)
        loop = captured_loop(m.backend, cfg, cycles)
        captured = captured_build(m.backend, step, cfg)
        walls = {"device_loop": [], "replay": []}
        hist = {}
        for _ in range(reps + 1):
            for mode, kw in (("device_loop", dict(device_loop=True)),
                             ("replay", dict(device_loop=False))):
                _, info = solve_p(m.backend, b, cfg, tol=0.0,
                                  maxiter=cycles, **kw)
                walls[mode].append(info.time_s)
                hist[mode] = info.history
        if hist["device_loop"] != hist["replay"]:
            raise AssertionError(f"device loop {hist['device_loop']} != "
                                 f"replayed host loop {hist['replay']}")
        row = {"case": case, "grid": [nz, ny, nx], "use_pallas": use_pallas,
               "cycles_per_check": cpc, "cycles": cycles,
               "card": card_line(), "torch": torch.__version__,
               "step": {"nodes": step.nodes, "warmup_s": step.warmup_s,
                        "capture_s": step.capture_s,
                        "instantiate_s": step.instantiate_s},
               "loop": {"body_nodes": loop.body_nodes,
                        "clone_s": loop.clone_s,
                        "instantiate_s": loop.instantiate_s},
               "loop_captured": captured,
               "history": list(hist["replay"])}
        for mode, w in walls.items():
            row[f"{mode}_wall_s"] = statistics.median(w[1:])
            row[f"{mode}_wall_s_all"] = w
        rows.append(row)
        print(json.dumps({"loop_graph_build": row}), flush=True)
        m.backend.graphs.clear()
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("seamount", "cuc"),
                    default="seamount")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--cpc", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--use-pallas", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run(args.case, args.nx, args.ny, args.nz, tuple(args.cpc), args.cycles,
        args.reps, args.use_pallas, args.device)


if __name__ == "__main__":
    main()
