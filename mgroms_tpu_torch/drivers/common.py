"""Shared driver scaffolding (the reference drivers are diff-identical apart
from the case setup — mg_testseamount.f90 / mg_testrndtopo.f90 /
mg_testcuc.f90).  Prints the same summary lines and the same tictoc
table as ``mgroms_tpu.drivers.common.run_case``, so runs of the two
packages compare line by line.

``--npx/--npy`` distribute the solve (NHModel.distribute): on ``--device
cpu`` over the CPU repeated npx*npy times (as the JAX package's forced
host device count gives on the CPU), on ``cuda`` over the visible cards
(fewer than npx*npy raises), with ``--comm`` the layer
(NHModel.distribute).  ``--profile`` profiles one F-cycle per level
and section after the solve (utils/tictoc.profile_fcycle; on the card
re-timed from CUDA graphs, but for a distributed backend, whose table
stays host seconds), prints K4's launch plans (utils/tictoc.report_plans)
and then the spans of one more solve, made after the timed ones
(utils/tictoc.report_spans: host ms, and on one card device ms, of the
step's phases)."""

from __future__ import annotations

import argparse
import time

import torch

from ..cases.seamount import initial_velocities
from ..config import SolverConfig, read_namelist
from ..model import NHModel
from ..utils import tictoc


def base_parser(nx=64, ny=64, nz=64) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=nx)
    p.add_argument("--ny", type=int, default=ny)
    p.add_argument("--nz", type=int, default=nz)
    p.add_argument("--npx", type=int, default=1,
                   help="device-mesh extent in x (reference npxg)")
    p.add_argument("--npy", type=int, default=1)
    p.add_argument("--comm", default="auto",
                   choices=["auto", "gspmd", "shard_map"],
                   help="distributed communication layer (auto: shard_map "
                        "when the sharded compact smoother is eligible, "
                        "else gspmd)")
    p.add_argument("--namelist", default="nh_namelist",
                   help="Fortran-namelist config file (defaults if absent)")
    p.add_argument("--dtype", default=None,
                   help="override dtype (float32 on cuda, else float64)")
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--history", default="residual_history.txt",
                   help="residual-history file (reference fort.100)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    p.add_argument("--profile", action="store_true",
                   help="after the solve, profile one F-cycle per level/"
                        "section and print the reference-style table "
                        "(print_tictoc, mg_tictoc.f90:114-153), then the "
                        "spans of one more solve (utils/tictoc."
                        "report_spans)")
    return p


def run_case(args, case, nit: int = 1):
    """Initialise, assemble, solve, check — the body every reference driver
    shares (mg_testseamount.f90:64-204)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "path")
    dtype = args.dtype or ("float32" if device.type == "cuda" else "float64")
    cfg = read_namelist(args.namelist, base=SolverConfig(dtype=dtype))
    print("Initialise nhydro grids")
    m = NHModel(args.nx, args.ny, args.nz, cfg=cfg, device=device,
                verbose=True)
    t0 = time.perf_counter()
    tictoc.tic(0, "matrices")
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tictoc.toc(0, "matrices")
    print(f"time spent to assemble: {time.perf_counter() - t0:8.3f} s")
    n = args.npx * args.npy
    if n > 1:
        m.distribute(args.npx, args.npy,
                     devices=[device] * n if device.type == "cpu" else None,
                     comm=args.comm)

    print("Initialise u, v, w  (U=0, V=0, W=-1 except at bottom)")
    u, v, w = initial_velocities(args.nx, args.ny, args.nz, dtype=m.dtype,
                                 device=device)
    for _ in range(nit):
        print("Call nhydro solver")
        tictoc.tic(0, "solve")
        uc, vc, wc, p, info = m.solve(u, v, w, tol=args.tol,
                                      maxiter=args.maxiter, verbose=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tictoc.toc(0, "solve")
        print("--- summary ---")
        print(f"time spent to solve : {info.time_s:8.3f} s")
        print(f"rescaled performance: {info.rescaled_perf:10.3e}")
        print("---------------")
        with open(args.history, "w") as f:
            for i, r in enumerate(info.history):
                f.write(f"{r:.16e} {i}\n")
        print("Check nondivergence")
        div = float(m.check_nondivergence(uc, vc, wc))
        b0 = float(torch.max(torch.abs(m.rhs(u, v, w))))
        print(f"max |div| after correction: {div:.3e} (initial {b0:.3e})")
    if args.profile:
        # the step's phases in one more solve, so that the timed solves
        # above carry no span's cost
        tictoc.record_spans(True)
        try:
            m.solve(u, v, w, tol=args.tol, maxiter=args.maxiter)
            m.backend.synchronize()
        finally:
            tictoc.record_spans(False)
        # per-(level, section) breakdown of one F-cycle — the reference's
        # per-level table (tic/toc inside Fcycle/Vcycle, mg_relax.f90:128+,
        # mg_solvers.f90:45+); on the card each distinct call re-timed
        # from a CUDA graph, where the backend can be captured (a
        # distributed backend keeps the host seconds)
        print("Profiling one F-cycle per level/section ...")
        retime = m.backend.on_card and m.backend.capturable
        tictoc.profile_fcycle(m.backend, m._rhs_state(u, v, w), m.cfg,
                              device_timer=retime)
        if m.backend.on_card:
            print("per-level sections: " + (
                "card seconds, re-timed from CUDA graphs" if retime else
                "host seconds, each call waited for") + "; matrices, solve: "
                "host seconds")
        print("K4's launch plans (utils/tictoc.report_plans):")
        print(tictoc.report_plans())
    tictoc.print_tictoc()
    if args.profile:
        print("one more solve's spans (utils/tictoc.spans), a span's "
              "mean ms:")
        print(tictoc.report_spans())
    return m, info
