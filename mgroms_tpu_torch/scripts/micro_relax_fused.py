"""K6's forms at the full-layout levels of seamount 64^3 and CUC 1024^2 x
64, float32, timed on the card: the numbers behind the thresholds of
``ops/kernels/relax_fused.form``.

For each level (seamount levels 1-4, CUC levels 2-5; the coarsest with
ns_coarsest = 40 sweeps, the others with ns_pre = 3) and each ordering,
one row a form the level fits (``block``, ``cluster``, ``step``): ``ms``,
the median of 20 CUDA-event timings of one call (the host's enqueue
included where it is longer than the device's work); ``dev_ms``, the
device time of one call (the summed device ops of 20 calls under
torch.profiler, over 20); the form's launches, and for the one-launch
forms where the records live and the blocks; beside them the step floor
(K10 ``step_floor``, ncolor x nsweeps steps of a barrier and an nz-deep
chain) in one block and in a cluster, both times, and the form the gate
names.  ``dev_1sweep_ms`` (one-launch forms and the floor): the device
time of one sweep, which parts a call's fixed cost (launch, the records,
the state in and out) from its cost a sweep.  Every call is held to the
plain version bit for bit first.

    python -m mgroms_tpu_torch.scripts.micro_relax_fused
    PYTHONPATH=<an earlier checkout> python <this file> --gated
    PYTHONPATH=<an earlier checkout> python <this file> --histories
    python -m mgroms_tpu_torch.scripts.micro_relax_fused --ablation

``--gated`` times only ``relax_fused.fused_relax`` (the form the imported
package's gate picks) through the calls every tree of the port has, so
the same file, run by path against an earlier checkout, times that
tree's K6 at the same shapes in the same call.  ``--histories`` prints,
with every digit, the residual histories of the solves that run K6
(``chip_smoke.py`` phases 5, 6, 7, 15 and 16: float32, the same cycle
limits), through the public API any tree of the port has.
``--ablation`` times the one-launch forms at the coarsest levels and CUC
level 4 with and without the 'real' couplings.
"""

from __future__ import annotations

import argparse
import json

import torch

from mgroms_tpu_torch.ops.kernels import relax_fused as kf
from mgroms_tpu_torch.scripts._timing import card, card_line, median_ms

# (case, level, shape, sweeps)
LEVELS = [("seamount", 4, (4, 4, 4), 40), ("seamount", 3, (8, 8, 8), 3),
          ("seamount", 2, (16, 16, 16), 3), ("seamount", 1, (32, 32, 32), 3),
          ("cuc", 5, (2, 32, 32), 40), ("cuc", 4, (4, 64, 64), 3),
          ("cuc", 3, (8, 128, 128), 3), ("cuc", 2, (16, 256, 256), 3)]
NCOLOR = {"RB": 2, "FC": 4, "GS": 1}


def device_ms(fn, reps=20, warm=3, tries=3) -> float:
    """Device time of one call of ``fn`` from the device ops that ``reps``
    calls launch (torch.profiler, CUDA activity): their mean duration
    times the ops a call launches (the recorded ops over ``reps``,
    rounded).  The profiler now and then drops some of a trace's device
    events, or all: the mean of the rest stands for those, and a trace
    whose ops round to none a call is taken again, up to ``tries`` times,
    then raises."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        per_call = round(len(ops) / reps)
        if per_call >= 1:
            return sum(e.time_range.end - e.time_range.start
                       for e in ops) / len(ops) * per_call / 1e3
    raise RuntimeError(f"the profiler recorded {len(ops)} device ops of "
                       f"{reps} calls in each of {tries} traces")


def inputs(shape, dev, seed):
    """Bands with a dominant diagonal, state and RHS, from a seed."""
    nz, ny, nx = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=dev)
    cA = 0.2 * u(8, nz, ny + 2, nx + 2) - 0.1
    cA[0] -= 4.0
    return cA, 2 * u(*shape) - 1, 2 * u(*shape) - 1


def _forms(shape):
    """The forms that take a float32 level of ``shape``."""
    out = ["step"]
    if kf.fits(shape, 4, 1):
        out.insert(0, "block")
    if kf.cluster_takes(shape, torch.float32):
        out.insert(-1, "cluster")
    return out


def timed(dev=None, gated=False) -> list:
    """One row a (level, ordering, form); printed as JSON lines."""
    dev = card(dev)
    rows = []
    for case, lev, shape, ns in LEVELS:
        cA, p, b = inputs(shape, dev, sum(shape))
        for kind in ("RB", "FC", "GS"):
            want = kf.fused_relax_plain(p, b, cA, ns, kind, True)
            row = dict(case=case, level=lev, shape=list(shape), sweeps=ns,
                       kind=kind)
            if gated:
                got = kf.fused_relax(p, b, cA, ns, kind, True)
                assert torch.equal(got, want), (shape, kind)
                call = lambda: kf.fused_relax(p, b, cA, ns, kind, True)
                row.update(form=kf.launch_name(p, kind), ms=median_ms(call),
                           dev_ms=device_ms(call))
                rows.append(row)
                print(json.dumps(row), flush=True)
                continue
            from mgroms_tpu_torch.ops.kernels import roofline as rl
            x = p.contiguous()
            nsteps = NCOLOR[kind] * ns
            floors = {}
            for cl in (False, True):
                if (cl and "cluster" in _forms(shape)) or (
                        not cl and "block" in _forms(shape)):
                    key = "floor_cluster" if cl else "floor_block"
                    call = lambda: rl.step_floor(x, nsteps, cl)
                    floors[key + "_ms"] = median_ms(call)
                    floors[key + "_dev_ms"] = device_ms(call)
                    floors[key + "_dev_1sweep_ms"] = device_ms(
                        lambda: rl.step_floor(x, NCOLOR[kind], cl))
            for form in _forms(shape):
                plan = {}
                got = kf.fused_relax_form(p, b, cA, ns, kind, True, form,
                                          plan)
                assert torch.equal(got, want), (shape, kind, form)
                call = lambda: kf.fused_relax_form(p, b, cA, ns, kind, True,
                                                   form)
                one = dict(dev_1sweep_ms=device_ms(
                    lambda: kf.fused_relax_form(p, b, cA, 1, kind, True,
                                                form))) if form != "step" \
                    else {}
                r = dict(row, form=form, gate=kf.form(shape, p.dtype, kind),
                         ms=median_ms(call), dev_ms=device_ms(call), **one,
                         launches=(nsteps if form == "step" else 1),
                         **plan, **floors)
                rows.append(r)
                print(json.dumps(r), flush=True)
        del cA, p, b
        torch.cuda.empty_cache()
    return rows


# chip_smoke.py phases 5, 6, 7, 15, 16: (phase, grid, case, config,
# maxiter, tol)
SOLVES = [
    (5, (64, 64, 64), "seamount", dict(use_pallas=True), 3, 1e-4),
    (6, (1024, 1024, 64), "cuc", dict(use_pallas=True), 8, 1e-4),
    (7, (1024, 1024, 64), "cuc", dict(use_pallas=True, compact=False), 8,
     1e-4),
    (15, (1024, 1024, 64), "cuc", dict(relax_method="FC", use_pallas=True,
                                       compact=False), 3, 1e-4),
    (16, (1024, 1024, 64), "cuc", dict(relax_method="GS", use_pallas=True),
     2, 0.0),
]


def histories(dev=None) -> dict:
    """The residual history of each solve of :data:`SOLVES`, printed with
    every digit (repr)."""
    from mgroms_tpu_torch import NHModel, SolverConfig
    from mgroms_tpu_torch.cases.cuc import setup_cuc_synthetic
    from mgroms_tpu_torch.cases.seamount import (initial_velocities,
                                                 setup_seamount)
    dev = card(dev)
    out = {}
    for phase, (nx, ny, nz), case, cfg, maxiter, tol in SOLVES:
        c = (setup_seamount if case == "seamount"
             else setup_cuc_synthetic)(nx, ny, nz)
        m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype="float32", **cfg),
                    device=dev)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        u, v, w = initial_velocities(nx, ny, nz, dtype=m.dtype, device=dev)
        *_, info = m.solve(u, v, w, tol=tol, maxiter=maxiter)
        out[phase] = [repr(float(h)) for h in info.history]
        print(json.dumps({"phase": phase, "history": out[phase]}),
              flush=True)
        del m, c, u, v, w
        torch.cuda.empty_cache()
    return out


# the one-launch forms' ablation: (shape, sweeps, form)
ABLATION = [((2, 32, 32), 40, "block"), ((4, 4, 4), 40, "block"),
            ((4, 64, 64), 3, "cluster")]


def ablation(dev=None) -> list:
    """Device time of each one-launch form of :data:`ABLATION` in each
    ordering with and without the 'real' couplings (the plane-0
    diagonal terms, RB's snapshot)."""
    dev = card(dev)
    rows = []
    for shape, ns, form in ABLATION:
        cA, p, b = inputs(shape, dev, sum(shape))
        for kind in ("RB", "FC", "GS"):
            for real in (True, False):
                call = lambda: kf.fused_relax_form(p, b, cA, ns, kind, real,
                                                   form)
                want = kf.fused_relax_plain(p, b, cA, ns, kind, real)
                assert torch.equal(call(), want), (shape, kind, real)
                r = dict(shape=list(shape), sweeps=ns, form=form, kind=kind,
                         real=real, dev_ms=device_ms(call),
                         ms=median_ms(call))
                rows.append(r)
                print(json.dumps(r), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gated", action="store_true",
                    help="time only the gate's form (any tree of the port)")
    ap.add_argument("--histories", action="store_true",
                    help="print the histories of the solves that run K6")
    ap.add_argument("--ablation", action="store_true",
                    help="the one-launch forms with and without 'real'")
    ap.add_argument("--label", default="", help="printed with the card")
    args = ap.parse_args()
    print(json.dumps({"card": card_line(), "label": args.label}))
    if args.ablation:
        ablation()
    elif args.histories:
        histories()
    else:
        timed(gated=args.gated)


if __name__ == "__main__":
    main()
