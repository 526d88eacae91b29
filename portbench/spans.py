"""The program's spans in one cell: what the per-layer readers of the time
step's phases would read there.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

Not the benchmark's command, and no metric of ``BENCHMARK.json`` reads it:
the program records its spans only where the caller switches them on
(``mgroms_tpu_torch.utils.tictoc.record_spans``), and the harness does not
(``PERF.md`` §7 says which edit of ``harness.py`` and ``trace.py`` would).
It builds the cell as the harness does (``harness.Cell``, the same
configuration, traffic and seed) and, in one process with spans on:

1. sets the cell up (its ``capture`` spans);
2. runs a window of ``--seconds`` through the pieces, as the traced run's
   window runs: :func:`readings` of its spans, the median device ms of
   the ``rhs``, ``fcycle`` and ``project`` spans and the median host ms
   of the ``fcycle`` spans (the graph's launch) by tenth of the window,
   and the window's ``physics_ms`` and ``solve_ms`` from the harness's
   CUDA events;
3. on the card, profiles 8 more steps (``torch.profiler``): the idle
   share, :func:`idle_by_span` of its idle gaps, the device idle under
   ``mg.solve`` a solve, and the ``fcycle`` spans' host ms under the
   profiler against the window's (the profiler's cost in the launch).

Prints one JSON line.  It exits with 1 and prints no result where the
program records no spans.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Optional

import torch

from . import harness
from . import trace as tracing

PHASES = ("rhs", "fcycle", "project")
NPROF = 8


def _per(records, name: str, per: str = "solve") -> list:
    """For each ``per`` span, the device ms of its children named ``name``,
    summed (the solve's prologue is one span, the device loop's too)."""
    ids = {s.id for s in records if s.name == per}
    sums = collections.Counter()
    for s in records:
        if s.name == name and s.parent in ids and s.device_ms is not None:
            sums[s.parent] += s.device_ms
    return [sums[i] for i in ids if i in sums]


def _mean(xs) -> Optional[float]:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _device(records, name: str) -> list:
    return [s.device_ms for s in records
            if s.name == name and s.device_ms is not None]


def readings(window, setup=()) -> dict:
    """What the readers would read from a window's spans (and set-up's,
    for ``capture_s``); None where the spans are missing:

    - ``rhs_ms``, ``project_ms``, ``result_ms``: the mean device ms of
      the window's spans of that name;
    - ``prologue_ms``: the mean device ms of the prologue a solve;
    - ``fcycle_ms``: the mean device ms of one convergence step.  Its
      begin event is recorded before the graph's launch, after a host
      read has emptied the stream, so it holds the launch's wait;
    - ``host_reads_per_step``: ``read`` spans over ``solve`` spans;
    - ``capture_s``: the host seconds of every ``capture`` span, set-up
      and window together."""
    solves = sum(s.name == "solve" for s in window)
    caps = [s.host_ms for s in list(setup) + list(window)
            if s.name == "capture"]
    return {
        "rhs_ms": _mean(_device(window, "rhs")),
        "project_ms": _mean(_device(window, "project")),
        "prologue_ms": _mean(_per(window, "prologue")),
        "fcycle_ms": _mean(_device(window, "fcycle")),
        "result_ms": _mean(_device(window, "result")),
        "host_reads_per_step": (sum(s.name == "read" for s in window)
                                / solves if solves else None),
        "capture_s": sum(caps) / 1e3 if caps else None,
    }


def by_tenth(window, name: str) -> Optional[list]:
    """The median device ms of ``name``'s spans by tenth of the window."""
    xs = _device(window, name)
    return harness.tenths(xs) if len(xs) >= 10 else None


def idle_by_span(gaps, host):
    """(seconds of idle by the innermost ``mg.*`` range open at each gap's
    midpoint, "outside the program" where none is; seconds of idle inside
    an ``mg.solve`` range): ``trace._name_gaps`` over the program's ranges.
    ``gaps`` are (start, end) and ``host`` the profiler's host events
    (name, start, end), in microseconds."""
    ranges = [e for e in host if e[0].startswith("mg.")]
    by = tracing._name_gaps(gaps, ranges)
    if "host: none traced" in by:
        by["outside the program"] = by.pop("host: none traced")
    in_solve = tracing._name_gaps(
        gaps, [e for e in ranges if e[0] == "mg.solve"]).get("mg.solve", 0.0)
    return by, in_solve


def profiled(run_steps, sync) -> dict:
    """``run_steps()`` under the profiler, its device activity reduced by
    ``trace``'s helpers: the idle share, :func:`idle_by_span` and the
    device idle under ``mg.solve`` a solve."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        sync()
        window_s = time.perf_counter() - t0
    dev, host = tracing._raw_events(prof)
    busy = tracing._union((a, b) for _, a, b in dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by, in_solve = idle_by_span(gaps, host)
    solves = sum(e[0] == "mg.solve" for e in host)
    return {"idle_share": 100.0 * (1.0 - busy_s / window_s),
            "idle_s_by_span": dict(by.most_common()),
            "solve_idle_ms": (1e3 * in_solve / solves if solves else None)}


def run(workload: str, seed: int, seconds: float, device: str = "cuda",
        shape=None) -> dict:
    """The JSON line's object (module docstring).  ``device='cpu'`` and
    ``shape`` are for the tests; off the card nothing is profiled."""
    from mgroms_tpu_torch.utils import tictoc
    if not hasattr(tictoc, "record_spans"):
        raise LookupError("the program records no spans")
    c = harness.load_cell(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    tictoc.reset_tictoc()
    tictoc.record_spans(True)
    try:
        s = harness.Cell(c, dev, shape)
        s.load_pool(seed)
        s.warm(True)
        s.sync()
        setup = tictoc.spans()
        tictoc.reset_tictoc()
        out = {"workload": workload, "seed": seed,
               "census_nodes": (s.census() or {}).get("nodes")}

        win = s.window(seconds, True, seed)
        window = tictoc.spans()
        tictoc.reset_tictoc()
        mk = s.marks
        out["window"] = {
            "steps": win.n, "step_ms": win.wall_s * 1e3 / win.n,
            "fcycles_per_solve": _mean(win.niters),
            # the harness's --trace 1 arithmetic of its CUDA events
            "physics_ms": _mean(mk.ms(e[0], e[1]) + mk.ms(e[2], e[3])
                                for e in win.spans),
            "solve_ms": _mean(mk.ms(e[1], e[2]) for e in win.spans),
            **readings(window, setup)}
        out["by_tenth"] = {n: by_tenth(window, n) for n in PHASES}
        host_fc = [x.host_ms for x in window if x.name == "fcycle"]
        out["fcycle_host_ms_by_tenth"] = (harness.tenths(host_fc)
                                          if len(host_fc) >= 10 else None)

        if s.cuda:
            tracing.profile_warmup()

            def steps():
                for i in range(NPROF):
                    s.pieces(win.n + i)

            out["profiled"] = profiled(steps, s.sync)
            fc = [x.host_ms for x in tictoc.spans() if x.name == "fcycle"]
            out["fcycle_host_ms"] = {"profiler off (window)": _mean(host_fc),
                                     "profiler on": _mean(fc)}
    finally:
        tictoc.record_spans(False)
        tictoc.reset_tictoc()
    out["device"] = (torch.cuda.get_device_name(dev) if s.cuda
                     else dev.type)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds)
    except LookupError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 1
    w = out["window"]
    print(f"window: {w['steps']} steps, {w['step_ms']:.3f} ms a step; "
          f"rhs {w['rhs_ms']} + project {w['project_ms']} ms against "
          f"physics {w['physics_ms']} ms; prologue {w['prologue_ms']} + "
          f"fcycle {w['fcycle_ms']} + result {w['result_ms']} ms against "
          f"solve {w['solve_ms']} ms; reads a solve "
          f"{w['host_reads_per_step']}; capture {w['capture_s']} s",
          file=sys.stderr)
    for n, xs in out["by_tenth"].items():
        print(f"{n} device ms by tenth of the window {xs}", file=sys.stderr)
    if "profiled" in out:
        p = out["profiled"]
        print(f"profiled: idle {p['idle_share']:.2f} %, solve idle "
              f"{p['solve_idle_ms']} ms a solve, idle s by span "
              f"{p['idle_s_by_span']}; fcycle host ms "
              f"{out['fcycle_host_ms']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
