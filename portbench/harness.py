"""One run of one cell: load, make the inputs, warm up, run the window,
check, and return the result line's object.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<mix>.json``, read by
``generator.py``) and, through the ``per_layer`` entries, the readers of
its per-layer metrics (``metrics/<name>.py``); the harness finds each by
its name and needs no edit for a new one.

The program is used through its public entry alone: ``NHModel`` and
``SolverConfig``, and ``capture.CapturedStep`` for the graph census.  A
step is ``NHModel.solve(u, v, w, tol)`` (rhs, solve_p, correct_uvw) on the
next field of the pool, ended by a device synchronisation.  With tracing
on, the step runs the same three pieces one by one (``rhs``,
``pressure_solve``, ``project``) between CUDA events, and a few steps run
under the profiler after the window.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import cases, check, generator, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mgroms_tpu")
# device events a traced segment may hold: the profiler loses some on
# traces of some 40k kernels
TRACE_EVENTS = 50_000


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    tops = {name.split(".")[0] for name in sys.modules}
    return sorted(tops.intersection(FORBIDDEN))


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell's entry, its configuration, its mix and the names of the
    metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((root / entry["file"]).read_text())

    def mine(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        cell=cell, conf=conf, mix=generator.load(cell["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Marks:
    """Time marks within a step: CUDA events on the card (device
    timestamps, read after the window), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def fields_fcycles(win, npool: int) -> list:
    """The F-cycles the window's solves of each field of the pool ran
    (the distinct counts, field by field)."""
    return [sorted(set(win.niters[f::npool])) for f in range(npool)]


def tenths(xs: list) -> list:
    """The medians of ``xs`` cut into ten runs of consecutive items."""
    n = len(xs)
    return [round(statistics.median(xs[i * n // 10:(i + 1) * n // 10]), 3)
            for i in range(10) if (i + 1) * n // 10 > i * n // 10]


def take_peak(dev: torch.device) -> int:
    """The device's peak of allocated bytes since the last call (or the
    process's start); each call starts a new peak.  0 off the card."""
    if dev.type != "cuda":
        return 0
    v = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return v


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Cell:
    """A cell's program and inputs on one device: the case, the model with
    its matrices set, and the pool of input fields (:meth:`load_pool`)."""

    def __init__(self, c: SimpleNamespace, device: torch.device,
                 shape=None):
        from mgroms_tpu_torch import NHModel, SolverConfig
        self.c, self.dev = c, device
        conf = c.conf
        if conf["npxg"] * conf["npyg"] != 1:
            raise ValueError("the harness runs a configuration on one "
                             "device, undistributed (npxg = npyg = 1)")
        self.nz, self.ny, self.nx = shape or (conf["nz"], conf["ny"],
                                              conf["nx"])
        self.case = cases.build(conf, self.nx, self.ny)
        fields = {f.name for f in dataclasses.fields(SolverConfig)}
        cfg = SolverConfig(**{k: v for k, v in conf.items() if k in fields})
        self.tol = cfg.solver_prec
        self.model = NHModel(self.nx, self.ny, self.nz, cfg=cfg,
                             device=device)
        self.model.set_matrices(self.case.dx, self.case.dy, self.case.zeta,
                                self.case.h, hc=self.case.hc,
                                theta_b=self.case.theta_b,
                                theta_s=self.case.theta_s)
        self.cuda = device.type == "cuda"
        self.marks = Marks(device)
        self.pool = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def load_pool(self, seed: int) -> None:
        self.pool = []          # the old pool goes before the new is made
        self.pool = generator.make_pool(self.c.mix, self.nx, self.ny,
                                        self.nz, seed, self.model.dtype,
                                        self.dev)

    def whole(self, i: int):
        """Step ``i``: (outputs u, v, w, p; SolveInfo; its time marks)."""
        u, v, w = self.pool[i % len(self.pool)]
        e0 = self.marks.mark()
        u2, v2, w2, p, info = self.model.solve(u, v, w, tol=self.tol)
        e1 = self.marks.mark()
        return (u2, v2, w2, p), info, (e0, e1)

    def pieces(self, i: int):
        """Step ``i`` through rhs, pressure_solve and project, with marks
        between them."""
        m = self.model
        u, v, w = self.pool[i % len(self.pool)]
        e0 = self.marks.mark()
        b = m.rhs(u, v, w)
        e1 = self.marks.mark()
        p, info = m.pressure_solve(b, tol=self.tol)
        e2 = self.marks.mark()
        u2, v2, w2 = m.project(p, u, v, w)
        e3 = self.marks.mark()
        return (u2, v2, w2, p), info, (e0, e1, e2, e3)

    def warm(self, trace: bool) -> None:
        """Every field of the pool once, and ``check_samples`` more steps,
        holding the outputs of the last ``check_samples`` steps as the
        window holds its samples: the first step captures the graph, and
        the device allocator holds every block the window will ask for.
        Where traced, the same through the pieces."""
        k = self.c.mix["check_samples"]
        for step in (self.whole, self.pieces) if trace else (self.whole,):
            held = []
            for i in range(len(self.pool) + k):
                held = (held + [step(i)[0]])[-k:]
                self.sync()
            del held

    def window(self, seconds: float, trace: bool,
               seed: int) -> SimpleNamespace:
        """Steps one after another for ``seconds``, each waited for; keeps
        ``check_samples`` steps' outputs drawn uniformly from the seed
        (reservoir sampling)."""
        step = self.pieces if trace else self.whole
        rng = random.Random(seed)
        k = self.c.mix["check_samples"]
        samples, spans, niters, own, failed = [], [], [], [], 0
        n = 0
        t0 = time.perf_counter()
        while True:
            out, info, ev = step(n)
            self.sync()
            spans.append(ev)
            niters.append(info.niter)
            own.append(info.res)
            failed += not (info.res <= self.tol)
            j = n if n < k else rng.randrange(n + 1)
            if j < k:
                slot = (n % len(self.pool), out)
                if j < len(samples):
                    samples[j] = slot
                else:
                    samples.append(slot)
            n += 1
            del out
            if time.perf_counter() - t0 >= seconds:
                break
        return SimpleNamespace(wall_s=time.perf_counter() - t0, n=n,
                               spans=spans, niters=niters, own_res=own,
                               failed=failed,
                               samples=samples)

    def census(self):
        """Nodes and launches by kernel of the graph the solve replays."""
        from mgroms_tpu_torch.capture import CapturedStep
        for g in getattr(self.model.backend, "graphs", {}).values():
            if isinstance(g, CapturedStep):
                return {"nodes": g.nodes, "launches": dict(g.launches)}
        return None

    def traced(self, first: int, census):
        """A few steps through the pieces under the profiler."""
        from . import trace as tracing
        nodes = census["nodes"] if census else 1
        nprof = max(1, min(8, TRACE_EVENTS // max(nodes, 1)))
        cpc = self.model.cfg.cycles_per_check

        def run_prof():
            fc = rp = 0
            for i in range(nprof):
                _, info, _ = self.pieces(first + i)
                fc += info.niter
                rp += info.niter // cpc
            return fc, (rp if census else 0)

        tracing.profile_warmup()
        return tracing.traced(run_prof, self.sync)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", shape=None, t_start=None) -> dict:
    """One run of ``workload``.  ``device='cpu'`` and ``shape`` (nz, ny,
    nx) are for the tests: the command line runs on the card at the
    configuration's shape."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = load_cell(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < c.cell["chips"]):
            raise NoCard(f"{workload} needs {c.cell['chips']} CUDA "
                         f"device(s); torch sees "
                         f"{torch.cuda.device_count()}")
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    parts = {"imports and card": time.perf_counter() - t_start}
    t = time.perf_counter()
    s = Cell(c, dev, shape)
    s.sync()
    parts["case and set_matrices"] = time.perf_counter() - t
    peak_build = take_peak(dev)
    t = time.perf_counter()
    s.load_pool(seed)
    s.sync()
    parts["pool"] = time.perf_counter() - t
    t = time.perf_counter()
    s.warm(trace)
    parts["warm-up and capture"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    peak_warm = take_peak(dev)
    print(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), file=sys.stderr)

    win = s.window(seconds, trace, seed)
    peak_window = take_peak(dev)
    # the most the harness holds in the warm-up and the window: the pool
    # and the outputs of check_samples steps
    held = (nbytes(t for f in s.pool for t in f)
            + c.mix["check_samples"] * nbytes(win.samples[0][1]))
    solver_bytes = max(peak_build, peak_warm - held, peak_window - held)
    mk = s.marks
    step_ms = [mk.ms(e[0], e[-1]) for e in win.spans]
    census = s.census()
    tr = s.traced(win.n, census) if trace and s.cuda else None
    model = s.model
    levels = [(lv.nzg, lv.nyg, lv.nxg) for lv in model.levels]
    ctx = SimpleNamespace(
        step_ms=step_ms, niters=win.niters, census=census, trace=tr,
        physics_ms=[mk.ms(e[0], e[1]) + mk.ms(e[2], e[3])
                    for e in win.spans] if trace else None,
        solve_ms=[mk.ms(e[1], e[2]) for e in win.spans] if trace else None,
        work=work.fcycle_work(levels, model.cfg.ns_pre, model.cfg.ns_post,
                              torch.empty((), dtype=model.dtype)
                              .element_size()))

    # the program's state goes before the reference runs
    del model
    s.model = None
    gc.collect()
    if s.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.Reference(s.case, s.nz, dev)
    numbers = check.worst([check.readings(ref, s.pool[i], out)
                           for i, out in win.samples])
    numbers["failed"] = win.failed
    correct, shown = check.judge(numbers, check.limits(workload))
    del ref
    print(f"levels {levels}; steps {win.n}, the first five "
          f"{[round(x, 3) for x in step_ms[:5]]} ms, median "
          f"{statistics.median(step_ms):.3f} ms, by tenth of the window "
          f"{tenths(step_ms)} ms; F-cycles by field "
          f"{fields_fcycles(win, len(s.pool))}; reference check of "
          f"{len(win.samples)} steps (pool fields "
          f"{[i for i, _ in win.samples]}) in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    if trace:
        metrics = {}
        for m in c.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "step_ms": win.wall_s * 1e3 / win.n,
            "step_ms_p95": (statistics.quantiles(step_ms, n=20)[-1]
                            if win.n > 1 else step_ms[0]),
            "solver_mem_gib": solver_bytes / 2 ** 30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    result = {
        "correct": bool(correct), "attempted": win.n, "failed": win.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if s.cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if s.cuda else dev.type,
            "count": c.cell["chips"],
            "memory_peak_bytes": max(peak_build, peak_warm, peak_window),
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = shown
    return result
