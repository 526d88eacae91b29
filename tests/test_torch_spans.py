"""The port's spans (mgroms_tpu_torch/utils/tictoc.py: record_spans, span,
spans, report_spans) on the CPU at seamount 16^3:

- off (the default), a solve leaves no record and opens no profiler range;
- on, ``NHModel.solve`` is one ``step`` with ``rhs``, ``solve`` and
  ``project`` under it and the solve's ``prologue``, ``fcycle`` (one a
  convergence step), ``read`` (2 + checks + 1) and ``result`` under
  ``solve``, all with the step's root id; the pieces called one by one
  give the same spans without the step;
- each span is a ``mg.<name>`` range under the profiler, nested as
  recorded; ``reset()`` clears the records; off the card no span has
  device times; the drivers' ``--profile`` prints them.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.utils import tictoc as ttt

torch.set_num_threads(1)

N = 16
TOL = 1e-8


def _model(**cfg):
    m = NHModel(N, N, N, cfg=SolverConfig(**cfg), device="cpu")
    c = setup_seamount(N, N, N)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


@pytest.fixture(scope="module")
def velocities():
    return initial_velocities(N, N, N, device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and no record."""
    ttt.record_spans(False)
    ttt.reset_tictoc()
    yield
    ttt.record_spans(False)
    ttt.reset_tictoc()


def _traced_solve(m, vel, **kw):
    ttt.record_spans(True)
    out = m.solve(*vel, tol=TOL, **kw)
    ttt.record_spans(False)
    return out[-1], ttt.spans()


def _children(records, parent):
    return [s.name for s in records if s.parent == parent]


def _mg_events(prof):
    """(name, start ns, end ns) of the profiler's ``mg.*`` host ranges."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("mg.")]


def test_spans_off_leave_no_record_and_open_no_range(model, velocities):
    assert not ttt._GLOBAL.spans_on
    assert ttt.span("rhs") is ttt.span("solve")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.solve(*velocities, tol=TOL)
    assert ttt.spans() == []
    assert _mg_events(prof) == []
    assert not ttt._GLOBAL._closed and not ttt._GLOBAL._stack


@pytest.mark.parametrize("cpc", [1, 2])
def test_one_solve_gives_the_span_tree(velocities, cpc):
    m = _model(cycles_per_check=cpc)
    info, recs = _traced_solve(m, velocities)
    step, = [s for s in recs if s.name == "step"]
    assert step.parent is None and step.root == step.id
    assert all(s.root == step.id for s in recs)
    assert _children(recs, step.id) == ["rhs", "solve", "project"]
    solve, = [s for s in recs if s.name == "solve"]
    checks = info.niter // cpc
    assert checks >= 2
    assert _children(recs, solve.id) == (
        ["prologue", "read", "read"] + ["fcycle", "read"] * checks
        + ["result", "read"])
    for name in ("rhs", "solve", "prologue", "project"):
        assert sum(s.name == name for s in recs) == 1, name
    # nothing deeper than the solve's children
    assert {s.parent for s in recs} == {None, step.id, solve.id}
    # off the card every span is the host's alone
    assert all(s.device_ms is None for s in recs)
    assert all(s.end_ns >= s.start_ns for s in recs)
    assert step.start_ns <= min(s.start_ns for s in recs)
    assert step.end_ns >= max(s.end_ns for s in recs)


@pytest.mark.parametrize("cpc", [1, 2])
def test_fcycle_spans_count_the_convergence_steps(velocities, cpc):
    m = _model(cycles_per_check=cpc)
    info, recs = _traced_solve(m, velocities)
    assert info.niter % cpc == 0
    assert sum(s.name == "fcycle" for s in recs) == info.niter // cpc


@pytest.mark.parametrize("cpc", [1, 2])
def test_read_spans_count_the_host_reads(velocities, cpc):
    """2 in the prologue (||r0|| and ||b||), one a check, and the closing
    synchronisation."""
    m = _model(cycles_per_check=cpc)
    info, recs = _traced_solve(m, velocities)
    assert sum(s.name == "read" for s in recs) == 2 + info.niter // cpc + 1


def test_device_loop_spans(velocities):
    """The device loop's eager form (the CPU): the condition read once a
    check and once more, the history read once, the closing
    synchronisation; one fcycle a check."""
    m = _model(device_loop=True)
    info, recs = _traced_solve(m, velocities)
    checks = info.niter
    solve, = [s for s in recs if s.name == "solve"]
    assert _children(recs, solve.id) == (
        ["prologue"] + ["read", "fcycle"] * checks
        + ["read", "read", "result", "read"])


def test_pieces_give_the_same_spans(model, velocities):
    """rhs, pressure_solve and project called one by one: the step's
    spans without the step, each piece a root of its own."""
    _, whole = _traced_solve(model, velocities)
    ttt.reset_tictoc()
    ttt.record_spans(True)
    b = model.rhs(*velocities)
    p, info = model.pressure_solve(b, tol=TOL)
    model.project(p, *velocities)
    ttt.record_spans(False)
    recs = ttt.spans()
    assert [s.name for s in recs] == [s.name for s in whole
                                      if s.name != "step"]
    roots = [s for s in recs if s.parent is None]
    assert [s.name for s in roots] == ["rhs", "solve", "project"]
    solve = roots[1]
    assert all(s.root == solve.id for s in recs if s.parent is not None)


def test_profiler_ranges_nest_as_recorded(model, velocities):
    ttt.record_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.solve(*velocities, tol=TOL)
    ttt.record_spans(False)
    recs = ttt.spans()
    evs = sorted(_mg_events(prof), key=lambda e: e[1])
    assert [e[0] for e in evs] == ["mg." + s.name for s in recs]
    # the ranges open in the order the spans did; each lies inside the
    # range of its recorded parent
    for s, e in zip(recs, evs):
        if s.parent is not None:
            up = evs[s.parent]
            assert up[1] <= e[1] and e[2] <= up[2], (s.name, up[0])


def test_reset_clears_the_records(model, velocities):
    _traced_solve(model, velocities)
    assert ttt.spans()
    ttt.reset_tictoc()
    assert ttt.spans() == []
    # ids start again at 0
    ttt.record_spans(True)
    with ttt.span("x"):
        pass
    assert ttt.spans()[0].id == 0 and ttt.spans()[0].root == 0


def test_report_spans_means():
    recs = [ttt.Span(0, None, 0, "step", 0, 4_000_000, None),
            ttt.Span(1, 0, 0, "fcycle", 0, 1_000_000, 2.0),
            ttt.Span(2, 0, 0, "fcycle", 0, 3_000_000, 4.0)]
    lines = ttt.report_spans(recs).splitlines()
    assert lines[0].split() == ["span", "spans", "host", "ms", "device",
                                "ms"]
    assert lines[1].split() == ["step", "1", "4.0000", "-"]
    assert lines[2].split() == ["fcycle", "2", "2.0000", "3.0000"]


def test_driver_profile_prints_the_spans(monkeypatch, tmp_path, capsys):
    from mgroms_tpu_torch.drivers.seamount import main
    monkeypatch.chdir(tmp_path)
    main(["--nx", "16", "--ny", "16", "--nz", "16", "--device", "cpu",
          "--tol", "1e-4", "--maxiter", "5", "--profile"])
    out = capsys.readouterr().out.splitlines()
    head = next(i for i, line in enumerate(out)
                if line.split() == ["span", "spans", "host", "ms",
                                    "device", "ms"])
    rows = {line.split()[0]: int(line.split()[1]) for line in out[head + 1:]}
    assert set(rows) == {"step", "rhs", "solve", "prologue", "read",
                         "fcycle", "result", "project"}
    assert rows["step"] == rows["solve"] == 1
    assert not ttt._GLOBAL.spans_on
