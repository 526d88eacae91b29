"""``portbench/spans.py`` on synthetic spans and in one small CPU run: the
readings of a window's spans, None where the spans are missing; idle gaps
put down to the innermost program range; the tool's refusal of a program
that records no spans."""

import pytest

from mgroms_tpu_torch.utils import tictoc
from portbench import spans

Span = tictoc.Span


def _step(first: int, fcycles=(28.0, 30.0)):
    """One step's spans as NHModel.solve records them, ids from ``first``."""
    i = first
    out = [Span(i, None, i, "step", 0, 90_000_000, None),
           Span(i + 1, i, i, "rhs", 0, 1, 10.0),
           Span(i + 2, i, i, "solve", 0, 1, None),
           Span(i + 3, i + 2, i, "prologue", 0, 1, 2.0),
           Span(i + 4, i + 2, i, "read", 0, 1, None),
           Span(i + 5, i + 2, i, "read", 0, 1, None)]
    j = i + 6
    for ms in fcycles:
        out += [Span(j, i + 2, i, "fcycle", 0, 1, ms),
                Span(j + 1, i + 2, i, "read", 0, 1, None)]
        j += 2
    return out + [Span(j, i + 2, i, "result", 0, 1, 1.0),
                  Span(j + 1, i + 2, i, "read", 0, 1, None),
                  Span(j + 2, i, i, "project", 0, 1, 3.0)]


def test_readings_of_a_window():
    window = _step(0) + _step(100, fcycles=(29.0,))
    setup = [Span(7, None, 7, "capture", 0, 500_000_000, None)]
    r = spans.readings(window, setup)
    assert r == {"rhs_ms": 10.0, "project_ms": 3.0, "prologue_ms": 2.0,
                 "fcycle_ms": 29.0, "result_ms": 1.0,
                 "host_reads_per_step": 4.5, "capture_s": 0.5}


def test_readings_are_none_without_spans():
    r = spans.readings([], [])
    assert set(r.values()) == {None}
    # host spans alone (off the card): no device reading
    host = [s._replace(device_ms=None) for s in _step(0)]
    r = spans.readings(host)
    assert r["host_reads_per_step"] == 5.0
    assert r["rhs_ms"] is None and r["fcycle_ms"] is None
    assert spans.by_tenth(host, "rhs") is None


def test_by_tenth():
    window = [s for k in range(20) for s in _step(100 * k,
                                                  fcycles=(float(k),))]
    assert spans.by_tenth(window, "fcycle") == [0.5 + 2 * k
                                                for k in range(10)]


def test_idle_gaps_go_to_the_innermost_program_range():
    host = [("mg.step", 0, 100), ("mg.solve", 10, 90),
            ("mg.fcycle", 20, 40), ("cudaGraphLaunch", 21, 39),
            ("mg.read", 45, 50), ("mg.step", 200, 300),
            ("mg.rhs", 210, 220), ("aten::add", 211, 215)]
    gaps = [(25, 35), (46, 48), (60, 70), (95, 99), (120, 130),
            (212, 214), (250, 260)]
    by, in_solve = spans.idle_by_span(gaps, host)
    assert dict(by) == pytest.approx({
        "mg.fcycle": 10e-6, "mg.read": 2e-6, "mg.solve": 10e-6,
        "mg.step": 14e-6, "outside the program": 10e-6, "mg.rhs": 2e-6})
    assert in_solve == pytest.approx(22e-6)
    assert spans.idle_by_span([(1, 2)], [])[0] == {
        "outside the program": 1e-6}


def test_a_cpu_run_reads_the_host_reads_and_no_device_time():
    out = spans.run("cuc1024-direct.steps", 2 ** 31 + 77, 0.3,
                    device="cpu", shape=(8, 32, 32))
    w = out["window"]
    assert w["host_reads_per_step"] == 2 + w["fcycles_per_solve"] + 1
    for k in ("rhs_ms", "project_ms", "prologue_ms", "fcycle_ms",
              "result_ms", "capture_s"):
        assert w[k] is None, k
    assert "profiled" not in out and out["device"] == "cpu"
    assert not tictoc._GLOBAL.spans_on and tictoc.spans() == []


def test_a_program_without_spans_gives_no_result(monkeypatch, capsys):
    monkeypatch.delattr(tictoc, "record_spans")
    assert spans.main(["--workload", "cuc1024-direct.steps", "--seed", "1",
                       "--seconds", "1"]) == 1
    assert "no result" in capsys.readouterr().err
