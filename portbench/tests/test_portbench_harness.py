"""The benchmark's harness on the CPU at a small CUC-shaped grid (the card
test runs it on the card): configurations, mixes, metric readers and
limits are found by name; BENCHMARK.json keeps its documented form; a
run's result line has its documented keys; the command fails without a card;
nothing it loads is JAX or the JAX package, and the reference loads
nothing of the program; the control and each fault a cell can have come
out not correct."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mgroms_tpu_torch import NHModel
from portbench import check, generator, harness, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SHAPE = (8, 32, 32)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def small_run(cell, seed=7, trace=False, seconds=0.3):
    return harness.run(cell, seed, seconds, trace, device="cpu",
                       shape=SHAPE)


def test_benchmark_json_keeps_its_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_configurations_mixes_metrics_and_limits_are_found_by_name():
    for cell in CELLS:
        c = harness.load_cell(cell)
        assert c.conf["name"] == c.cell["config"]
        assert c.mix["kind"] == "closed_loop_steps"
        assert set(check.limits(cell)) == set(check.HELD)
        assert c.per_layer and c.end_to_end
    for m in BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert generator.load("steps")["pool"] >= 1
    assert {cls for _, cls, _ in work.kernel_classes()} >= {
        "smooth", "residual_restrict"}


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_gives_the_result_keys(trace):
    cell = CELLS[0]
    r = small_run(cell, seed=2 ** 31 + 5, trace=trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    c = harness.load_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    for m in want:
        if m["name"] in r["metrics"]:
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
    for name in check.HELD:
        assert set(r["checks"][name]) == {"value", "limit"}


def test_the_same_seed_gives_the_same_inputs():
    mix = generator.load("steps") | {"pool": 2}
    a = generator.make_pool(mix, 16, 8, 4, 2 ** 31 + 3, torch.float32, "cpu")
    b = generator.make_pool(mix, 16, 8, 4, 2 ** 31 + 3, torch.float32, "cpu")
    c = generator.make_pool(mix, 16, 8, 4, 2 ** 31 + 4, torch.float32, "cpu")
    for fa, fb, fc in zip(a, b, c):
        for x, y, z in zip(fa, fb, fc):
            assert torch.equal(x, y) and not torch.equal(x, z)
            assert x.shape == z.shape


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


MODULES = """
import json, sys, torch
from portbench import harness
harness.run({cell!r}, 3, 0.2, {trace}, device="cpu", shape={shape!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys, torch
from portbench import cases, reference
import portbench, json as j
conf = j.loads(open("portbench/configs/cuc1024-direct.json").read())
case = cases.build(conf, 16, 8)
t = lambda a: torch.as_tensor(a, dtype=torch.float64)
cA, m = reference.assemble(t(case.dx), t(case.dy), t(case.zeta), t(case.h),
                           4, case.hc, case.theta_b, case.theta_s)
u = torch.zeros(4, 10, 17, dtype=torch.float64)
v = torch.zeros(4, 9, 18, dtype=torch.float64)
w = -torch.ones(5, 10, 18, dtype=torch.float64)
b = reference.divergence(m, u, v, w)
reference.residual(b, b, cA)
reference.project(m, b, u, v, w)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program(trace):
    p = subprocess.run([sys.executable, "-c", MODULES.format(
        cell=CELLS[0], trace=trace, shape=SHAPE)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "mgroms_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
    p = subprocess.run([sys.executable, "-c", REFERENCE], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not {t for t in tops if t.startswith("mgroms_tpu")}
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    c = harness.load_cell(cell)
    s = harness.Cell(c, torch.device("cpu"), SHAPE)
    s.load_pool(11)
    win = s.window(0.2, False, 11)
    ref = check.Reference(s.case, s.nz, "cpu")
    prog = [check.readings(ref, s.pool[i], o) for i, o in win.samples]
    ctrl = [check.readings(ref, s.pool[i],
                           check.control_outputs(s.case, s.nz, s.pool[i], o))
            for i, o in win.samples]
    lim = check.limits(cell)
    # the control reports no residual of its own: it passes that gate
    assert check.judge(check.worst(prog) | {"failed": win.failed}, lim)[0]
    assert not check.judge(check.worst(ctrl) | {"failed": 0}, lim)[0]


def unchanged(orig):
    """The step returns its state unchanged: the input velocities and a
    zero pressure."""
    def solve(self, u, v, w, tol=None, **kw):
        info = orig(self, u, v, w, tol=tol, **kw)[4]
        return u, v, w, torch.zeros(self.nz, self.ny, self.nx,
                                    dtype=u.dtype), info
    return solve


def half(orig):
    """Half of the domain left out: the second half of the rows keeps the
    input velocities and a zero pressure."""
    def solve(self, u, v, w, tol=None, **kw):
        u2, v2, w2, p, info = orig(self, u, v, w, tol=tol, **kw)
        j = self.ny // 2
        u2, v2, w2, p = u2.clone(), v2.clone(), w2.clone(), p.clone()
        u2[:, j + 1:] = u[:, j + 1:]
        v2[:, j + 1:] = v[:, j + 1:]
        w2[:, j + 1:] = w[:, j + 1:]
        p[:, j:] = 0.0
        return u2, v2, w2, p, info
    return solve


def altered(orig):
    """An answer altered where it is produced: the pressure at one point
    raised by its largest magnitude, the velocities as projected."""
    def solve(self, u, v, w, tol=None, **kw):
        u2, v2, w2, p, info = orig(self, u, v, w, tol=tol, **kw)
        p = p.clone()
        p[self.nz // 2, self.ny // 3, self.nx // 5] += p.abs().max()
        return u2, v2, w2, p, info
    return solve


def stopped(orig):
    """A solve stopped short of its tolerance, as its own report says: at
    this size one F-cycle reaches the tolerance, so the report is raised
    to ten times it and the outputs are kept."""
    def solve(self, u, v, w, tol=None, **kw):
        u2, v2, w2, p, info = orig(self, u, v, w, tol=tol, maxiter=1)
        return u2, v2, w2, p, info._replace(res=10 * tol)
    return solve


@pytest.mark.parametrize("fault", [unchanged, half, altered, stopped])
def test_each_fault_comes_out_not_correct(fault, monkeypatch):
    monkeypatch.setattr(NHModel, "solve", fault(NHModel.solve))
    r = small_run(CELLS[0], seed=19)
    assert r["correct"] is False
    if fault is stopped:
        assert r["failed"] == r["attempted"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_command_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", "31", "--seconds", "2", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
