"""The seamount at the reference's scaling grid (portbench cell
``seamount1024x128-direct.steps``) on the CPU, at small deep shapes.

The benchmark's copy of the case equals the program's ``setup_seamount``
bit for bit; the port's ``NHModel.solve`` on the seamount, more planes
than columns, hc = Htot and theta = 0, agrees with the benchmark's plain
reference on seeded pool fields (float64 to the tolerance and round-off;
float32 within the cell's limits, where the bfloat16 control fails them);
the 1024^2 x 128 grid plans 7 levels; the cell's eight per-layer readers
give a number or nothing on a CPU run; K4's launch-plan record
(``sweep_fused.PLANS``) is printed by ``tictoc.report_plans``, cleared by
the reset and never written on the CPU path.
"""

import numpy as np
import pytest
import torch

from mgroms_tpu_torch.cases.seamount import setup_seamount
from mgroms_tpu_torch.levels import build_level_plan
from mgroms_tpu_torch.ops import kernels
from mgroms_tpu_torch.ops.kernels import sweep_fused
from mgroms_tpu_torch.utils import tictoc
from portbench import cases, check, harness

torch.set_num_threads(1)

CELL = "seamount1024x128-direct.steps"
# more planes than columns, as the cell's columns are deeper than its
# cells are wide
SHAPE = (32, 16, 16)
METRICS = ("seamount_smooth_roofline", "seamount_fcycles_per_solve",
           "seamount_solve_ms", "sweep_resident_warps", "seamount_physics_ms",
           "seamount_graph_nodes", "seamount_residual_restrict_roofline",
           "seamount_idle_share", "sweep_planes_in_flight")


def small_cell(pool=2, **conf):
    """The cell with a pool of ``pool`` fields and ``conf`` over its
    configuration's keys."""
    c = harness.load_cell(CELL)
    c.conf = dict(c.conf, **conf)
    c.mix = dict(c.mix, pool=pool)
    return c


def test_the_case_copy_is_the_programs_case():
    conf = harness.load_cell(CELL).conf
    nx, ny = 13, 7
    got = cases.build(conf, nx, ny)
    want = setup_seamount(nx, ny, conf["nz"], Lx=conf["Lx"], Ly=conf["Ly"],
                          Htot=conf["Htot"], hc=conf["hc"],
                          theta_b=conf["theta_b"], theta_s=conf["theta_s"])
    for name in ("dx", "dy", "zeta", "h"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.hc, got.theta_b, got.theta_s) == (want.hc, want.theta_b,
                                                  want.theta_s)
    assert (conf["hc"], conf["theta_b"], conf["theta_s"]) == (4000.0, 0.0,
                                                              0.0)


def test_the_scaling_grid_plans_seven_levels():
    plan = build_level_plan(1024, 1024, 128)
    assert [(s.nzg, s.nyg, s.nxg) for s in plan] == [
        (128 >> k, 1024 >> k, 1024 >> k) for k in range(7)]
    assert (plan[-1].nzg, plan[-1].nyg, plan[-1].nxg) == (2, 16, 16)


def _steps(c, seed):
    """The cell's model at SHAPE on the CPU, its pool from ``seed``, and
    each field's (inputs, outputs, SolveInfo)."""
    s = harness.Cell(c, torch.device("cpu"), SHAPE)
    s.load_pool(seed)
    out = []
    for u, v, w in s.pool:
        u2, v2, w2, p, info = s.model.solve(u, v, w, tol=s.tol)
        out.append(((u, v, w), (u2, v2, w2, p), info))
    return s, out


def test_float64_solve_agrees_with_the_reference():
    tol = 1e-10
    s, steps = _steps(small_cell(dtype="float64", solver_prec=tol),
                      2 ** 31 + 17)
    ref = check.Reference(s.case, s.nz, "cpu")
    for inputs, outputs, info in steps:
        assert outputs[3].dtype == torch.float64 and info.res <= tol
        r = check.readings(ref, inputs, outputs)
        assert r["res"] < tol and r["res_max"] < 10 * tol
        assert r["proj_gap"] < 1e-11


def test_float32_solve_within_the_limits_and_the_control_out():
    s, steps = _steps(small_cell(), 2 ** 31 + 23)
    ref = check.Reference(s.case, s.nz, "cpu")
    lim = check.limits(CELL)
    prog = [check.readings(ref, i, o) for i, o, _ in steps]
    ctrl = [check.readings(ref, i, check.control_outputs(s.case, s.nz, i, o))
            for i, o, _ in steps]
    failed = sum(not info.res <= s.tol for _, _, info in steps)
    assert check.judge(check.worst(prog) | {"failed": failed}, lim)[0]
    assert not check.judge(check.worst(ctrl) | {"failed": 0}, lim)[0]


def test_the_cells_readers_on_a_cpu_run():
    kernels.reset_launches()
    assert sweep_fused.PLANS == {}
    r = harness.run(CELL, 2 ** 31 + 29, 0.2, True, device="cpu",
                    shape=(16, 8, 8))
    assert r["correct"] is True and r["failed"] == 0
    c = harness.load_cell(CELL)
    assert [m["name"] for m in c.per_layer] == list(METRICS)
    for name in METRICS:
        if name in r["metrics"]:
            value = r["metrics"][name]["value"]
            assert isinstance(value, (int, float)) and value >= 0, name
    # off the card: no profiler trace, no captured graph and no K4 launch,
    # so no roofline, idle share, node count, resident warps or planes in
    # flight
    assert set(r["metrics"]) == {"seamount_fcycles_per_solve",
                                 "seamount_solve_ms", "seamount_physics_ms"}
    assert sweep_fused.PLANS == {}


def test_plans_reported_and_cleared_by_the_reset():
    sweep_fused.PLANS[((2, 1, 1), torch.float32, torch.float32)] = {
        "threads": 32, "blocks_per_sm": 3, "grid": 1, "smem_bytes": 704,
        "planes_ahead": 5}
    header, row = tictoc.report_plans().splitlines()
    assert "warps/SM" in header and header.split()[-1] == "ahead"
    assert row.split()[-7:] == ["float32/float32", "32", "3", "3", "1",
                                "704", "5"]
    kernels.reset_launches()
    assert tictoc.report_plans().splitlines() == [header]
    assert sweep_fused.PLANS == {}
    assert harness.metric_reader("sweep_resident_warps")(None) is None


def test_planes_in_flight_read_at_the_largest_plan():
    """sweep_planes_in_flight reads blocks an SM x ring depth at the
    largest quads shape recorded; nothing without a plan, or from a plan
    without a ring depth (a program whose ring depth is fixed)."""
    read = harness.metric_reader("sweep_planes_in_flight")
    kernels.reset_launches()
    assert read(None) is None
    f32 = (torch.float32, torch.float32)
    sweep_fused.PLANS[((64, 256, 256),) + f32] = {
        "threads": 128, "blocks_per_sm": 2, "grid": 264,
        "smem_bytes": 108_928, "planes_ahead": 2}
    sweep_fused.PLANS[((128, 512, 512),) + f32] = {
        "threads": 128, "blocks_per_sm": 1, "grid": 132,
        "smem_bytes": 225_344, "planes_ahead": 7}
    assert read(None) == 7
    assert harness.metric_reader("sweep_resident_warps")(None) == 4
    del sweep_fused.PLANS[((128, 512, 512),) + f32]
    assert read(None) == 4
    del sweep_fused.PLANS[((64, 256, 256),) + f32]["planes_ahead"]
    assert read(None) is None
    kernels.reset_launches()
    assert read(None) is None
