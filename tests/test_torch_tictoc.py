"""The port's per-(level, section) profiler (mgroms_tpu_torch/utils/
tictoc.py) against the JAX package's (mgroms_tpu/utils/tictoc.py), in
float64 on the CPU:

- profile_fcycle fills a row for every level (tests/test_diagnostics.py::
  test_profile_fcycle_populates_per_level_table, ported);
- the drivers' ``--profile`` prints the table (test_driver_profile_flag,
  ported; the working directory through monkeypatch.chdir);
- on the same seamount 16^3 configuration the port's table has JAX's
  (level, op) keys and call counts, and report() JAX's layout (the
  header and one row per level, equal but for the seconds).  The port's
  CPU routing of the default configuration is the JAX package's CPU
  routing (K1-K3's plain versions, the fused down-leg), so JAX runs
  without ``pallas_interpret``;
- TicToc, the module functions and InstrumentedBackend keep JAX's
  signatures; the wrapper forwards what the cycles read; the re-timing's
  recorded shapes rebuild tensors of the same layout.
"""

import inspect
import re

import pytest
import torch

import mgroms_tpu.utils.tictoc as jtt
from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops.relax_compact import QuadField
from mgroms_tpu_torch.utils import tictoc as ttt

torch.set_num_threads(1)

N = 16


def _port(n=N, **cfg):
    m = NHModel(n, n, n, cfg=SolverConfig(**cfg), device="cpu")
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def _rhs(m, n=N):
    return m.rhs(*initial_velocities(n, n, n, device="cpu"))


@pytest.fixture(scope="module")
def tables():
    """One profiled F-cycle of seamount 16^3 by each package."""
    c = setup_seamount(N, N, N)
    j = JModel(N, N, N, cfg=JConfig())
    j.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    jt = jtt.profile_fcycle(j.backend, j.rhs(*jvel(N, N, N)), j.cfg,
                            tictoc=jtt.TicToc())
    m = _port()
    tt = ttt.profile_fcycle(m.backend, _rhs(m), m.cfg, tictoc=ttt.TicToc())
    return jt, tt, m


def test_profile_fcycle_populates_per_level_table(tables):
    """Every level appears; level 0 brackets relax and prolong, the
    coarsest relaxes, some level restricts; one report row per level."""
    _, tt, m = tables
    levs = sorted({k[0] for k in tt.table})
    assert len(levs) == m.backend.nlevs
    for sec in ("relax", "prolong"):
        t, c = tt.table[(0, sec)]
        assert c >= 1 and t > 0.0
    assert any(k[1] in ("restrict", "residual_restrict") for k in tt.table)
    t, c = tt.table[(m.backend.nlevs - 1, "relax")]
    assert c >= 1 and t > 0.0
    assert len(tt.report().strip().splitlines()) == 1 + len(levs)
    # the CPU has no events: no device seconds
    assert not tt.device and not tt.host


def test_table_keys_and_counts_match_jax(tables):
    jt, tt, _ = tables
    counts = lambda t: {k: c for k, (_, c) in t.table.items()}
    assert counts(tt) == counts(jt)
    assert all(s > 0.0 for s, _ in tt.table.values())


def test_report_layout_matches_jax(tables):
    """The same header and rows, the seconds masked."""
    jt, tt, _ = tables
    mask = lambda rep: [re.sub(r"[ \d]{7}\.\d{4}s/", "<seconds>/", line)
                        for line in rep.splitlines()]
    assert mask(tt.report()) == mask(jt.report())
    assert tt.report().splitlines()[0] == jt.report().splitlines()[0]


def test_driver_profile_flag(monkeypatch, tmp_path, capsys):
    """--profile prints the reference-style multi-level table after the
    solve (drivers/common.py), the matrices and solve spans on level 0."""
    from mgroms_tpu_torch.drivers.seamount import main
    monkeypatch.chdir(tmp_path)
    ttt.reset_tictoc()
    main(["--nx", "16", "--ny", "16", "--nz", "16", "--device", "cpu",
          "--tol", "1e-4", "--maxiter", "5", "--profile"])
    out = capsys.readouterr().out
    assert "relax" in out and "matrices" in out and "solve" in out
    table_lines = [line for line in out.splitlines()
                   if line.strip()[:1].isdigit() and "s/" in line]
    assert len(table_lines) >= 3
    assert (tmp_path / "residual_history.txt").exists()
    ttt.reset_tictoc()


def test_signatures_match_jax():
    for name in ("tic", "toc", "print_tictoc", "reset_tictoc",
                 "profile_fcycle"):
        assert (inspect.signature(getattr(ttt, name))
                == inspect.signature(getattr(jtt, name))), name
    for cls, meth in (("TicToc", "tic"), ("TicToc", "toc"),
                      ("TicToc", "reset"), ("InstrumentedBackend",
                                            "__init__")):
        assert (inspect.signature(getattr(getattr(ttt, cls), meth))
                == inspect.signature(getattr(getattr(jtt, cls), meth)))
    assert ttt._PROFILED_OPS == jtt._PROFILED_OPS


def test_tictoc_spans_and_module_table():
    t = ttt.TicToc()
    t.tic(1, "a", sync=True)
    t.toc(1, "a", sync=True)
    t.toc(2, "never opened")
    assert t.table[(1, "a")][1] == 1 and (2, "never opened") not in t.table
    ttt.reset_tictoc()
    ttt.tic(0, "x")
    ttt.toc(0, "x")
    assert ttt._GLOBAL.table[(0, "x")][1] == 1
    ttt.reset_tictoc()
    assert not ttt._GLOBAL.table


def test_instrumented_backend_forwards_and_records(tables):
    """Only _PROFILED_OPS are wrapped; the gates the cycles read are the
    inner backend's; a recorded call rebuilds inputs of its layout."""
    _, _, m = tables
    be = m.backend
    ib = ttt.InstrumentedBackend(be, tictoc=ttt.TicToc(), record=True)
    assert ib.nlevs == be.nlevs and ib.state_quads(0) == be.state_quads(0)
    assert ib.supports_fused_rr(0) == be.supports_fused_rr(0)
    assert ib.zeros == be.zeros
    p = ib.to_state(0, be.zeros(0))
    assert isinstance(p, QuadField)
    (op, lev, args, kw), = ib.calls
    assert (op, lev, kw) == ("to_state", 0, {})
    made = ttt._make(args)
    assert made[0].shape == (N, N, N) and made[0].dtype == torch.float64
    q = ib.relax(0, p, ib.to_state(0, _rhs(m)), 2)
    spec = ib.calls[-1][2]
    rebuilt = ttt._make(spec)
    assert isinstance(rebuilt[0], QuadField) and rebuilt[2] == 2
    assert [x.shape for x in rebuilt[0].quads] == [x.shape for x in q.quads]
    assert all(bool((x == 1).all()) for x in rebuilt[1].quads)


def test_device_timer_needs_capturable_backend_on_card(tables):
    """The re-timing replays each call from a CUDA graph: a backend on the
    CPU, or one on the card that no graph can capture (a distributed
    backend's tiles run on host threads), raises instead of timing the
    host's enqueue."""
    import types
    _, _, m = tables
    with pytest.raises(ValueError, match="on the CPU"):
        ttt.profile_fcycle(m.backend, _rhs(m), m.cfg, device_timer=True,
                           tictoc=ttt.TicToc())
    mesh = types.SimpleNamespace(on_card=True, capturable=False)
    with pytest.raises(ValueError, match="on the card"):
        ttt.profile_fcycle(mesh, None, m.cfg, device_timer=True,
                           tictoc=ttt.TicToc())
