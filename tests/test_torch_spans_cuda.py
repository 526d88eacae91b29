"""The spans (mgroms_tpu_torch/utils/tictoc.py) on the card's graph path.

Marked ``cuda``: the test skips without a CUDA device.  Run on a GPU with

    python -m pytest --noconftest tests/test_torch_spans_cuda.py

A solve with spans on records one ``capture`` span where it builds its
graph and none once the graph is built, one ``fcycle`` span a replay, CUDA
events on the spans that enqueue work (the host's alone on ``step``,
``solve``, ``read`` and ``capture``), and captures the same graph, node for
node, with the same pressure, as with spans off.
"""

import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.capture import CapturedStep, captured_step
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.utils import tictoc as ttt

pytestmark = pytest.mark.cuda

N = 32
DEVICE_SPANS = {"rhs", "prologue", "fcycle", "result", "project"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(dev):
    m = NHModel(N, N, N, cfg=SolverConfig(dtype="float32"), device=dev)
    c = setup_seamount(N, N, N)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return m


def test_graph_path_spans(cuda, monkeypatch):
    vel = initial_velocities(N, N, N, dtype=torch.float32, device=cuda)
    plain = _model(cuda)
    p_off = plain.solve(*vel, tol=1e-4)[3]
    nodes_off = captured_step(plain.backend, plain.cfg).nodes
    del plain

    replays = []
    replay = CapturedStep.replay

    def counted(self):
        replays.append(1)
        return replay(self)

    monkeypatch.setattr(CapturedStep, "replay", counted)
    m = _model(cuda)
    ttt.reset_tictoc()
    ttt.record_spans(True)
    try:
        infos = []
        for _ in range(2):
            out = m.solve(*vel, tol=1e-4)
            infos.append(out[-1])
        torch.cuda.synchronize()
    finally:
        ttt.record_spans(False)
    recs = ttt.spans()
    ttt.reset_tictoc()

    assert [s.name for s in recs].count("capture") == 1
    assert [s.name for s in recs].count("step") == 2
    fcycles = [s for s in recs if s.name == "fcycle"]
    assert len(fcycles) == len(replays) == sum(
        i.niter // m.cfg.cycles_per_check for i in infos)
    assert captured_step(m.backend, m.cfg).nodes == nodes_off
    assert torch.equal(out[3], p_off)
    for s in recs:
        if s.name in DEVICE_SPANS:
            assert s.device_ms is not None and s.device_ms > 0.0, s.name
        else:
            assert s.device_ms is None, s.name
