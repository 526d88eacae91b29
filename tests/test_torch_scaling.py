"""The scaling sweep (mgroms_tpu_torch/scripts/scaling.py, the port of
examples/scaling.py) and the contract behind it, ports of
tests/test_scaling_sweep.py on a mesh of CPU devices driven from one
process:

- the shard_map layer's communication per F-cycle is flat in device
  count: seamount 256x32x8 on 2x1, 4x1 and 8x1 (every level sharded in
  all three plans) makes the same number of lock-step rounds of each
  kind (parallel/mesh.COLLECTIVES) in one F-cycle, as the JAX package's
  compiled F-cycle holds the same number of collective-permutes;
- ``scaling.main`` completes a small sweep on the virtual mesh under both
  communication layers and prints the overhead column.
"""

import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import setup_seamount
from mgroms_tpu_torch.parallel import mesh as pmesh
from mgroms_tpu_torch.scripts import scaling
from mgroms_tpu_torch.solver import fcycle

torch.set_num_threads(1)


def _fcycle_counts(npx, npy, comm):
    m = NHModel(256, 32, 8, cfg=SolverConfig(), device="cpu")
    c = setup_seamount(256, 32, 8)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    m.distribute(npx, npy, devices=["cpu"] * (npx * npy), comm=comm)
    be = m.backend
    q = be.state_quads(0)
    p = be.zeros(0, as_quads=q)
    b = be.zeros(0, as_quads=q)
    pmesh.reset_collectives()
    fcycle(be, p, b, b, m.cfg)
    return m, pmesh.collectives()


def test_shardmap_collectives_flat_in_device_count():
    """2, 4 and 8 devices along x: every level stays sharded in all three
    plans (local nx >= nsmall throughout), so one F-cycle makes the same
    rounds of each kind: communication per cycle is a property of the
    level plan, not of the mesh size (tests/test_scaling_sweep.py:43)."""
    counts = {}
    for npx in (2, 4, 8):
        m, counts[npx] = _fcycle_counts(npx, 1, "shard_map")
        assert all(s.sharded for s in m.backend.plan.shards), \
            f"plan {npx}x1 de-shards a level; test grid needs adjusting"
        assert counts[npx]["ppermute"] > 0
    assert counts[2] == counts[4] == counts[8], counts


def test_scaling_sweep_runs_both_comm_layers(capsys):
    """scaling.main (tests/test_scaling_sweep.py:63): two rows a layer,
    the overhead column last, the counts per F-cycle beside the times."""
    for comm in ("gspmd", "shard_map"):
        rows = scaling.main(["--simulate", "8", "--grids", "64", "--meshes",
                             "1x1,2x2", "--nz", "8", "--comm", comm,
                             "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"comm={comm}" in out and out.splitlines()[1].split()[-1] \
            == "ovh"
        lines = [ln for ln in out.splitlines()
                 if ln.strip().startswith("64")]
        assert len(lines) == len(rows) == 2, out
        assert float(lines[-1].split()[-1]) > 0.0
        (_, base, _), (_, row, ovh) = rows
        assert row.backend == {"gspmd": "DistributedBackend",
                               "shard_map": "ShardMapBackend"}[comm]
        assert base.counts == dict.fromkeys(scaling.KINDS, 0.0)
        assert row.counts["ppermute"] > 0 and ovh > 0.0
