"""The benchmark's plain reference (portbench/reference) against the port's
CPU path in float64, on a small CUC-shaped grid (the synthetic slope at
48 x 32 x 8 with the CUC case's Lx, Ly, hc and theta): the level-0
operator, the divergence right-hand side, the residual and the projection
agree to round-off."""

import json
from pathlib import Path

import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.bc import extend_h1
from mgroms_tpu_torch.ops import stencil
from mgroms_tpu_torch.ops.projection import correct_uvw
from mgroms_tpu_torch.ops.rhs import compute_rhs
from portbench import cases, generator, reference

ROOT = Path(__file__).resolve().parents[2]
NZ, NY, NX = 8, 32, 48


def setup():
    conf = json.loads((ROOT / "portbench/configs/cuc1024-direct.json")
                      .read_text())
    case = cases.build(conf, NX, NY)
    m = NHModel(NX, NY, NZ, cfg=SolverConfig(dtype="float64"), device="cpu")
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    cA, metrics = reference.assemble(t(case.dx), t(case.dy), t(case.zeta),
                                     t(case.h), NZ, case.hc, case.theta_b,
                                     case.theta_s)
    u, v, w = generator.make_pool(generator.load("steps") | {"pool": 1},
                                  NX, NY, NZ, 3, torch.float64, "cpu")[0]
    return m, cA, metrics, (u, v, w)


def assert_close(got, want, rtol=1e-12):
    scale = float(want.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rtol * scale


def test_operator_and_metrics_match_the_port():
    m, cA, metrics, _ = setup()
    assert_close(cA, m.ops[0].cA)
    for name in metrics._fields:
        assert_close(getattr(metrics, name), getattr(m.metrics, name))


def test_divergence_and_residual_match_the_port():
    m, cA, metrics, (u, v, w) = setup()
    b = reference.divergence(metrics, u, v, w)
    assert_close(b, compute_rhs(m.metrics, u, v, w, False))
    p = torch.sin(torch.arange(NZ * NY * NX, dtype=torch.float64)
                  .reshape(NZ, NY, NX) * 0.37)
    assert_close(reference.residual(p, b, cA),
                 stencil.residual(extend_h1(p), b, m.ops[0].cA, True))


def test_projection_matches_the_port_and_the_solve_zeroes_the_divergence():
    m, cA, metrics, (u, v, w) = setup()
    u2, v2, w2, p, info = m.solve(u, v, w, tol=1e-10)
    want = correct_uvw(m.metrics, extend_h1(p), u, v, w)
    for got, x in zip(reference.project(metrics, p, u, v, w), want):
        assert_close(got, x)
    b = reference.divergence(metrics, u, v, w)
    r = reference.residual(p, b, cA)
    assert float(r.norm() / b.norm()) <= 1e-10
