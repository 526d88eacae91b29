"""Mixed-precision defect correction on one case: float32 multigrid
cycles, float64 residuals, to a float64 relative residual of 1e-12.

    python -m mgroms_tpu_torch.scripts.refine_solve
        --case {seamount,cuc,rndtopo} [--nx 64 --ny 64 --nz 64]
        [--bf16-bands] [--coarsest direct] [--device cuda]

Port of ``scripts/bench_tpu.py``'s ``run_refine`` (:139-172): builds the
model pair (refine.build_pair), the right-hand side of the case's initial
velocities on the float64 model, and runs refine.refined_pressure_solve
with ``tol=1e-12, max_rounds=8``.  ``--bf16-bands`` gives the inner
float32 solve perf mode (``fused_bands_bf16=True, ns_pre=1, ns_post=1``,
as micro_solve.PERF).  ``--coarsest`` is the inner solve's coarsest-level
treatment, 'direct' (the JAX script's default: one product with the
dense inverse) or 'relax'.  The rndtopo case draws its depth from seed 0
(cases/rndtopo.py; not the JAX package's field).

Prints one JSON line with the JAX script's keys, ``device`` (the card's
name and power limit, ``nvidia-smi``) in place of ``platform``, and
``peak_memory_gib``, the pair's peak device memory from the start of the
run (set-up and solve).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..cases.cuc import setup_cuc_synthetic
from ..cases.rndtopo import setup_rndtopo
from ..cases.seamount import initial_velocities, setup_seamount
from ..config import SolverConfig
from ..refine import build_pair, refined_pressure_solve
from ._timing import card_line

SETUPS = {"seamount": setup_seamount, "cuc": setup_cuc_synthetic,
          "rndtopo": setup_rndtopo}
PERF = dict(fused_bands_bf16=True, ns_pre=1, ns_post=1)


def run(case: str, nx: int, ny: int, nz: int, bf16_bands: bool = False,
        device="cuda", max_rounds: int = 8, verbose: bool = False,
        coarsest: str = "direct") -> dict:
    """One refined solve of ``case`` at (nx, ny, nz); the JSON row."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cfg32 = SolverConfig(dtype="float32", coarsest=coarsest,
                         **(PERF if bf16_bands else {}))
    m32, m64 = build_pair(nx, ny, nz, SETUPS[case](nx, ny, nz), cfg32,
                          device=device)
    u, v, w = initial_velocities(nx, ny, nz, device=device)
    b64 = m64.rhs(u, v, w)
    _, info = refined_pressure_solve(m32, m64, b64, tol=1e-12,
                                     max_rounds=max_rounds, verbose=verbose)
    return {
        "case": case, "grid": [nz, ny, nx],
        "mode": "defect-correction f32 cycles + f64 residuals"
                + (" (bf16 smoother bands)" if bf16_bands else ""),
        "coarsest": coarsest,
        "rounds": info.rounds,
        "final_f64_rel_residual": info.res,
        "history": [float(h) for h in info.history],
        "inner_fcycles": list(info.inner_cycles),
        "time_s": info.time_s,
        "device": card_line() if on_card else str(device),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if on_card else None),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="seamount",
                    choices=["seamount", "cuc", "rndtopo"])
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--bf16-bands", action="store_true",
                    help="perf mode for the inner float32 solve")
    ap.add_argument("--coarsest", default="direct",
                    choices=["direct", "relax"])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain versions)")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "path")
    print(json.dumps(run(a.case, a.nx, a.ny, a.nz, a.bf16_bands, a.device,
                         verbose=True, coarsest=a.coarsest)))


if __name__ == "__main__":
    main()
