"""Random-topography benchmark case.

Port of ``mgroms_tpu/cases/rndtopo.py`` (reference ``setup_rndtopo``,
src/mg_setup_tests.f90:160-211; driver src/mg_testrndtopo.f90,
diff-identical to the seamount driver): depth uniform-random in
[0, 0.2*Htot), uniform horizontal spacing, zeta = 0.

The depth is drawn from a ``torch.Generator`` seeded by ``seed`` on the
CPU, so the same seed gives the same field on any host.  It does not and
cannot reproduce the JAX package's PRNG stream (``jax.random``): the two
packages draw different fields from the same seed, and a comparison of
the two feeds one package's ``h`` into the other.  Built in float64
numpy, as the seamount case; the model converts it to its own device and
dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .seamount import CaseSetup


def setup_rndtopo(nx: int = 64, ny: int = 64, nz: int = 64,
                  Lx: float = 1.0e4, Ly: float = 1.0e4, Htot: float = 4.0e3,
                  hc: float = 4.0e3, theta_b: float = 0.0,
                  theta_s: float = 0.0, seed: int = 0) -> CaseSetup:
    g = torch.Generator().manual_seed(seed)
    h = Htot * 0.2 * torch.rand((ny, nx), generator=g,
                                dtype=torch.float64).numpy()
    dx = np.full((ny, nx), Lx / nx)
    dy = np.full((ny, nx), Ly / ny)
    zeta = np.zeros((ny, nx))
    return CaseSetup(dx, dy, zeta, h, hc, theta_b, theta_s)
