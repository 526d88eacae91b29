"""``seamount``: the Gaussian seamount of the reference's seamount driver
(mg_testseamount.f90:76-82: Lx = Ly = 10 km, Htot = 4 km, hc = 4000,
theta_b = theta_s = 0), h = Htot (1 - 1/2 exp(-r^2 / (L/5)^2)) about the
box's centre (mg_setup_tests.f90:108-157, :145), uniform horizontal
spacing, zeta = 0.  A copy of the program's ``cases.seamount.
setup_seamount``, so that a later change there does not move the
benchmark.  Fields are numpy float64, interior (ny, nx).
"""

from __future__ import annotations

import numpy as np

from . import Case


def build(conf: dict, nx: int, ny: int) -> Case:
    """The case at (nx, ny) from a configuration's ``Lx``, ``Ly``,
    ``Htot``, ``hc``, ``theta_b`` and ``theta_s``."""
    Lx, Ly, Htot = conf["Lx"], conf["Ly"], conf["Htot"]
    dxv = Lx / nx
    dyv = Ly / ny
    X = ((np.arange(1, nx + 1) - 0.5) * dxv)[None, :]
    Y = ((np.arange(1, ny + 1) - 0.5) * dyv)[:, None]
    h = Htot * (1.0 - 0.5 * np.exp(-((X - 0.5 * Lx) ** 2) / (Lx / 5.0) ** 2
                                   - ((Y - 0.5 * Ly) ** 2) / (Ly / 5.0) ** 2))
    dx = np.full((ny, nx), dxv)
    dy = np.full((ny, nx), dyv)
    return Case(dx, dy, np.zeros((ny, nx)), h, conf["hc"], conf["theta_b"],
                conf["theta_s"])
