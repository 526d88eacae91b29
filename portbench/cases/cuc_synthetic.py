"""``cuc_synthetic``: the California Undercurrent grid of the reference's
test program (mg_testcuc.f90:34-72: Lx = Ly = 200 km, hc = 250, theta_b =
theta_s = 6) on a synthetic continental slope, since the grid file ``cuc_nhgrd.nc``
ships with neither the reference nor this repository: a ~100 m shelf
dropping over a tanh slope to a ~4000 m plain, with three smooth ridges
drawn from ``numpy.random.default_rng(bathymetry_seed)``.  A copy of the
program's ``cases.cuc.setup_cuc_synthetic``, so that a later change there
does not move the benchmark.  Fields are numpy float64, interior (ny, nx).
"""

from __future__ import annotations

import numpy as np

from . import Case


def build(conf: dict, nx: int, ny: int) -> Case:
    """The case at (nx, ny) from a configuration's ``Lx``, ``Ly``, ``hc``,
    ``theta_b``, ``theta_s`` and ``bathymetry_seed``."""
    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    X, Y = np.meshgrid(x, y)
    shelf, deep = 100.0, 4000.0
    slope_pos = 0.35 + 0.08 * np.sin(2 * np.pi * Y * 1.5)
    h = shelf + 0.5 * (deep - shelf) * (
        1.0 + np.tanh((X - slope_pos) / 0.08))
    rng = np.random.default_rng(conf["bathymetry_seed"])
    for kx, ky in ((2, 3), (3, 1), (5, 2)):
        amp = 120.0 * rng.uniform(0.5, 1.0)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        h += amp * np.sin(2 * np.pi * kx * X + ph[0]) \
                 * np.cos(2 * np.pi * ky * Y + ph[1])
    dx = np.full((ny, nx), conf["Lx"] / nx)
    dy = np.full((ny, nx), conf["Ly"] / ny)
    return Case(dx, dy, np.zeros((ny, nx)), h, conf["hc"], conf["theta_b"],
                conf["theta_s"])

