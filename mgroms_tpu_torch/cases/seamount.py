"""Seamount benchmark case.

Port of ``mgroms_tpu/cases/seamount.py`` (reference ``setup_seamount``,
src/mg_setup_tests.f90:108-157; driver defaults src/mg_testseamount.f90):
a Gaussian seamount in a Lx x Ly x Htot box, uniform horizontal spacing,
zeta = 0, and the initial velocity u = v = 0, w = -1 (zero at the bottom
face).  The bathymetry is built in numpy (float64); the model converts it
to its own device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CaseSetup(NamedTuple):
    dx: np.ndarray
    dy: np.ndarray
    zeta: np.ndarray
    h: np.ndarray
    hc: float
    theta_b: float
    theta_s: float


def setup_seamount(nx: int = 64, ny: int = 64, nz: int = 64,
                   Lx: float = 1.0e4, Ly: float = 1.0e4, Htot: float = 4.0e3,
                   hc: float = 4.0e3, theta_b: float = 0.0,
                   theta_s: float = 0.0) -> CaseSetup:
    """h = Htot*(1 - 0.5*exp(-((x-x0)^2 + (y-y0)^2)/(L/5)^2))
    (mg_setup_tests.f90:145), cell centres x = (i-1/2)dx (:142-143)."""
    dxv = Lx / nx
    dyv = Ly / ny
    X = ((np.arange(1, nx + 1) - 0.5) * dxv)[None, :]
    Y = ((np.arange(1, ny + 1) - 0.5) * dyv)[:, None]
    h = Htot * (1.0 - 0.5 * np.exp(-((X - 0.5 * Lx) ** 2) / (Lx / 5.0) ** 2
                                   - ((Y - 0.5 * Ly) ** 2) / (Ly / 5.0) ** 2))
    dx = np.full((ny, nx), dxv)
    dy = np.full((ny, nx), dyv)
    zeta = np.zeros((ny, nx))
    return CaseSetup(dx, dy, zeta, h, hc, theta_b, theta_s)


def initial_velocities(nx: int, ny: int, nz: int, dtype=torch.float64,
                       device="cuda"):
    """u = v = 0, w = -1 except the bottom face
    (mg_testseamount.f90:119-123)."""
    u = torch.zeros((nz, ny + 2, nx + 1), dtype=dtype, device=device)
    v = torch.zeros((nz, ny + 1, nx + 2), dtype=dtype, device=device)
    w = torch.full((nz + 1, ny + 2, nx + 2), -1.0, dtype=dtype, device=device)
    w[0] = 0.0
    return u, v, w
