"""Vertical (terrain-following) grid generation: zr / zw.

Port of ``mgroms_tpu/grids.py`` (reference ``src/mg_zr_zw.f90``).  Outputs
are (nz[, +1], ny, nx), z leading; the op is pointwise in the horizontal,
so it works on interior or halo-extended depth fields alike.
"""

from __future__ import annotations

from typing import Tuple

import math

import torch


def _cs_curve(sc: torch.Tensor, theta_s: float, theta_b: float
              ) -> torch.Tensor:
    """CROCO 'new_s_coord' stretching curve (mg_zr_zw.f90:110-136)."""
    if theta_s > 0.0:
        csf = (1.0 - torch.cosh(theta_s * sc)) / (math.cosh(theta_s) - 1.0)
    else:
        csf = -sc ** 2
    if theta_b > 0.0:
        cs = (torch.exp(theta_b * csf) - 1.0) / (1.0 - math.exp(-theta_b))
    else:
        cs = csf
    return cs


def setup_zr_zw_croco(hlim: float, theta_b: float, theta_s: float,
                      zeta: torch.Tensor, h: torch.Tensor, nz: int,
                      coord_type: str = "new_s_coord",
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CROCO s-coordinates.  'new_s_coord' (mg_zr_zw.f90:98-170): with
    hc = ``hlim``, z0 = hc*sc + Cs(sc)*h,
    z = z0*h/(h+hc) + zeta*(1 + z0/(h+hc)).

    'sigma', the legacy stretching (:175-213): Cs(sc) = (1 - theta_b)
    sinh(theta_s sc) / sinh(theta_s) + theta_b (tanh(theta_s (sc + 1/2))
    / (2 tanh(theta_s / 2)) - 1/2), z = z0*h/(h+hc) without the zeta
    term, the surface zw = 0.  The reference leaves its local hc unset
    there (a branch the drivers never take); ``hlim`` stands in, as in
    the JAX package."""
    if coord_type not in ("new_s_coord", "sigma"):
        raise ValueError(f"unknown coord_type {coord_type!r}")
    dt, dev = h.dtype, h.device
    k = torch.arange(1, nz + 1, dtype=dt, device=dev)
    cff = 1.0 / nz
    sc_r = (cff * (k - nz - 0.5)).reshape(nz, 1, 1)
    sc_w = (cff * (torch.arange(0, nz + 1, dtype=dt, device=dev) - nz)
            ).reshape(nz + 1, 1, 1)
    if coord_type == "sigma":
        cff1 = 1.0 / math.sinh(theta_s)
        cff2 = 0.5 / math.tanh(0.5 * theta_s)
        hc = hlim

        def cs_of(sc):
            return ((1.0 - theta_b) * cff1 * torch.sinh(theta_s * sc)
                    + theta_b * (cff2 * torch.tanh(theta_s * (sc + 0.5))
                                 - 0.5))

        hinv = 1.0 / (h + hc)
        z_r0 = hc * sc_r + cs_of(sc_r) * h
        z_w0 = hc * sc_w + cs_of(sc_w) * h
        zr = z_r0 * (h * hinv)
        zw = z_w0 * (h * hinv)
        zw[-1] = 0.0
        return zr, zw
    cs_r = _cs_curve(sc_r, theta_s, theta_b)
    cs_w = _cs_curve(sc_w, theta_s, theta_b)
    hinv = 1.0 / (h + hlim)
    z_r0 = hlim * sc_r + cs_r * h
    z_w0 = hlim * sc_w + cs_w * h
    zr = z_r0 * h * hinv + zeta * (1.0 + z_r0 * hinv)
    zw = z_w0 * h * hinv + zeta * (1.0 + z_w0 * hinv)
    return zr, zw
