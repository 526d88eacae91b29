"""Analytic right-hand sides for solver-only testing.

Port of ``mgroms_tpu/cases/analytic_rhs.py`` (reference
``src/mg_define_rhs.f90``, a library of synthetic RHS fields that
exercise the multigrid solver without a velocity field):

  - :func:`rhs_seamount` (:12-63): a vertical dipole of Gaussians;
  - :func:`rhs_random` (:66-95): uniform random in [-1, 1);
  - :func:`random_patches` (:97-163): a sum of random Gaussian blobs,
    whose sum over given draws is :func:`patch_sum`.

All return interior (nz, ny, nx) tensors on the unit cube scaled by the
domain dimensions, on ``device`` (the card unless the caller passes the
CPU).  The random ones draw from ``generator``, a ``torch.Generator`` on
``device`` seeded by ``seed`` unless one is given: they do not reproduce
the JAX package's PRNG stream (``jax.random``); :func:`patch_sum` takes
draws from anywhere.
"""

from __future__ import annotations

from typing import Optional

import torch


def _coords(nx, ny, nz, Lx, Ly, Htot, dtype, device):
    ar = lambda n: torch.arange(n, dtype=dtype, device=device)
    x = ((ar(nx) + 0.5) / nx) * Lx
    y = ((ar(ny) + 0.5) / ny) * Ly
    z = -Htot + ((ar(nz) + 0.5) / nz) * Htot
    return (x[None, None, :], y[None, :, None], z[:, None, None])


def _generator(generator, seed, device) -> torch.Generator:
    return (generator if generator is not None
            else torch.Generator(device=device).manual_seed(seed))


def rhs_seamount(nx: int, ny: int, nz: int,
                 Lx: float = 1.0e4, Ly: float = 1.0e4, Htot: float = 4.0e3,
                 dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Vertical dipole of Gaussians centred mid-domain
    (mg_define_rhs.f90:33-60): zero net integral, smooth, excites all
    scales — the classic multigrid smoke RHS."""
    X, Y, Z = _coords(nx, ny, nz, Lx, Ly, Htot, dtype, device)
    x0, y0 = 0.5 * Lx, 0.5 * Ly
    z1, z2 = -Htot / 3.0, -2.0 * Htot / 3.0
    sigh = (0.1 * Lx) ** 2
    sigv = (0.1 * Htot) ** 2
    blob = lambda zc: torch.exp(-((X - x0) ** 2 + (Y - y0) ** 2) / sigh
                                - (Z - zc) ** 2 / sigv)
    return blob(z1) - blob(z2)


def rhs_random(nx: int, ny: int, nz: int, seed: int = 0,
               dtype=torch.float64, device="cuda",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform random RHS in [-1, 1) (mg_define_rhs.f90:66-95)."""
    g = _generator(generator, seed, device)
    return 2.0 * torch.rand((nz, ny, nx), generator=g, dtype=dtype,
                            device=device) - 1.0


def patch_sum(nx: int, ny: int, nz: int, centers: torch.Tensor,
              amps: torch.Tensor, widths: torch.Tensor,
              Lx: float = 1.0e4, Ly: float = 1.0e4, Htot: float = 4.0e3
              ) -> torch.Tensor:
    """The sum of Gaussian blobs, blob k centred at ``centers[k]`` (a point
    of the unit cube, z measured down from the surface), of amplitude
    ``amps[k]`` and relative width ``widths[k]`` (the blob of
    mg_define_rhs.f90:97-163), in the draws' dtype and on their device."""
    X, Y, Z = _coords(nx, ny, nz, Lx, Ly, Htot, centers.dtype,
                      centers.device)
    out = torch.zeros((nz, ny, nx), dtype=centers.dtype,
                      device=centers.device)
    for c, a, w in zip(centers, amps, widths):
        out = out + a * torch.exp(-(((X - c[0] * Lx) / (w * Lx)) ** 2
                                    + ((Y - c[1] * Ly) / (w * Ly)) ** 2
                                    + ((Z + c[2] * Htot) / (w * Htot)) ** 2))
    return out


def random_patches(nx: int, ny: int, nz: int, npatches: int = 100,
                   Lx: float = 1.0e4, Ly: float = 1.0e4,
                   Htot: float = 4.0e3, seed: int = 0,
                   dtype=torch.float64, device="cuda",
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Sum of ``npatches`` random Gaussian blobs with random amplitude in
    [-1, 1) and random width in [0.02, 0.15) (mg_define_rhs.f90:97-163):
    centres, amplitudes and widths drawn in that order, then
    :func:`patch_sum`."""
    g = _generator(generator, seed, device)
    draw = lambda *shape: torch.rand(shape, generator=g, dtype=dtype,
                                     device=device)
    centers = draw(npatches, 3)
    amps = 2.0 * draw(npatches) - 1.0
    widths = 0.02 + (0.15 - 0.02) * draw(npatches)
    return patch_sum(nx, ny, nz, centers, amps, widths, Lx, Ly, Htot)
