"""Level-0 operator of the reference: the vertical grid, the metric terms
and the 8 stored bands of the symmetric 15-point pressure stencil, and the
residual b - A p.

Band semantics (mg_define_matrix.f90:219-227), each band (nz, ny+2, nx+2):

  cA[0] -> p(k,  j,  i)   diagonal, the negative row sum (:615-657)
  cA[1] -> p(k-1,j,  i)
  cA[2] -> p(k+1,j-1,i)
  cA[3] -> p(k,  j-1,i)
  cA[4] -> p(k-1,j-1,i)   (k=1: p(k,j+1,i-1), :438-453)
  cA[5] -> p(k+1,j,  i-1)
  cA[6] -> p(k,  j,  i-1)
  cA[7] -> p(k-1,j,  i-1) (k=1: p(k,j-1,i-1), :470-485)

Every point is water (no land mask), so the u- and v-point masks are ones
and are left out of the products.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Metrics(NamedTuple):
    """Level-0 metric fields, halo-1 extended in (j, i)."""

    dx: torch.Tensor      # (ny+2, nx+2)
    dy: torch.Tensor
    zr: torch.Tensor      # (nz,   ny+2, nx+2)
    zw: torch.Tensor      # (nz+1, ny+2, nx+2)
    dzw: torch.Tensor     # (nz+1, ny+2, nx+2)
    zx: torch.Tensor      # (nz, ny+2, nx+2): x-slope * dy
    zy: torch.Tensor      # (nz, ny+2, nx+2): y-slope * dx
    cw: torch.Tensor      # (nz+1, ny+2, nx+2)


def extend_h1(a: torch.Tensor) -> torch.Tensor:
    """Halo-1 mirror (edge copy) on the last two axes
    (mg_mpi_exchange.f90:112-141)."""
    a = torch.cat([a[..., :1, :], a, a[..., -1:, :]], dim=-2)
    return torch.cat([a[..., :1], a, a[..., -1:]], dim=-1)


def extend_h2(a: torch.Tensor) -> torch.Tensor:
    """Halo-2 extension of zr, zw: edge copy, then linear extrapolation;
    the 2x2 corners the double mirror (mg_mpi_exchange.f90:956-963,
    :1041-1077)."""
    s1, n1 = a[..., 0:1, :], a[..., -1:, :]
    s2 = 2.0 * a[..., 0:1, :] - a[..., 1:2, :]
    n2 = 2.0 * a[..., -1:, :] - a[..., -2:-1, :]
    aj = torch.cat([s2, s1, a, n1, n2], dim=-2)
    w1, e1 = aj[..., :, 0:1], aj[..., :, -1:]
    w2 = 2.0 * aj[..., :, 0:1] - aj[..., :, 1:2]
    e2 = 2.0 * aj[..., :, -1:] - aj[..., :, -2:-1]
    e = torch.cat([w2, w1, aj, e1, e2], dim=-1)
    fj = a[..., :2, :].flip(-2)
    lj = a[..., -2:, :].flip(-2)
    e[..., 0:2, 0:2] = fj[..., :2].flip(-1)
    e[..., 0:2, -2:] = fj[..., -2:].flip(-1)
    e[..., -2:, 0:2] = lj[..., :2].flip(-1)
    e[..., -2:, -2:] = lj[..., -2:].flip(-1)
    return e


def zr_zw(hc: float, theta_b: float, theta_s: float, zeta: torch.Tensor,
          h: torch.Tensor, nz: int):
    """CROCO 'new_s_coord' depths of the rho and w levels
    (mg_zr_zw.f90:98-170)."""
    dt, dev = h.dtype, h.device

    def cs(sc):
        csf = ((1.0 - torch.cosh(theta_s * sc)) / (math.cosh(theta_s) - 1.0)
               if theta_s > 0.0 else -sc ** 2)
        return ((torch.exp(theta_b * csf) - 1.0) / (1.0 - math.exp(-theta_b))
                if theta_b > 0.0 else csf)

    k = torch.arange(1, nz + 1, dtype=dt, device=dev)
    sc_r = ((1.0 / nz) * (k - nz - 0.5)).reshape(nz, 1, 1)
    sc_w = ((1.0 / nz) * (torch.arange(0, nz + 1, dtype=dt, device=dev)
                          - nz)).reshape(nz + 1, 1, 1)
    hinv = 1.0 / (h + hc)
    z_r0 = hc * sc_r + cs(sc_r) * h
    z_w0 = hc * sc_w + cs(sc_w) * h
    zr = z_r0 * h * hinv + zeta * (1.0 + z_r0 * hinv)
    zw = z_w0 * h * hinv + zeta * (1.0 + z_w0 * hinv)
    return zr, zw


def assemble(dx, dy, zeta, h, nz: int, hc: float, theta_b: float,
             theta_s: float):
    """The level-0 bands cA (8, nz, ny+2, nx+2) and the metrics, from the
    interior (ny, nx) case fields (define_matrices_topo's first level,
    mg_define_matrix.f90:28-208, and define_matrix, :211-680), in the
    fields' dtype and on their device."""
    dxe, dye = extend_h1(dx), extend_h1(dy)
    zr, zw = zr_zw(hc, theta_b, theta_s, zeta, h, nz)
    zre, zwe = extend_h2(zr), extend_h2(zw)

    # slope terms (:283-336)
    zr1, zw1 = zre[:, 1:-1, 1:-1], zwe[:, 1:-1, 1:-1]
    dzw = torch.cat([zr1[0:1] - zw1[0:1], zr1[1:] - zr1[:-1],
                     zw1[-1:] - zr1[-1:]], dim=0)
    zx = 0.5 * (zre[:, 1:-1, 2:] - zre[:, 1:-1, :-2]) / dxe * dye
    zy = 0.5 * (zre[:, 2:, 1:-1] - zre[:, :-2, 1:-1]) / dye * dxe
    sl2 = ((0.5 * (zwe[:, 1:-1, 2:] - zwe[:, 1:-1, :-2]) / dxe) ** 2
           + (0.5 * (zwe[:, 2:, 1:-1] - zwe[:, :-2, 1:-1]) / dye) ** 2)
    cw = (dxe * dye) / dzw * (1.0 + sl2)
    metrics = Metrics(dxe, dye, zr1, zw1, dzw, zx, zy, cw)

    J, I = dxe.shape
    ny, nx = J - 2, I - 2
    cwsum = cw[:-1] + cw[1:]

    def rg(arr, dj, di, j0, j1, i0, i1):
        return arr[..., j0 + dj: j1 + 1 + dj, i0 + di: i1 + 1 + di]

    def z8():
        return torch.zeros((nz, J, I), dtype=dx.dtype, device=dx.device)

    # cA3, cA4, cA5 (k>=2) on j in [1, ny+1], i in [1, nx]
    j0, j1, i0, i1 = 1, ny + 1, 1, nx

    def s3(arr, dj=0, di=0):
        return rg(arr, dj, di, j0, j1, i0, i1)

    cA3 = z8()
    cA3[0:nz - 1, j0:j1 + 1, i0:i1 + 1] = (
        0.25 * (s3(zy)[1:] + s3(zy, dj=-1)[:-1]))
    ary_over_dyv = (0.25 * (s3(zw1)[1:] - s3(zw1)[:-1]
                            + s3(zw1, dj=-1)[1:] - s3(zw1, dj=-1)[:-1])
                    * (s3(dxe) + s3(dxe, dj=-1))
                    / (0.5 * (s3(dye) + s3(dye, dj=-1))))
    zy_j, zy_jm = s3(zy)[0], s3(zy, dj=-1)[0]
    bot4 = (ary_over_dyv[0]
            - (zy_j ** 2 / s3(cwsum)[0] + zy_jm ** 2 / s3(cwsum, dj=-1)[0])
            - 0.25 * (zy_jm - zy_j))
    top4 = ary_over_dyv[-1] + 0.25 * (-s3(zy, dj=-1)[-1] + s3(zy)[-1])
    cA4 = z8()
    cA4[:, j0:j1 + 1, i0:i1 + 1] = torch.cat(
        [bot4[None], ary_over_dyv[1:-1], top4[None]], dim=0)
    cA5 = z8()
    cA5[1:, j0:j1 + 1, i0:i1 + 1] = (
        -0.25 * (s3(zy)[:-1] + s3(zy, dj=-1)[1:]))
    # cA5 at k=1 on j in [0, ny], i in [1, nx+1]
    jb0, jb1, ib0, ib1 = 0, ny, 1, nx + 1

    def s5(arr, dj=0, di=0):
        return rg(arr, dj, di, jb0, jb1, ib0, ib1)

    cA5[0, jb0:jb1 + 1, ib0:ib1 + 1] = (
        0.5 * s5(zx, dj=1)[0] * s5(zy, dj=1)[0] / s5(cwsum, dj=1)[0]
        + 0.5 * s5(zx, di=-1)[0] * s5(zy, di=-1)[0] / s5(cwsum, di=-1)[0])

    # cA6, cA7, cA8 (k>=2) on j in [1, ny], i in [1, nx+1]
    j0, j1, i0, i1 = 1, ny, 1, nx + 1

    def s6(arr, dj=0, di=0):
        return rg(arr, dj, di, j0, j1, i0, i1)

    cA6 = z8()
    cA6[0:nz - 1, j0:j1 + 1, i0:i1 + 1] = (
        0.25 * (s6(zx)[1:] + s6(zx, di=-1)[:-1]))
    arx_over_dxu = (0.25 * (s6(zw1)[1:] - s6(zw1)[:-1]
                            + s6(zw1, di=-1)[1:] - s6(zw1, di=-1)[:-1])
                    * (s6(dye) + s6(dye, di=-1))
                    / (0.5 * (s6(dxe) + s6(dxe, di=-1))))
    zx_i, zx_im = s6(zx)[0], s6(zx, di=-1)[0]
    bot7 = (arx_over_dxu[0]
            - (zx_i ** 2 / s6(cwsum)[0] + zx_im ** 2 / s6(cwsum, di=-1)[0])
            - 0.25 * (zx_im - zx_i))
    top7 = arx_over_dxu[-1] + 0.25 * (-s6(zx, di=-1)[-1] + s6(zx)[-1])
    cA7 = z8()
    cA7[:, j0:j1 + 1, i0:i1 + 1] = torch.cat(
        [bot7[None], arx_over_dxu[1:-1], top7[None]], dim=0)
    cA8 = z8()
    cA8[1:, j0:j1 + 1, i0:i1 + 1] = (
        -0.25 * (s6(zx)[:-1] + s6(zx, di=-1)[1:]))
    # cA8 at k=1 on j in [1, ny+1], i in [1, nx+1]
    jb0, jb1, ib0, ib1 = 1, ny + 1, 1, nx + 1

    def s8(arr, dj=0, di=0):
        return rg(arr, dj, di, jb0, jb1, ib0, ib1)

    cA8[0, jb0:jb1 + 1, ib0:ib1 + 1] = (
        -0.5 * s8(zx, dj=-1)[0] * s8(zy, dj=-1)[0] / s8(cwsum, dj=-1)[0]
        - 0.5 * s8(zx, di=-1)[0] * s8(zy, di=-1)[0] / s8(cwsum, di=-1)[0])

    # cA2 on the interior (:492-513, :567-571)
    j0, j1, i0, i1 = 1, ny, 1, nx

    def si(arr, dj=0, di=0):
        return rg(arr, dj, di, j0, j1, i0, i1)

    cA2 = z8()
    cA2[1:, j0:j1 + 1, i0:i1 + 1] = si(cw)[1:nz]

    # cA1: the negative row sum; the top row carries the free surface
    bot1 = (-si(cA2)[1]
            - si(cA4)[0] - si(cA4, dj=1)[0]
            - si(cA7)[0] - si(cA7, di=1)[0]
            - si(cA6)[0] - si(cA8, di=1)[1]
            - si(cA3)[0] - si(cA5, dj=1)[1]
            - si(cA5)[0] - si(cA5, dj=-1, di=1)[0]
            - si(cA8)[0] - si(cA8, dj=1, di=1)[0])
    mid1 = (-si(cA2)[1:nz - 1] - si(cA2)[2:nz]
            - si(cA4)[1:nz - 1] - si(cA4, dj=1)[1:nz - 1]
            - si(cA7)[1:nz - 1] - si(cA7, di=1)[1:nz - 1]
            - si(cA6)[1:nz - 1] - si(cA6, di=1)[0:nz - 2]
            - si(cA8)[1:nz - 1] - si(cA8, di=1)[2:nz]
            - si(cA3)[1:nz - 1] - si(cA3, dj=1)[0:nz - 2]
            - si(cA5)[1:nz - 1] - si(cA5, dj=1)[2:nz])
    top1 = (-si(cA2)[nz - 1]
            - si(cw)[nz]
            + 0.5 * si(zx, di=1)[nz - 1] - 0.5 * si(zx, di=-1)[nz - 1]
            + 0.5 * si(zy, dj=1)[nz - 1] - 0.5 * si(zy, dj=-1)[nz - 1]
            - si(cA4)[nz - 1] - si(cA4, dj=1)[nz - 1]
            - si(cA7)[nz - 1] - si(cA7, di=1)[nz - 1]
            - si(cA6, di=1)[nz - 2]
            - si(cA8)[nz - 1]
            - si(cA3, dj=1)[nz - 2]
            - si(cA5)[nz - 1])
    cA1 = torch.ones((nz, J, I), dtype=dx.dtype, device=dx.device)
    cA1[:, j0:j1 + 1, i0:i1 + 1] = torch.cat(
        [bot1[None], mid1, top1[None]], dim=0)
    return torch.stack([cA1, cA2, cA3, cA4, cA5, cA6, cA7, cA8]), metrics


def _shift(pe: torch.Tensor, dk: int, dj: int, di: int) -> torch.Tensor:
    """The interior of the extended ``pe`` at offset (dk, dj, di); planes
    outside [0, nz) read zero."""
    J, I = pe.shape[-2:]
    h = pe[..., 1 + dj: J - 1 + dj, 1 + di: I - 1 + di]
    if dk == 0:
        return h
    z = torch.zeros_like(h[:1])
    return (torch.cat([h[1:], z]) if dk == 1 else torch.cat([z, h[:-1]]))


def residual(p: torch.Tensor, b: torch.Tensor, cA: torch.Tensor
             ) -> torch.Tensor:
    """r = b - A p on the interior (compute_residual_3D_8,
    mg_relax.f90:421-515, with the bottom plane's 'real' couplings): each
    off-diagonal band read at the point and mirrored at the neighbour that
    stores the symmetric entry.  ``p`` and ``b`` are interior (nz, ny, nx);
    the walls are homogeneous Neumann (the mirrored halo)."""
    pe = extend_h1(p)

    def band(n, dk=0, dj=0, di=0):
        return _shift(cA[n - 1], dk, dj, di)

    s = (band(3) * _shift(pe, 1, -1, 0)
         + band(3, dk=-1, dj=1) * _shift(pe, -1, 1, 0)
         + band(4) * _shift(pe, 0, -1, 0)
         + band(4, dj=1) * _shift(pe, 0, 1, 0)
         + band(5) * _shift(pe, -1, -1, 0)
         + band(5, dk=1, dj=1) * _shift(pe, 1, 1, 0)
         + band(6) * _shift(pe, 1, 0, -1)
         + band(6, dk=-1, di=1) * _shift(pe, -1, 0, 1)
         + band(7) * _shift(pe, 0, 0, -1)
         + band(7, di=1) * _shift(pe, 0, 0, 1)
         + band(8) * _shift(pe, -1, 0, -1)
         + band(8, dk=1, di=1) * _shift(pe, 1, 0, 1))
    x0 = (band(5)[:1] * _shift(pe, 0, 1, -1)[:1]
          + band(5, dj=-1, di=1)[:1] * _shift(pe, 0, -1, 1)[:1]
          + band(8)[:1] * _shift(pe, 0, -1, -1)[:1]
          + band(8, dj=1, di=1)[:1] * _shift(pe, 0, 1, 1)[:1])
    s = torch.cat([s[:1] + x0, s[1:]])
    return (b - band(1) * _shift(pe, 0, 0, 0)
            - band(2) * _shift(pe, -1, 0, 0)
            - band(2, dk=1) * _shift(pe, 1, 0, 0) - s)
