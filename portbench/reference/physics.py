"""The divergence right-hand side (mg_compute_rhs.f90:14-379) and the
velocity projection (mg_correct_uvw.f90:15-115) of the reference, on the
level-0 metrics of :func:`operator.assemble`.

Velocity layout, z leading: u (nz, ny+2, nx+1), v (nz, ny+1, nx+2),
w (nz+1, ny+2, nx+2).  The wall-normal fluxes at the four physical walls
are zero (fill_halo(uf, lbc_null='u'), mg_mpi_exchange.f90:972-1013).
"""

from __future__ import annotations

import torch

from .operator import Metrics, extend_h1


def divergence(m: Metrics, u: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """b = div of the sigma-coordinate volume fluxes, (nz, ny, nx)."""
    nz = u.shape[0]
    J, I = m.dx.shape
    ny, nx = J - 2, I - 2
    cwsum = m.cw[:-1] + m.cw[1:]
    # the bottom cell has no lower-face part of the w slope terms
    # (:100-131), the top cell doubles the surface part (:152-168)
    wlo = u.new_ones((nz, 1, 1))
    wlo[0] = 0.0
    whi = u.new_ones((nz, 1, 1))
    whi[-1] = 2.0
    k0 = u.new_zeros((nz, 1, 1))
    k0[0] = 1.0
    uwall = u.new_ones((ny, nx + 1))
    uwall[:, 0] = 0.0
    uwall[:, -1] = 0.0
    vwall = u.new_ones((ny + 1, nx))
    vwall[0, :] = 0.0
    vwall[-1, :] = 0.0

    # u-fluxes on (nz, ny, nx+1)
    def MU(arr, di=0):
        return arr[..., 1:ny + 1, 1 + di: nx + 2 + di]

    uu = u[:, 1:ny + 1, :]

    def wU_at(di):
        return w[:, 1:ny + 1, 1 + di:nx + 2 + di]

    arx = (0.25 * (MU(m.zw)[1:] - MU(m.zw)[:-1]
                   + MU(m.zw, -1)[1:] - MU(m.zw, -1)[:-1])
           * (MU(m.dy) + MU(m.dy, -1)))
    wterm_u = 0.25 * (
        MU(m.zx) * (wlo * MU(m.dzw)[:-1] * wU_at(0)[:-1]
                    + whi * MU(m.dzw)[1:] * wU_at(0)[1:])
        + MU(m.zx, -1) * (wlo * MU(m.dzw, -1)[:-1] * wU_at(-1)[:-1]
                          + whi * MU(m.dzw, -1)[1:] * wU_at(-1)[1:]))
    dxu = 0.5 * (MU(m.dx) + MU(m.dx, -1))

    def dyv_at(dj, di):
        return 0.5 * (m.dy[1 + dj:ny + 1 + dj, 1 + di:nx + 2 + di]
                      + m.dy[dj:ny + dj, 1 + di:nx + 2 + di])

    def v_at(dj, di):
        return v[:, dj:ny + dj, 1 + di:nx + 2 + di]

    slope2_u = (MU(m.zx)[0] ** 2 / MU(cwsum)[0]
                + MU(m.zx, -1)[0] ** 2 / MU(cwsum, -1)[0]) * dxu * uu[0]
    vbar = 0.5 * (dyv_at(0, 0) * v_at(0, 0)[0] + dyv_at(1, 0) * v_at(1, 0)[0])
    vbar_im = 0.5 * (dyv_at(0, -1) * v_at(0, -1)[0]
                     + dyv_at(1, -1) * v_at(1, -1)[0])
    cross_u = (MU(m.zx)[0] * MU(m.zy)[0] / MU(cwsum)[0] * vbar
               + MU(m.zx, -1)[0] * MU(m.zy, -1)[0] / MU(cwsum, -1)[0]
               * vbar_im)
    uf = (arx * uu - wterm_u - k0 * (slope2_u + cross_u)[None]) * uwall

    # v-fluxes on (nz, ny+1, nx)
    def MV(arr, dj=0, di=0):
        return arr[..., 1 + dj: ny + 2 + dj, 1 + di: nx + 1 + di]

    vv = v[:, :, 1:nx + 1]
    wV = w[:, :, 1:nx + 1]
    ary = (0.25 * (MV(m.zw)[1:] - MV(m.zw)[:-1]
                   + MV(m.zw, -1)[1:] - MV(m.zw, -1)[:-1])
           * (MV(m.dx) + MV(m.dx, -1)))

    def wV_at(dj):
        return wV[:, 1 + dj:ny + 2 + dj, :]

    wterm_v = 0.25 * (
        MV(m.zy) * (wlo * MV(m.dzw)[:-1] * wV_at(0)[:-1]
                    + whi * MV(m.dzw)[1:] * wV_at(0)[1:])
        + MV(m.zy, -1) * (wlo * MV(m.dzw, -1)[:-1] * wV_at(-1)[:-1]
                          + whi * MV(m.dzw, -1)[1:] * wV_at(-1)[1:]))
    dyv = 0.5 * (MV(m.dy) + MV(m.dy, -1))

    def u_at(dj, di):
        return u[:, 1 + dj:ny + 2 + dj, di:nx + di]

    def dxu_at(dj, di):
        return 0.5 * (m.dx[1 + dj:ny + 2 + dj, 1 + di:nx + 1 + di]
                      + m.dx[1 + dj:ny + 2 + dj, di:nx + di])

    slope2_v = (MV(m.zy)[0] ** 2 / MV(cwsum)[0]
                + MV(m.zy, -1)[0] ** 2 / MV(cwsum, -1)[0]) * dyv * vv[0]
    ubar = 0.5 * (dxu_at(0, 0) * u_at(0, 0)[0] + dxu_at(0, 1) * u_at(0, 1)[0])
    ubar_jm = 0.5 * (dxu_at(-1, 0) * u_at(-1, 0)[0]
                     + dxu_at(-1, 1) * u_at(-1, 1)[0])
    cross_v = (MV(m.zy)[0] * MV(m.zx)[0] / MV(cwsum)[0] * ubar
               + MV(m.zy, -1)[0] * MV(m.zx, -1)[0] / MV(cwsum, -1)[0]
               * ubar_jm)
    vf = (ary * vv - wterm_v - k0 * (slope2_v + cross_v)[None]) * vwall

    # w-fluxes on (nz+1, ny, nx)
    def MI(arr, dj=0, di=0):
        return arr[..., 1 + dj: ny + 1 + dj, 1 + di: nx + 1 + di]

    uterm = MI(m.zx) * (
        (MI(m.dx) + MI(m.dx, di=-1)) * u[:, 1:ny + 1, 0:nx]
        + (MI(m.dx, di=1) + MI(m.dx)) * u[:, 1:ny + 1, 1:nx + 1])
    vterm = MI(m.zy) * (
        (MI(m.dy) + MI(m.dy, dj=-1)) * v[:, 0:ny, 1:nx + 1]
        + (MI(m.dy, dj=1) + MI(m.dy)) * v[:, 1:ny + 1, 1:nx + 1])
    wI = w[:, 1:ny + 1, 1:nx + 1]
    wf_int = (MI(m.cw)[1:nz] * MI(m.dzw)[1:nz] * wI[1:nz]
              - 0.125 * (uterm[1:nz] + uterm[0:nz - 1])
              - 0.125 * (vterm[1:nz] + vterm[0:nz - 1]))
    wf_top = (MI(m.cw)[nz] * MI(m.dzw)[nz] * wI[nz]
              - 0.25 * uterm[nz - 1] - 0.25 * vterm[nz - 1])
    wf = torch.cat([u.new_zeros((1, ny, nx)), wf_int, wf_top[None]], dim=0)

    return (uf[:, :, 1:] - uf[:, :, :-1]
            + vf[:, 1:, :] - vf[:, :-1, :]
            + wf[1:] - wf[:-1])


def project(m: Metrics, p: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor):
    """(u, v, w) less the pressure gradient of the interior pressure ``p``
    (nz, ny, nx), halo rows included; the mirrored halo makes the
    wall-normal gradient vanish; the bottom w face is left as it is."""
    pe = extend_h1(p)
    nz = pe.shape[0]
    dxu = 0.5 * (m.dx[:, 1:] + m.dx[:, :-1])
    u = u - (pe[:, :, 1:] - pe[:, :, :-1]) / dxu
    dyv = 0.5 * (m.dy[1:, :] + m.dy[:-1, :])
    v = v - (pe[:, 1:, :] - pe[:, :-1, :]) / dyv
    dw_int = (pe[1:] - pe[:-1]) / (m.zr[1:] - m.zr[:-1])
    dw_top = (-pe[nz - 1]) / (m.zw[nz] - m.zr[nz - 1])
    w = w - torch.cat([torch.zeros_like(w[:1]), dw_int, dw_top[None]], dim=0)
    return u, v, w
