"""Inter-grid transfers: restriction and prolongation.

Port of ``mgroms_tpu/ops/transfer.py`` (reference src/mg_intergrids.f90).
Restriction is the plain sum of the 8 children (fine2coarse_3D, :139-162);
prolongation is trilinear (coarse2fine_3D_linear, :366-450) or 8-way
nearest injection (:336-363).  The JAX package interleaves along x with a
one-hot matrix product (a TPU lane-layout workaround); here every
interleave is a strided write.

The aggressive 8:1 z-restriction (fine2coarse_aggressive) and the 2-D
(nz == 1) forms are here too, as in the JAX package; the aggressive
prolongation raises there and here, as the reference stops
(mg_intergrids.f90:243-244).  No standard level plan reaches a 2-D
level, and the assembly refuses aggressive coarsening.
"""

from __future__ import annotations

import torch


def restrict_3d(r: torch.Tensor) -> torch.Tensor:
    """Coarse = sum of the 8 fine children (mg_intergrids.f90:139-162):
    z-pairs, then j-pairs, then i-pairs."""
    rz = r[0::2] + r[1::2]
    ry = rz[:, 0::2] + rz[:, 1::2]
    return ry[:, :, 0::2] + ry[:, :, 1::2]


def restrict_2d(r: torch.Tensor) -> torch.Tensor:
    """2-D levels: coarse = sum of the 4 fine children
    (fine2coarse_2D, mg_intergrids.f90:104-122)."""
    assert r.shape[0] == 1
    ry = r[:, 0::2] + r[:, 1::2]
    return ry[:, :, 0::2] + ry[:, :, 1::2]


def restrict_aggressive(r: torch.Tensor) -> torch.Tensor:
    """8:1 vertical-only averaging (fine2coarse_aggressive,
    mg_intergrids.f90:75-101): the mean of 8 vertically stacked cells."""
    nz, ny, nx = r.shape
    return 0.125 * r.reshape(nz // 8, 8, ny, nx).sum(dim=1)


def restrict(r: torch.Tensor, aggressive: bool = False) -> torch.Tensor:
    if aggressive:
        return restrict_aggressive(r)
    if r.shape[0] == 1:
        return restrict_2d(r)
    return restrict_3d(r)


def _interleave(a0: torch.Tensor, a1: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """out[..., 2m] = a0[..., m], out[..., 2m+1] = a1[..., m] along
    ``axis`` — two strided writes."""
    ax = axis % a0.ndim
    shape = list(a0.shape)
    shape[ax] *= 2
    out = a0.new_empty(shape)
    idx = [slice(None)] * a0.ndim
    idx[ax] = slice(0, None, 2)
    out[tuple(idx)] = a0
    idx[ax] = slice(1, None, 2)
    out[tuple(idx)] = a1
    return out


def _bilinear_combos(xce: torch.Tensor) -> dict:
    """The four horizontal bilinear combinations H[t, s] per coarse cell,
    weights a=9/16, b=3/16, c=1/16 (mg_intergrids.f90:377-379); the fine
    child at parity (t, s) leans toward the coarse neighbour at
    (j-1 if t==0 else j+1, i-1 if s==0 else i+1).  ``xce`` is the halo-1
    extended coarse field."""
    a, b_, c = 9.0 / 16.0, 3.0 / 16.0, 1.0 / 16.0
    J, I = xce.shape[-2:]

    def S(dj, di):
        return xce[..., 1 + dj: J - 1 + dj, 1 + di: I - 1 + di]

    H = {}
    for t, dj in ((0, -1), (1, 1)):
        for s, di in ((0, -1), (1, 1)):
            H[t, s] = (a * S(0, 0) + b_ * S(dj, 0)
                       + b_ * S(0, di) + c * S(dj, di))
    return H


def _vprofile(Hc: torch.Tensor) -> torch.Tensor:
    """Linear in z: even fine rows 0.75*H[kc] + 0.25*H[kc-1] (bottom row
    pure H, :394-405), odd rows 0.75*H[kc] + 0.25*H[kc+1] (top row 0.5*H,
    the Dirichlet surface, :434-446)."""
    ev = torch.cat([Hc[0:1], 0.75 * Hc[1:] + 0.25 * Hc[:-1]], dim=0)
    od = torch.cat([0.75 * Hc[:-1] + 0.25 * Hc[1:], 0.5 * Hc[-1:]], dim=0)
    return _interleave(ev, od, axis=0)


def prolong_3d_linear_quads(xce: torch.Tensor) -> dict:
    """Trilinear prolongation emitting the fine field in quad-parity layout
    ``{(t, s): V[t, s]}``: the fine child at horizontal parity (t, s) is the
    (t, s) quad, so no horizontal interleave is needed."""
    return {ts: _vprofile(Hc) for ts, Hc in _bilinear_combos(xce).items()}


def prolong_3d_linear(xce: torch.Tensor) -> torch.Tensor:
    """Trilinear prolongation (coarse2fine_3D_linear, mg_intergrids.f90:
    366-450) from the halo-extended coarse (nzc, nyc+2, nxc+2) to the fine
    interior (2*nzc, 2*nyc, 2*nxc)."""
    V = prolong_3d_linear_quads(xce)
    lo = _interleave(V[0, 0], V[1, 0], axis=-2)
    hi = _interleave(V[0, 1], V[1, 1], axis=-2)
    return _interleave(lo, hi, axis=-1)


def prolong_3d_nearest_quads(xce: torch.Tensor) -> dict:
    """8-way injection in quad layout: every quad is the z-doubled coarse
    field (coarse2fine_3D_nearest, mg_intergrids.f90:336-363)."""
    xc = xce[..., 1:-1, 1:-1]
    xz = _interleave(xc, xc, axis=0)
    return {(t, s): xz for t in (0, 1) for s in (0, 1)}


def prolong_3d_nearest(xce: torch.Tensor) -> torch.Tensor:
    """8-way injection (coarse2fine_3D_nearest, mg_intergrids.f90:336-363)."""
    xz = prolong_3d_nearest_quads(xce)[0, 0]
    xy = _interleave(xz, xz, axis=-2)
    return _interleave(xy, xy, axis=-1)


def prolong_2d_linear(xce: torch.Tensor) -> torch.Tensor:
    """Bilinear prolongation for nz == 1 levels (coarse2fine_2D_linear,
    mg_intergrids.f90:295-333)."""
    H = _bilinear_combos(xce)
    lo = _interleave(H[0, 0], H[1, 0], axis=-2)
    hi = _interleave(H[0, 1], H[1, 1], axis=-2)
    return _interleave(lo, hi, axis=-1)


def prolong_2d_nearest(xce: torch.Tensor) -> torch.Tensor:
    """4-way injection (coarse2fine_2D_nearest, mg_intergrids.f90:
    250-292)."""
    xc = xce[..., 1:-1, 1:-1]
    xy = _interleave(xc, xc, axis=-2)
    return _interleave(xy, xy, axis=-1)


def prolong(xce: torch.Tensor, fine_nz: int, interp_type: str,
            aggressive: bool = False, as_quads: bool = False):
    """Dispatch (coarse2fine, mg_intergrids.f90:196-222).  With
    ``as_quads`` the result is the quad dict
    ``{(y-parity, x-parity): (fine_nz, nyc, nxc)}``.  A 2-D fine level
    takes the 2-D forms; the aggressive prolongation raises, as the
    reference stops there (coarse2fine_aggressive,
    mg_intergrids.f90:231-247)."""
    if aggressive:
        raise NotImplementedError("aggressive prolongation not available "
                                  "(parity with mg_intergrids.f90:243-244)")
    if fine_nz == 1:
        assert not as_quads, "2-D levels are never quad-persistent"
        if interp_type == "linear":
            return prolong_2d_linear(xce)
        return prolong_2d_nearest(xce)
    assert xce.shape[0] * 2 == fine_nz
    if as_quads:
        return (prolong_3d_linear_quads(xce) if interp_type == "linear"
                else prolong_3d_nearest_quads(xce))
    if interp_type == "linear":
        return prolong_3d_linear(xce)
    return prolong_3d_nearest(xce)
