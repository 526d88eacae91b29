"""Explicit halo exchange: neighbour edge copies inside shard_map.

Port of ``mgroms_tpu/parallel/exchange.py`` (reference MPI halo protocol,
``src/mg_mpi_exchange.f90``: 8-direction exchange with the physical BCs
folded into the fill where a neighbour is ``MPI_PROC_NULL``, :104-324).
Each direction is a :func:`~.mesh.ppermute` — a copy of an edge slice to
the neighbour tile's device — and domain-edge tiles substitute the
homogeneous-Neumann mirror (edge copy, the nh=1 rule of bc.extend_h1).

Corners: the exchange is two-phase — x first, then y on the x-extended
rows — so corner halo cells arrive transitively through the cardinal
neighbours (mg_mpi_exchange.f90:326-349 has the same result).

The exchange functions run inside :func:`~.mesh.shard_map` (the mesh axes
('py', 'px') active there); arrays are a tile's local blocks
(nz, ny_l, nx_l).  The blocked-layout helpers at the end act on global
tensors, as the JAX package's do, and are copies of them.
"""

from __future__ import annotations

import torch

from .mesh import axis_index, axis_size, current_device, ppermute, psum


def _extend_axis(x: torch.Tensor, axis_name, ax: int) -> torch.Tensor:
    """Halo-1 extension of local ``x`` along dimension ``ax`` (sharded over
    mesh axis ``axis_name``): neighbour edge slices, physical mirror (edge
    copy) at the domain boundary.  ``axis_name=None`` (axis dropped by
    staged agglomeration — the tile spans the domain there) applies the
    physical mirror only."""
    n = 1 if axis_name is None else axis_size(axis_name)
    m = x.shape[ax]
    lo_edge = x.narrow(ax, 0, 1)
    hi_edge = x.narrow(ax, m - 1, 1)
    if n == 1:
        lo_halo, hi_halo = lo_edge, hi_edge
    else:
        idx = axis_index(axis_name)
        # from my lower neighbour: its high edge (fills my low halo)
        from_lo = ppermute(hi_edge, axis_name,
                           [(i, i + 1) for i in range(n - 1)])
        # from my upper neighbour: its low edge (fills my high halo)
        from_hi = ppermute(lo_edge, axis_name,
                           [(i + 1, i) for i in range(n - 1)])
        lo_halo = lo_edge if idx == 0 else from_lo
        hi_halo = hi_edge if idx == n - 1 else from_hi
    return torch.cat([lo_halo, x, hi_halo], dim=ax)


def halo_extend(x: torch.Tensor, py_axis: str = "py", px_axis: str = "px"
                ) -> torch.Tensor:
    """Local (…, ny_l, nx_l) -> (…, ny_l+2, nx_l+2) with neighbour data at
    tile seams and Neumann-mirror physical BCs at domain edges.  x-phase
    first, then y on the x-extended rows (corners ride along)."""
    x = _extend_axis(x, px_axis, x.ndim - 1)
    return _extend_axis(x, py_axis, x.ndim - 2)


def _edge_pair(lo_own, hi_own, lo_mirror, hi_mirror, axis_name):
    """Seam halos for a quad pair along one mesh axis: receive the
    neighbour's edge slice, substitute the physical mirror at the domain
    boundary.  ``lo_own``/``hi_own`` are the slices this tile SENDS;
    ``lo_mirror``/``hi_mirror`` the in-tile mirror values used at the
    domain edges.  ``axis_name=None`` (dropped axis): mirror only."""
    n = 1 if axis_name is None else axis_size(axis_name)
    if n == 1:
        return lo_mirror, hi_mirror
    idx = axis_index(axis_name)
    from_lo = ppermute(hi_own, axis_name, [(i, i + 1) for i in range(n - 1)])
    from_hi = ppermute(lo_own, axis_name, [(i + 1, i) for i in range(n - 1)])
    lo = lo_mirror if idx == 0 else from_lo
    hi = hi_mirror if idx == n - 1 else from_hi
    return lo, hi


def extend_quads_shard(q, py_axis: str = "py", px_axis: str = "px"):
    """Distributed quad-parity halo extension (inside shard_map).

    The seam image of ops/relax_compact.extend_quads: full j = -1 is the
    south neighbour's j = ny_l-1 (its quad a=1 row H-1); full j = ny_l is
    the north neighbour's j = 0 (quad a=0 row 0); physical edges keep the
    Neumann mirror from sibling quads.  Requires even local tiles so local
    quad parity equals global parity.  Two-phase (j then i on the
    j-extended arrays) so corner cells arrive transitively.
    """
    rj = {}
    for b in (0, 1):
        q0, q1 = q[(0, b)], q[(1, b)]
        # halo below quad1 (j=-1) / above quad0 (j=ny_l)
        lo, hi = _edge_pair(lo_own=q0[:, :1], hi_own=q1[:, -1:],
                            lo_mirror=q0[:, :1], hi_mirror=q1[:, -1:],
                            axis_name=py_axis)
        rj[(0, b)] = torch.cat([q0[:, :1], q0, hi], dim=1)
        rj[(1, b)] = torch.cat([lo, q1, q1[:, -1:]], dim=1)
    e = {}
    for a in (0, 1):
        r0, r1 = rj[(a, 0)], rj[(a, 1)]
        lo, hi = _edge_pair(lo_own=r0[:, :, :1], hi_own=r1[:, :, -1:],
                            lo_mirror=r0[:, :, :1], hi_mirror=r1[:, :, -1:],
                            axis_name=px_axis)
        e[(a, 0)] = torch.cat([r0[:, :, :1], r0, hi], dim=2)
        e[(a, 1)] = torch.cat([lo, r1, r1[:, :, -1:]], dim=2)
    return e


def axis_offsets(ny_l: int, nx_l: int, py_axis="py", px_axis="px"):
    """Global interior origin (j0, i0) of this tile — feeds the global
    red-black parity (reference colour rule mod(i+j), mg_relax.f90:172).
    A ``None`` axis (dropped by staged agglomeration) has origin 0."""
    j0 = axis_index(py_axis) * ny_l if py_axis else 0
    i0 = axis_index(px_axis) * nx_l if px_axis else 0
    return j0, i0


def psum2(x: torch.Tensor, py_axis: str = "py", px_axis: str = "px"):
    """Global scalar reduction over the mesh (``global_sum``,
    mg_mpi_exchange.f90:1555-1571): over x, then over y."""
    return psum(psum(x, px_axis), py_axis)


def block_overlapped(a: torch.Tensor, npy: int, npx: int,
                     extra_j: int, extra_i: int) -> torch.Tensor:
    """Blocked per-tile layout of a global array whose last two dims carry
    ``extra_j``/``extra_i`` overlap rows/columns beyond npy*ny_l / npx*nx_l
    (halo rings, staggered shared faces).  Block (pj, pi) holds global rows
    [pj*ny_l, pj*ny_l + ny_l + extra_j) x the analogous columns — adjacent
    blocks duplicate the overlap, the reference's per-rank staggered
    storage (u(1:nx+1,0:ny+1,:) etc, nhydro.f90:56-59)."""
    nyg = a.shape[-2] - extra_j
    nxg = a.shape[-1] - extra_i
    ny_l, nx_l = nyg // npy, nxg // npx
    rows = []
    for pj in range(npy):
        cols = []
        for pi in range(npx):
            cols.append(a[..., pj * ny_l: pj * ny_l + ny_l + extra_j,
                          pi * nx_l: pi * nx_l + nx_l + extra_i])
        rows.append(torch.cat(cols, dim=-1))
    return torch.cat(rows, dim=-2)


def unblock_overlapped(ab: torch.Tensor, npy: int, npx: int,
                       extra_j: int, extra_i: int) -> torch.Tensor:
    """Inverse of :func:`block_overlapped` (overlap values agree by
    construction; each global entry is taken from one owner block)."""
    bj = ab.shape[-2] // npy            # ny_l + extra_j
    bi = ab.shape[-1] // npx
    ny_l, nx_l = bj - extra_j, bi - extra_i
    rows = []
    for pj in range(npy):
        blk = ab[..., pj * bj: (pj + 1) * bj, :]
        if pj < npy - 1:
            blk = blk[..., :ny_l, :]
        cols = []
        for pi in range(npx):
            c = blk[..., pi * bi: (pi + 1) * bi]
            if pi < npx - 1:
                c = c[..., :nx_l]
            cols.append(c)
        rows.append(torch.cat(cols, dim=-1))
    return torch.cat(rows, dim=-2)


def shard_face_masks(ny_l: int, nx_l: int, dtype,
                     py_axis: str = "py", px_axis: str = "px"):
    """Per-tile velocity-flux face masks: zero the wall-normal flux only at
    PHYSICAL walls (the distributed image of ops/rhs.wall_face_masks — the
    reference's ``lbc_null`` Dirichlet, mg_mpi_exchange.f90:952-1013).
    Runs inside shard_map; the masks are on the tile's device."""
    pi = axis_index(px_axis)
    pj = axis_index(py_axis)
    west = pi == 0
    east = pi == axis_size(px_axis) - 1
    south = pj == 0
    north = pj == axis_size(py_axis) - 1
    dev = current_device()
    um = torch.ones((ny_l, nx_l + 1), dtype=dtype, device=dev)
    if west:
        um[:, 0] = 0.0
    if east:
        um[:, nx_l] = 0.0
    vm = torch.ones((ny_l + 1, nx_l), dtype=dtype, device=dev)
    if south:
        vm[0, :] = 0.0
    if north:
        vm[ny_l, :] = 0.0
    return um, vm


def block_extended(a_ext: torch.Tensor, npy: int, npx: int) -> torch.Tensor:
    """Per-tile-extended blocked layout of a halo-extended global field:
    ``a_ext`` (…, nyg+2, nxg+2) to (…, npy*(ny_l+2), npx*(nx_l+2)), block
    (pj, pi) holding that tile's interior plus its own halo ring —
    neighbour-region values at interior seams, the physical ring at domain
    edges (the reference's per-rank ``cA(nd,nz,0:ny+1,0:nx+1)`` storage,
    mg_grids.f90:24-65)."""
    return block_overlapped(a_ext, npy, npx, 2, 2)
