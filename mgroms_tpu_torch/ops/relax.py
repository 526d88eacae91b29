"""Line relaxation: masked red-black z-line smoothing and the Thomas solves.

Port of ``mgroms_tpu/ops/relax.py`` (reference src/mg_relax.f90:16-334).
The tridiagonal RHS is built for every column at once
(ops/stencil.offdiag_columns), all columns are Thomas-solved together by a
loop over z whose steps are elementwise (ny, nx) ops, and only the active
colour is committed through a mask; the halo is refreshed per colour
(mg_relax.f90:181).  Three orderings, as in the JAX package: 'RB' (two
colours by (i + j) parity), 'FC' (four colours by (i, j) parity, the
reference order) and 'GS' (one all-ones mask: every column from the
pre-sweep state, the JAX package's column-Jacobi deviation from the
reference's sequential sweep, PARITY.md).  The port runs this masked form
on the full-layout levels (the coarsest, every level of a GS solve or of
``compact=False``, and the tiles of distributed levels with odd local
dims, with their global origin ``j0, i0``); every other level runs the
quad-parity form (ops/relax_compact.py and its kernels).

Two further modes of the JAX package: the tridiagonal solve by parallel
cyclic reduction (:func:`tridiag_pcr`, ``tridiag='pcr'``) and the
order-exact sequential Gauss-Seidel sweep (:func:`relax_gs_exact`,
``gs_exact``), a parity mode of nx*ny column steps with no kernel in
either package.
"""

from __future__ import annotations

from typing import Callable

import torch

from .stencil import band, offdiag_columns

ExtendFn = Callable[[torch.Tensor], torch.Tensor]


def thomas_factor(d: torch.Tensor, ud: torch.Tensor):
    """Thomas pivots: ``bet`` (reciprocal pivots, nz) and ``gam``
    (back-substitution multipliers, nz-1), in the op order of
    :func:`tridiag` (mg_relax.f90:308-334), so factored solves equal the
    sequential Thomas bitwise."""
    nz = d.shape[0]
    bet = torch.empty_like(d)
    gam = torch.empty_like(d[:nz - 1])
    bet[0] = 1.0 / d[0]
    for k in range(1, nz):
        gam[k - 1] = ud[k - 1] * bet[k - 1]
        bet[k] = 1.0 / (d[k] - ud[k - 1] * gam[k - 1])
    return bet, gam


def thomas_factored_unrolled(bet: torch.Tensor, gam, ud: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Thomas substitution with precomputed pivots: forward
    x_k = (b_k - ud_{k-1} x_{k-1}) * bet_k, backward x_k -= gam_k x_{k+1}.

    ``gam`` may be None: thomas_factor computes ``gam[k] = ud[k] * bet[k]``,
    so the same product is recomputed per plane (the kernels' form).
    Bitwise-identical either way."""
    nz = b.shape[0]
    if nz == 1:
        return b * bet
    x = torch.empty_like(b)
    x[0] = b[0] * bet[0]
    for k in range(1, nz):
        x[k] = (b[k] - ud[k - 1] * x[k - 1]) * bet[k]
    for k in range(nz - 2, -1, -1):
        gk = gam[k] if gam is not None else ud[k] * bet[k]
        x[k] = x[k] - gk * x[k + 1]
    return x


def tridiag_factored(bet: torch.Tensor, gam: torch.Tensor, ud: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Thomas substitution with precomputed pivots (:func:`thomas_factor`);
    no divisions; bitwise-equal to :func:`tridiag`."""
    return thomas_factored_unrolled(bet, gam, ud, b)


def tridiag_pcr(d: torch.Tensor, dd: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Parallel cyclic reduction solve of the systems :func:`tridiag`
    solves (JAX ``tridiag_pcr``): exact in exact arithmetic, built from
    ceil(log2(nz)) whole-column steps, with the JAX package's operation
    order (shifts padded with 0, the pivots' with 1)."""
    nz = d.shape[0]
    if nz == 1:
        return b / d
    z1 = torch.zeros_like(dd[:1])
    lo = torch.cat([z1, dd], dim=0)          # a_k
    up = torch.cat([dd, z1], dim=0)          # c_k
    diag, rhs = d, b
    s = 1
    while s < nz:
        def shdn(x, fill=0.0):               # x_{k-s}
            return torch.cat([torch.full_like(x[:s], fill), x[:-s]], dim=0)

        def shup(x, fill=0.0):               # x_{k+s}
            return torch.cat([x[s:], torch.full_like(x[:s], fill)], dim=0)

        alpha = -lo / shdn(diag, 1.0)
        gamma = -up / shup(diag, 1.0)
        diag = diag + alpha * shdn(up) + gamma * shup(lo)
        rhs = rhs + alpha * shdn(rhs) + gamma * shup(rhs)
        lo = alpha * shdn(lo)
        up = gamma * shup(up)
        s *= 2
    return rhs / diag


def tridiag(d: torch.Tensor, dd: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """Thomas solve of symmetric tridiagonal systems batched over (ny, nx)
    (``tridiag``, mg_relax.f90:308-334): ``d`` (nz, ...) diagonal, ``dd``
    (nz-1, ...) off-diagonal coupling k <-> k+1, ``b`` the RHS."""
    nz = d.shape[0]
    if nz == 1:
        return b / d
    x = torch.empty_like(b)
    gam = torch.empty_like(dd)
    bet = 1.0 / d[0]
    x[0] = b[0] * bet
    for k in range(1, nz):
        gam[k - 1] = dd[k - 1] * bet
        bet = 1.0 / (d[k] - dd[k - 1] * gam[k - 1])
        x[k] = (b[k] - dd[k - 1] * x[k - 1]) * bet
    for k in range(nz - 2, -1, -1):
        x[k] = x[k] - gam[k] * x[k + 1]
    return x


def _column_solve(pe: torch.Tensor, b: torch.Tensor, cA: torch.Tensor,
                  real_matrix: bool, method: str = "thomas") -> torch.Tensor:
    """Exact solve of every z-column given the current neighbour columns
    (relax_3D_8_heart for all (i, j) at once), by Thomas or PCR."""
    rhs = b - offdiag_columns(pe, cA, real_matrix)
    d = band(cA, 1)
    ud = cA[1][1:, 1:-1, 1:-1]      # ud(k) = cA2(k+1) (mg_relax.f90:279,290)
    solver = tridiag_pcr if method == "pcr" else tridiag
    return solver(d, ud, rhs)


def _parity_mask(ny: int, nx: int, c: int, j0: int, i0: int,
                 like: torch.Tensor) -> torch.Tensor:
    """Columns of colour ``c``: global (i + j + c) even selects colour 0
    first (reference sweep order ``j = 1+mod(i+rb,2)``,
    mg_relax.f90:172-174).  ``j0, i0`` are the global offsets of this
    tile's interior origin."""
    jj = torch.arange(ny, device=like.device)[:, None] + j0
    ii = torch.arange(nx, device=like.device)[None, :] + i0
    return ((jj + ii + c) % 2 == 0).to(like.dtype)


def colour_masks(kind: str, ny: int, nx: int, j0: int, i0: int,
                 like: torch.Tensor) -> list:
    """The masks of one sweep, in order: 'RB' the two parity colours,
    'FC' the four colours of the reference order (mg_relax.f90:214-228):
    (i even, j even), (i even, j odd), (i odd, j even), (i odd, j odd),
    'GS' one all-ones mask.  ``j0, i0``: the tile's global origin."""
    if kind == "RB":
        return [_parity_mask(ny, nx, c, j0, i0, like) for c in (0, 1)]
    if kind == "FC":
        jj = torch.arange(ny, device=like.device)[:, None] + j0
        ii = torch.arange(nx, device=like.device)[None, :] + i0
        return [(((ii % 2) == t) & ((jj % 2) == s)).to(like.dtype)
                for t, s in ((0, 0), (0, 1), (1, 0), (1, 1))]
    if kind == "GS":
        return [like.new_ones((ny, nx))]
    raise ValueError(f"unknown relax kind {kind!r}")


def relax(p: torch.Tensor, b: torch.Tensor, cA: torch.Tensor,
          nsweeps: int, kind: str, real_matrix: bool,
          extend_fn: ExtendFn, j0: int = 0, i0: int = 0,
          tridiag_method: str = "thomas") -> torch.Tensor:
    """``nsweeps`` masked sweeps of ordering ``kind`` (``relax``,
    mg_relax.f90:16-47, :func:`colour_masks`); ``extend_fn`` supplies the
    halo (physical BCs and/or neighbour tiles) once per colour; ``j0,
    i0`` the tile's global origin (the colouring).  Every colour commits
    ``p + mask * (sol - p)``, GS's all-ones mask too (in floating point
    that is not ``sol``).  ``tridiag_method`` 'thomas' or 'pcr' solves the
    columns (:func:`tridiag`, :func:`tridiag_pcr`)."""
    ny, nx = p.shape[-2:]
    masks = colour_masks(kind, ny, nx, j0, i0, p)
    for _ in range(nsweeps):
        for mask in masks:
            sol = _column_solve(extend_fn(p), b, cA, real_matrix,
                                tridiag_method)
            p = p + mask * (sol - p)
    return p


def relax_gs_exact(p: torch.Tensor, b: torch.Tensor, cA: torch.Tensor,
                   nsweeps: int, real_matrix: bool,
                   extend_fn: ExtendFn) -> torch.Tensor:
    """Order-exact sequential Gauss-Seidel (``relax_3D_8_GS``,
    mg_relax.f90:116-148; JAX ``relax_gs_exact``): the columns are
    updated one at a time, i outer and j inner, each reading the updated
    values of every column visited before it; the halo is refreshed once a
    sweep (:141), so halo reads see the sweep's start.  The gather sums
    ``_BASE_TERMS`` then ``_REAL_TERMS`` (plane 0 only) in their order, as
    relax_3D_8_heart (:263-300), and each column is a Thomas solve.

    A parity mode: nx*ny dependent column steps a sweep, a few dozen small
    torch operations each, on either device (the JAX package has no
    kernel for it either).  Use it at small sizes."""
    from .relax_compact import _BASE_TERMS, _REAL_TERMS, _kshift
    nz, ny, nx = p.shape
    k0 = None
    if real_matrix:
        k0 = (torch.arange(nz, device=p.device) == 0).to(p.dtype)
    for _ in range(nsweeps):
        pe = extend_fn(p).clone()
        for i in range(nx):                  # i outer, j inner (:133-134)
            for j in range(ny):
                nb = pe[:, j:j + 3, i:i + 3]
                cb = cA[:, :, j:j + 3, i:i + 3]

                def term(n, boff, poff):
                    bk, bj, bi = boff
                    pk, pj, pi = poff
                    return (_kshift(cb[n - 1, :, 1 + bj, 1 + bi], bk)
                            * _kshift(nb[:, 1 + pj, 1 + pi], pk))

                s = None
                for n, boff, poff in _BASE_TERMS:
                    t = term(n, boff, poff)
                    s = t if s is None else s + t
                if real_matrix:
                    x = None
                    for n, boff, poff in _REAL_TERMS:
                        t = term(n, boff, poff)
                        x = t if x is None else x + t
                    s = s + k0 * x
                pe[:, j + 1, i + 1] = tridiag(cb[0, :, 1, 1],
                                              cb[1, 1:, 1, 1],
                                              b[:, j, i] - s)
        p = pe[:, 1:-1, 1:-1]
    return p
