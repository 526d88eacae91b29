"""K7 (ops/kernels/rdma_halo.py): the x-seam residual of a (1, npx) mesh.

On the CPU the wrapper runs its plain version — ops/stencil.residual on
parallel/exchange.halo_extend of the tile — which is held to JAX's
``residual_overlap_x`` (Pallas interpret mode, its remote DMAs simulated
on the virtual CPU mesh) and to the global residual, as
tests/test_rdma.py holds JAX's.  The kernel itself is held to the plain
version on the card (tests/test_torch_kernels_cuda.py); its wrapper's
peer-access rule is checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mgroms_tpu.ops.pallas.rdma_halo import residual_overlap_x as jk7
from mgroms_tpu.parallel.exchange import block_extended
from mgroms_tpu_torch.bc import extend_h1
from mgroms_tpu_torch.ops import stencil
from mgroms_tpu_torch.ops.kernels import rdma_halo as k7
from mgroms_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

NPX = 4


def _problem(nz, ny, nx, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nz, ny, nx)),
            rng.standard_normal((nz, ny, nx)),
            rng.standard_normal((8, nz, ny + 2, nx + 2)))


def _port(p, b, cA, real, npx=NPX):
    mesh = tmesh.make_mesh(npx, 1, ["cpu"] * npx)
    tl = lambda a, extra=(0, 0): tmesh.split_tiles(
        torch.tensor(a), (1, npx), mesh.devices, extra)
    k7.reset_launches()
    r = tmesh.shard_map(lambda p_l, b_l, c_l: k7.residual_overlap_x(
        p_l, b_l, c_l, real), mesh)(tl(p), tl(b), tl(cA, (2, 2)))
    assert k7.LAUNCHES["residual_overlap_x"] == 0     # CPU: plain version
    return tmesh.join_tiles(r, "cpu").numpy()


@pytest.mark.parametrize("real_matrix", [False, True])
def test_plain_matches_jax_k7(real_matrix):
    nz, ny, nx = 6, 16, 64
    p, b, cA = _problem(nz, ny, nx, 3)
    mesh = Mesh(np.array(jax.devices()[:NPX]).reshape(1, NPX), ("py", "px"))
    f = jax.shard_map(
        lambda p_l, b_l, c_l: jk7(p_l, b_l, c_l, real_matrix,
                                  interpret=True),
        mesh=mesh, in_specs=(P(None, None, "px"), P(None, None, "px"),
                             P(None, None, None, "px")),
        out_specs=P(None, None, "px"), check_vma=False)
    want = np.asarray(f(jnp.asarray(p), jnp.asarray(b),
                        block_extended(jnp.asarray(cA), 1, NPX)))
    got = _port(p, b, cA, real_matrix)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("npx,nx", [(1, 8), (2, 4), (3, 6), (4, 8)])
@pytest.mark.parametrize("real_matrix", [False, True])
def test_plain_equals_global_residual(npx, nx, real_matrix):
    """Every mesh width down to two columns per tile: the tiles' residuals
    are the global residual, bit for bit."""
    p, b, cA = _problem(3, 5, nx, npx + nx)
    want = stencil.residual(extend_h1(torch.tensor(p)), torch.tensor(b),
                            torch.tensor(cA), real_matrix).numpy()
    np.testing.assert_array_equal(_port(p, b, cA, real_matrix, npx), want)


def test_k7_needs_a_one_row_mesh():
    mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    z = tmesh.Tiles([[torch.zeros(2, 3, 4)] * 2] * 2)
    c = tmesh.Tiles([[torch.zeros(8, 2, 5, 6)] * 2] * 2)
    with pytest.raises(ValueError, match=r"\(1, npx\) mesh"):
        tmesh.shard_map(lambda p_l, c_l: k7.residual_overlap_x(
            p_l, p_l, c_l, True), mesh)(z, c)


def test_peer_rule():
    """A neighbour tile on another card needs peer access; one on the CPU
    is refused; the same card always passes."""
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    k7.check_peer(d0, d0, can_access=lambda a, b: False)
    k7.check_peer(d0, d1, can_access=lambda a, b: True)
    with pytest.raises(RuntimeError, match="no peer access"):
        k7.check_peer(d0, d1, can_access=lambda a, b: False)
    with pytest.raises(ValueError, match="CUDA tiles"):
        k7.check_peer(d0, torch.device("cpu"))


# ------------------------------------------- the kernel's block recipe

def np_k7_tile(p, b, cA, real, pw=None, pe=None, tile=k7.TILE,
               ring=k7.RING):
    """csrc/rdma_halo.cu's recipe for one tile in numpy: the blocks in
    rdma_halo.block_order, each walking the planes through a ring of
    ``ring`` slots (planes 0 .. ring-3 staged first, plane k+1+(ring-3)
    staged into plane k-2's slot at step k).  A slot holds the state
    window (rows j0-1 .. j0+rows clamped to the tile, columns -1 .. cols:
    the neighbour tile column, the seam from ``pw``/``pe`` or the mirror),
    b and the 8 band windows (bands 3-5 a row taller, 6-8 a column wider;
    reference numbering); unstaged cells are NaN, and a read of a plane
    its slot does not hold fails.  The two plane-0 'real' band values off
    the windows are read from ``cA``.  Returns r and the blocks in the
    order they ran."""
    nz, ny, nx = p.shape
    tj, ti = tile
    ahead = ring - 3
    r = np.full_like(b, np.nan)
    order = k7.block_order(ny, nx, tile)
    for bj, bi in order:
        j0, i0 = bj * tj, bi * ti
        rows, cols = min(tj, ny - j0), min(ti, nx - i0)
        rws = [min(max(j0 - 1 + w, 0), ny - 1) for w in range(rows + 2)]
        slots = [None] * ring

        def stage(k):
            st = np.full((tj + 2, ti + 2), np.nan)
            st[:rows + 2, 1:cols + 1] = p[k][rws, i0:i0 + cols]
            st[:rows + 2, 0] = (p[k][rws, i0 - 1] if i0 > 0 else
                                pw[k][rws, -1] if pw is not None else
                                p[k][rws, 0])
            st[:rows + 2, cols + 1] = (
                p[k][rws, i0 + cols] if i0 + cols < nx else
                pe[k][rws, 0] if pe is not None else p[k][rws, nx - 1])
            bw = np.full((tj, ti), np.nan)
            bw[:rows, :cols] = b[k, j0:j0 + rows, i0:i0 + cols]
            bands = np.full((8, tj + 1, ti + 1), np.nan)
            for n in range(8):
                nr, nc = rows + (2 <= n <= 4), cols + (n >= 5)
                bands[n, :nr, :nc] = cA[n, k, j0 + 1:j0 + 1 + nr,
                                        i0 + 1:i0 + 1 + nc]
            slots[k % ring] = (k, st, bw, bands)

        def slot(kk):
            if kk < 0 or kk >= nz:
                return None
            held = slots[kk % ring]
            assert held is not None and held[0] == kk, (kk, held)
            return held

        for q in range(min(ahead + 1, nz)):
            stage(q)
        zero = np.zeros((rows, cols))
        for k in range(nz):
            if k + 1 + ahead < nz:
                stage(k + 1 + ahead)

            def st(dk, dj, di):
                s = slot(k + dk)
                return zero if s is None else \
                    s[1][1 + dj:1 + dj + rows, 1 + di:1 + di + cols]

            def bd(n, dk, dj, di):
                s = slot(k + dk)
                return zero if s is None else \
                    s[3][n, dj:dj + rows, di:di + cols]

            s = bd(2, 0, 0, 0) * st(1, -1, 0)
            s = s + bd(2, -1, 1, 0) * st(-1, 1, 0)
            s = s + bd(3, 0, 0, 0) * st(0, -1, 0)
            s = s + bd(3, 0, 1, 0) * st(0, 1, 0)
            s = s + bd(4, 0, 0, 0) * st(-1, -1, 0)
            s = s + bd(4, 1, 1, 0) * st(1, 1, 0)
            s = s + bd(5, 0, 0, 0) * st(1, 0, -1)
            s = s + bd(5, -1, 0, 1) * st(-1, 0, 1)
            s = s + bd(6, 0, 0, 0) * st(0, 0, -1)
            s = s + bd(6, 0, 0, 1) * st(0, 0, 1)
            s = s + bd(7, 0, 0, 0) * st(-1, 0, -1)
            s = s + bd(7, 1, 0, 1) * st(1, 0, 1)
            if real and k == 0:
                b4 = cA[4, 0, j0:j0 + rows, i0 + 2:i0 + 2 + cols]
                b7 = cA[7, 0, j0 + 2:j0 + 2 + rows, i0 + 2:i0 + 2 + cols]
                x0 = bd(4, 0, 0, 0) * st(0, 1, -1)
                x0 = x0 + b4 * st(0, -1, 1)
                x0 = x0 + bd(7, 0, 0, 0) * st(0, -1, -1)
                x0 = x0 + b7 * st(0, 1, 1)
                s = s + x0
            r[k, j0:j0 + rows, i0:i0 + cols] = (
                slot(k)[2][:rows, :cols] - bd(0, 0, 0, 0) * st(0, 0, 0)
                - bd(1, 0, 0, 0) * st(-1, 0, 0) - bd(1, 1, 0, 0) * st(1, 0, 0)
                - s)
    return r, order


def np_k7(p, b, cA, real, npx):
    """The recipe on each tile of a (1, npx) cut (np.array_split's, as
    parallel.mesh.split_tiles cuts), each tile reading its neighbours'
    columns in place; the tiles' r joined."""
    cuts = np.cumsum([0] + [t.shape[2] for t in
                            np.array_split(p, npx, axis=2)])
    tiles = [p[:, :, a:c] for a, c in zip(cuts, cuts[1:])]
    out = []
    for t, (a, c) in enumerate(zip(cuts, cuts[1:])):
        r, _ = np_k7_tile(tiles[t], b[:, :, a:c], cA[:, :, :, a:c + 2], real,
                          tiles[t - 1] if t else None,
                          tiles[t + 1] if t < npx - 1 else None)
        out.append(r)
    return np.concatenate(out, axis=2)


# (nz, ny, npx, nx): 2, 33 and 70 columns a tile against the 32-column
# block tile; 7, 9, 17 and 33 rows against its 16 (the y mirror in the
# last block row); one tile exactly one block wide with both seams; nz 1
# and 2
K7_RAGGED = [(1, 7, 1, 2), (2, 9, 2, 66), (1, 17, 3, 210), (2, 7, 4, 8),
             (2, 33, 2, 140), (1, 9, 3, 96), (2, 17, 4, 280)]


@pytest.mark.parametrize("nz,ny,npx,nx", K7_RAGGED)
@pytest.mark.parametrize("real_matrix", [False, True])
def test_block_recipe_matches_plain(nz, ny, npx, nx, real_matrix):
    """The kernel's block recipe (tile and halo staging, the plane ring,
    the seam from the neighbours or the mirror) == the plain version
    through shard_map, in float64, to 1e-12 x max|b|."""
    p, b, cA = _problem(nz, ny, nx, nz + ny + nx + npx)
    got = np_k7(p, b, cA, real_matrix, npx)
    want = _port(p, b, cA, real_matrix, npx)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("nz,ny,npx,nx", [(2, 9, 2, 66), (1, 17, 4, 280)])
@pytest.mark.parametrize("real_matrix", [False, True])
def test_block_recipe_matches_jax_k7(nz, ny, npx, nx, real_matrix):
    """The block recipe == JAX's residual_overlap_x (Pallas interpret
    mode, its remote DMAs simulated on the CPU mesh) at ragged tiles, to
    1e-12 x max|b|."""
    p, b, cA = _problem(nz, ny, nx, 7 * nz + ny)
    mesh = Mesh(np.array(jax.devices()[:npx]).reshape(1, npx), ("py", "px"))
    f = jax.shard_map(
        lambda p_l, b_l, c_l: jk7(p_l, b_l, c_l, real_matrix,
                                  interpret=True),
        mesh=mesh, in_specs=(P(None, None, "px"), P(None, None, "px"),
                             P(None, None, None, "px")),
        out_specs=P(None, None, "px"), check_vma=False)
    want = np.asarray(f(jnp.asarray(p), jnp.asarray(b),
                        block_extended(jnp.asarray(cA), 1, npx)))
    np.testing.assert_allclose(np_k7(p, b, cA, real_matrix, npx), want,
                               rtol=0, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("ny,nx", [(7, 2), (33, 70), (16, 32), (40, 256)])
def test_block_order_puts_the_seams_first(ny, nx):
    """Every block once; the first and last tile columns (the seams) come
    first, row by row, then the interior columns."""
    tj, ti = k7.TILE
    nby, nbx = -(-ny // tj), -(-nx // ti)
    order = k7.block_order(ny, nx)
    assert sorted(order) == [(j, i) for j in range(nby) for i in range(nbx)]
    edge = 2 * nby if nbx > 1 else nby
    assert all(i in (0, nbx - 1) for _, i in order[:edge])
    assert all(0 < i < nbx - 1 for _, i in order[edge:])
    assert [j for j, _ in order[:edge]] == sorted(j for j, _ in order[:edge])


def test_design_bytes_counts_the_halo():
    """design_bytes: per block and plane the band windows (3-5 a row
    taller, 6-8 a column wider), the state window with its halo, b and r;
    the two plane-0 band values a point with 'real'."""
    tj, ti = k7.TILE
    nz, ny, nx = 3, tj, ti          # one block
    d = k7.design_bytes(nz, ny, nx, itemsize=8, real=False)
    assert d == {"bands": 8 * nz * (2 * tj * ti + 3 * (tj + 1) * ti
                                    + 3 * tj * (ti + 1)),
                 "state": 8 * nz * (tj + 2) * (ti + 2),
                 "b": 8 * nz * tj * ti, "r": 8 * nz * tj * ti}
    assert k7.design_bytes(nz, ny, nx, real=True)["bands"] == \
        d["bands"] // 2 + 4 * 2 * ny * nx
    # a ragged tile: 2 rows x 3 columns in one block
    assert k7.design_bytes(1, 2, 3, real=False)["state"] == 4 * 4 * 5
