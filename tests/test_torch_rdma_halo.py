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
