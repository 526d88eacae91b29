"""The level-0 kernels at the seamount scaling grid's 128-plane columns
(1024^2 x 128, quads (128, 512, 512)) on the card: 0 ulp from their plain
versions, run on the same card.

Marked ``cuda``: the tests skip without a CUDA device.  Run on a GPU with

    python -m pytest --noconftest tests/test_torch_deep_cuda.py

Cases: K4 (csrc/sweep_fused.cu) and K3 (csrc/rr_fused.cu) in its coarse
and residual modes on a random operator held as the band stack, as the
card's quad levels hold it; ``rhs_kernel`` (csrc/rhs_fused.cu) on the
seamount's own metrics at (128, 1024, 1024); the launch plan K4 records
at its first launch of a shape (``sweep_fused.PLANS``) is the plan the
launcher reports for it.  K4's staging ring: the plan keeps the threads
and resident blocks of the shallow ring and takes the deep one where that
keeps them too (7 at 128 planes, 2 where two blocks share an SM), and K4 is
0 ulp at every depth it has a kernel of, on columns whose plan lands
there.
"""

import pytest
import torch

from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops import relax_compact as rc
from mgroms_tpu_torch.ops.kernels import launches, reset_launches
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt
from mgroms_tpu_torch.ops.kernels import rhs_fused as kr
from mgroms_tpu_torch.ops.kernels import sweep_fused as ksf
from mgroms_tpu_torch.ops.rhs import compute_rhs

pytestmark = pytest.mark.cuda

N, NZ = 1024, 128
QUADS = (NZ, N // 2, N // 2)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def level0(cuda):
    """A random level-0 operator as the band stack, with state and RHS
    quads: uniform bands in [-0.1, 0.1), the diagonal lowered by 4."""
    g = torch.Generator(device=cuda).manual_seed(128)
    cA = torch.rand((8, NZ, N + 2, N + 2), generator=g, device=cuda) * 0.2
    cA -= 0.1
    cA[0] -= 4.0
    pack = rc.build_band_pack(cA, True)
    del cA
    q = rc.split_quads(torch.randn((NZ, N, N), generator=g, device=cuda))
    bq = rc.split_quads(torch.randn((NZ, N, N), generator=g, device=cuda))
    return pack, q, bq


def test_sweep_at_128_planes(level0):
    """K4 == its plain version to 0 ulp, one launch a sweep, its inputs
    untouched."""
    pack, q, bq = level0
    q0 = {k: x.clone() for k, x in q.items()}
    before = ksf.LAUNCHES["relax_fused_sweep"]
    got = ksf.relax_fused_sweep(q, bq, pack, 1)
    torch.cuda.synchronize()
    assert ksf.LAUNCHES["relax_fused_sweep"] == before + 1
    want = ksf.relax_fused_sweep_plain(q, bq, pack, 1)
    for t in rc._TKEYS:
        assert torch.equal(q[t], q0[t])
        assert torch.equal(got[t], want[t]), (
            t, float((got[t] - want[t]).abs().max()))


@pytest.mark.parametrize("mode", ["coarse", "residual"])
def test_residual_restrict_at_128_planes(level0, mode):
    """K3 in its coarse mode (the down-leg residual restricted) and its
    residual mode (the four targets' residuals) == its plain version to
    0 ulp, one launch each."""
    pack, q, bq = level0
    assert kt.rr_operator(pack) == "bands"
    e = rc.extend_quads(q)
    e4 = tuple(e[k] for k in rc._TKEYS)
    key = "residual_quads" if mode == "residual" else "residual_restrict"
    before = kt.LAUNCHES[key]
    got = kt.residual_restrict(e4, bq, pack, mode, rc._TKEYS)
    torch.cuda.synchronize()
    assert kt.LAUNCHES[key] == before + 1
    want = kt.residual_restrict_plain(e4, bq, pack, mode, rc._TKEYS)
    if mode == "coarse":
        assert got.shape == (NZ // 2, N // 2, N // 2)
        assert torch.equal(got, want)
    else:
        assert all(torch.equal(got[t], want[t]) for t in rc._TKEYS)


def test_sweep_records_its_launch_plan(level0):
    """The plan recorded at K4's first launch of the shape is the
    launcher's plan for it, and a second launch records nothing new."""
    pack, q, bq = level0
    reset_launches()
    assert ksf.PLANS == {}
    ksf.relax_fused_sweep(q, bq, pack, 2)
    torch.cuda.synchronize()
    key = (QUADS, torch.float32, torch.float32)
    assert list(ksf.PLANS) == [key]
    plan = ksf.launch_plan(QUADS, torch.float32, torch.float32)
    assert ksf.PLANS[key] == plan
    assert plan["threads"] % 32 == 0 and plan["blocks_per_sm"] >= 1
    assert plan["planes_ahead"] == 7
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 1 <= plan["grid"] <= sms * plan["blocks_per_sm"]
    reset_launches()
    assert ksf.PLANS == {}


F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
# the shallow ring, the deep one the plan takes where it keeps the blocks,
# and a depth only a caller can ask for (the deepest ring a 64-plane
# float32 column fits one block)
MIN_AHEAD, MAX_AHEAD, DEEP_AHEAD = 2, 7, 13


# (quads, state, bands, the plan's ring depth): the seamount's level 0
# (its Thomas arrays leave room for 5 more stages in its one block an SM),
# the 64- and 32-plane levels of both cells (more blocks share an SM: the
# deep ring would cost one), float32 on bfloat16 bands at 128 planes (one
# block, room) and at 64 (two blocks), float64 on bfloat16 bands at 64
# planes (one block, room for 4 stages, not 5) and float64 on float64 (one
# block, no room)
@pytest.mark.parametrize("shape,state,band,depth", [
    ((128, 512, 512), F32, F32, 7), ((64, 512, 512), F32, F32, 2),
    ((64, 256, 256), F32, F32, 2), ((32, 256, 256), F32, F32, 2),
    ((32, 128, 128), F32, F32, 2), ((128, 512, 512), F32, BF16, 7),
    ((64, 512, 512), F32, BF16, 2), ((64, 512, 512), F64, BF16, 2),
    ((64, 512, 512), F64, F64, 2)])
def test_ring_depth_keeps_the_resident_blocks(cuda, shape, state, band,
                                              depth):
    """The plan's ring depth: the threads and blocks an SM of the shallow
    ring, and the deep ring where it keeps them."""
    plan = ksf.launch_plan(shape, state, band)
    least = ksf.launch_plan(shape, state, band, MIN_AHEAD)
    assert plan["planes_ahead"] == depth
    assert (plan["threads"], plan["blocks_per_sm"], plan["grid"]) == (
        least["threads"], least["blocks_per_sm"], least["grid"])
    assert plan["smem_bytes"] >= least["smem_bytes"]
    for none in (MIN_AHEAD + 1, MAX_AHEAD - 1, MAX_AHEAD + 1):
        with pytest.raises(RuntimeError):    # a depth with no kernel
            ksf.launch_plan(shape, state, band, none)
    if depth == MIN_AHEAD:
        try:
            deep = ksf.launch_plan(shape, state, band, MAX_AHEAD)
        except RuntimeError:
            return    # the deep ring does not fit a block
        assert deep["blocks_per_sm"] < plan["blocks_per_sm"]


def _deepest_column(depth, state, band, H, W, forced):
    """The deepest column (nz up to 200) whose plan takes ring depth
    ``depth`` (``forced``: that the ring of that depth fits, asked for),
    None where none does."""
    for nz in range(200, 1, -1):
        try:
            plan = ksf.launch_plan((nz, H, W), state, band,
                                   depth if forced else 0)
        except RuntimeError:
            continue      # no block holds the column or the forced ring
        if plan["planes_ahead"] == depth:
            return nz
    return None


# (ring depth, state, bands): both depths of the plan in each type pair
# that takes both, and the depth only a caller asks for, which has a
# kernel in float32 only
RING_DEPTHS = [(a, st, bd) for a in (MIN_AHEAD, MAX_AHEAD)
               for st, bd in ((F32, F32), (F32, BF16), (F64, BF16))] + [
    (DEEP_AHEAD, F32, F32)]


@pytest.mark.parametrize("depth,state,band", RING_DEPTHS)
@pytest.mark.parametrize("real", [True, False])
def test_sweep_at_each_ring_depth(cuda, depth, state, band, real):
    """K4 == its plain version to 0 ulp on the deepest column whose plan
    lands on ``depth`` (ragged quads), two sweeps; the depth only a caller
    asks for on the deepest column it fits, asked for."""
    H, W = 9, 70
    forced = depth == DEEP_AHEAD
    nz = _deepest_column(depth, state, band, H, W, forced)
    assert nz is not None, f"no column takes ring depth {depth}"
    ahead = depth if forced else 0
    g = torch.Generator(device=cuda).manual_seed(nz + depth)
    cA = torch.rand((8, nz, 2 * H + 2, 2 * W + 2), generator=g,
                    device=cuda, dtype=F64) * 0.2 - 0.1
    cA[0] -= 4.0
    cA = cA.to(state)
    pack = rc.build_band_pack(cA, real)
    if band == BF16:
        pack = rc.attach_lp(pack)
    q, bq = (rc.split_quads(torch.randn((nz, 2 * H, 2 * W), generator=g,
                                        device=cuda, dtype=state))
             for _ in range(2))
    reset_launches()
    got = ksf.relax_fused_sweep(q, bq, pack, 2, ahead=ahead)
    want = ksf.relax_fused_sweep_plain(q, bq, pack, 2)
    torch.cuda.synchronize()
    for t in rc._TKEYS:
        assert torch.equal(got[t], want[t]), (
            nz, t, float((got[t] - want[t]).abs().max()))
    if ahead:
        assert ksf.PLANS == {}     # a forced depth records no plan
        assert ksf.launch_plan((nz, H, W), state, band,
                               ahead)["planes_ahead"] == ahead
    else:
        assert ksf.PLANS[((nz, H, W), state, band)]["planes_ahead"] == depth
    reset_launches()


def test_rhs_at_the_scaling_grid(cuda):
    """The seamount 1024^2 x 128 float32, the model's own metrics (zw the
    halo-2 view), the drivers' field and a random one: the kernel's b ==
    compute_rhs's, one launch a call."""
    m = NHModel(N, N, NZ, cfg=SolverConfig(dtype="float32",
                                           coarsest="direct"), device=cuda)
    c = setup_seamount(N, N, NZ)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    g = torch.Generator(device=cuda).manual_seed(5)
    fields = [initial_velocities(N, N, NZ, dtype=m.dtype, device=cuda),
              tuple(torch.randn(s, generator=g, device=cuda)
                    for s in ((NZ, N + 2, N + 1), (NZ, N + 1, N + 2),
                              (NZ + 1, N + 2, N + 2)))]
    for uvw in fields:
        before = launches()["rhs_fused"]
        got = kr.rhs_fused(m.metrics, *uvw, False)
        torch.cuda.synchronize()
        assert launches()["rhs_fused"] == before + 1
        want = compute_rhs(m.metrics, *uvw, False)
        assert got.shape == (NZ, N, N)
        assert torch.equal(got, want), float((got - want).abs().max())
