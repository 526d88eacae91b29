"""The work counts of portbench/work.py and the kernel-to-class table.

At CUC level 0 (its quads (64, 512, 512), the level (64, 1024, 1024)) in
float32, PERF.md section 6 counts K4's sweep at 2.961 GB and K3's fused
residual and restriction at 2.728 GB (the bytes each kernel reads as
stored).  The benchmark counts in the reference's storage: cA's 8
coefficients a point with their halo ring, the state read and written
once, the RHS read once, and K3's coarse RHS written once.  K4's count is
the same to 4 digits; K3's is 2.726 GB, 0.1 % under PERF's, which counts
what K3 reads of its band stack and pivots (the 24 band quads with their
halos, d and ud) and the extended state quads, not the 8 coefficients.
"""

import pytest

from mgroms_tpu_torch.ops import kernels
from portbench import work

LEVEL0 = (64, 1024, 1024)
CUC = [(64 >> k, 1024 >> k, 1024 >> k) for k in range(6)]


def test_level0_bytes_against_perf_md():
    smooth = work.smooth_bytes(LEVEL0, 4)
    assert smooth == 2_961_186_816
    assert round(smooth / 1e9, 3) == 2.961
    rr = work.residual_restrict_bytes(LEVEL0, CUC[1], 4)
    assert rr == 2_726_305_792
    assert abs(rr / 2.728e9 - 1) < 1.5e-3


def test_fcycle_calls_match_the_launches_per_fcycle():
    # PERF.md section 6: CUC's default F-cycle launches K4 75 times and
    # K3 16 times (15 fused residual-restrictions and the fresh residual)
    got = work.fcycle_work(CUC, 3, 2, 4)
    assert got["smooth"][1] == 75
    assert got["residual_restrict"][1] == 15
    assert got["smooth"][0] == sum(
        (lev + 1) * 5 * work.smooth_bytes(CUC[lev], 4) for lev in range(5))


NAMES = [
    ("void sweep_kernel<float, float>(SweepArgs<float, float>)", "smooth",
     "relax_fused_sweep"),
    ("void sweep_kernel<double, double>(SweepArgs<double, double>)",
     "smooth", "relax_fused_sweep"),
    ("void rr_kernel<float, true, 0>(RRArgs<float>)", "residual_restrict",
     "residual_restrict"),
    ("void rr_kernel<float, false, 1>(RRArgs<float>)", "residual_restrict",
     "residual_restrict"),
    ("void rr_kernel<float, true, 2>(RRArgs<float>)", "residual",
     "residual_quads"),
    ("void sweep_kernel<float, __nv_bfloat16>(SweepArgs<float, "
     "__nv_bfloat16>)", None, "relax_fused_sweep_bf16"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, ...)", None, None),
]


@pytest.mark.parametrize("name,cls,key", NAMES)
def test_kernel_classes_agree_with_the_programs_counters(name, cls, key):
    table = work.kernel_classes()
    assert work.classify(name, table) == cls
    assert kernels.kernel_key(name) == key
    if cls is not None:
        assert next(k for _, c, k in table if c == cls) == key
