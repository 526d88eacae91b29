"""Set-up path == JAX in float64: s-coordinates, every level's operator,
the fine metrics, the divergence RHS and the velocity projection, on the
seamount case at 16^3 and the synthetic CUC slope at 32^2 x 8.

Both packages get the same numpy inputs.  Tolerance: 1e-12 x max|JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.assembly import build_operators as jbuild
from mgroms_tpu.bc import extend_h1 as jext
from mgroms_tpu.cases.cuc import setup_cuc_synthetic as jcuc
from mgroms_tpu.cases.seamount import setup_seamount as jseamount
from mgroms_tpu.grids import setup_zr_zw_croco as jzrzw
from mgroms_tpu.levels import build_level_plan
from mgroms_tpu.ops.projection import correct_uvw as jcorrect
from mgroms_tpu.ops.rhs import compute_rhs as jrhs
from mgroms_tpu_torch import SolverConfig as TConfig
from mgroms_tpu_torch.assembly import build_operators as tbuild
from mgroms_tpu_torch.bc import extend_h1 as text
from mgroms_tpu_torch.cases.cuc import setup_cuc_synthetic as tcuc
from mgroms_tpu_torch.cases.seamount import setup_seamount as tseamount
from mgroms_tpu_torch.grids import setup_zr_zw_croco as tzrzw
from mgroms_tpu_torch.ops.projection import correct_uvw as tcorrect
from mgroms_tpu_torch.ops.rhs import compute_rhs as trhs

torch.set_num_threads(1)


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


CASES = {
    "seamount16": ((16, 16, 16), lambda: tseamount(16, 16, 16),
                   lambda: jseamount(16, 16, 16)),
    "cuc32x8": ((32, 32, 8), lambda: tcuc(32, 32, 8),
                lambda: jcuc(32, 32, 8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_setup_path_matches_jax(name):
    (nx, ny, nz), tcase, jcase = CASES[name]
    c, jc = tcase(), jcase()
    for f in ("dx", "dy", "zeta", "h"):
        close(getattr(c, f), getattr(jc, f))
    assert (c.hc, c.theta_b, c.theta_s) == (jc.hc, jc.theta_b, jc.theta_s)

    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))
    j = lambda a: jnp.asarray(np.asarray(a, dtype=np.float64))
    zr, zw = tzrzw(c.hc, c.theta_b, c.theta_s, t(c.zeta), t(c.h), nz)
    jzr, jzw = jzrzw(c.hc, c.theta_b, c.theta_s, j(c.zeta), j(c.h), nz)
    close(zr, jzr)
    close(zw, jzw)

    levels = build_level_plan(nx, ny, nz)
    ones = np.ones((ny, nx))
    tops, tm = tbuild(levels, t(c.dx), t(c.dy), t(c.zeta), t(c.h), t(ones),
                      c.hc, c.theta_b, c.theta_s, TConfig())
    jops, jm = jax.jit(lambda *a: jbuild(levels, *a, c.hc, c.theta_b,
                                         c.theta_s, JConfig()))(
        j(c.dx), j(c.dy), j(c.zeta), j(c.h), j(ones))
    assert len(tops) == len(jops)
    for top, jop in zip(tops, jops):
        close(top.cA, jop.cA)
        close(top.umask, jop.umask, 0)
        close(top.vmask, jop.vmask, 0)
    for f in jm._fields:
        close(getattr(tm, f), getattr(jm, f))

    rng = np.random.default_rng(11)
    u = rng.standard_normal((nz, ny + 2, nx + 1))
    v = rng.standard_normal((nz, ny + 1, nx + 2))
    w = rng.standard_normal((nz + 1, ny + 2, nx + 2))
    p = rng.standard_normal((nz, ny, nx))
    close(trhs(tm, t(u), t(v), t(w), False),
          jax.jit(jrhs, static_argnums=4)(jm, j(u), j(v), j(w), False))
    jproj = jax.jit(lambda m, p, u, v, w: jcorrect(m, jext(p), u, v, w))
    for got, want in zip(tcorrect(tm, text(t(p)), t(u), t(v), t(w)),
                         jproj(jm, j(p), j(u), j(v), j(w))):
        close(got, want)


@pytest.mark.parametrize("kw", [
    dict(bmask=True), dict(coarsest="direct"),
    dict(relax_method="GS", gs_exact=True), dict(tridiag="pcr")],
    ids=["bmask", "direct", "gs_exact", "pcr"])
def test_options_build_on_the_cpu(kw):
    """Every SolverConfig option the JAX package accepts builds a model in
    the port too: NHModel and set_matrices on the CPU."""
    from mgroms_tpu_torch import NHModel
    c = tseamount(16, 16, 16)
    m = NHModel(16, 16, 16, cfg=TConfig(**kw), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    assert m.backend is not None
    assert (m.ops[-1].Ainv is not None) == (kw.get("coarsest") == "direct")


def test_aggressive_assembly_raises_in_both_packages():
    """Aggressive z-coarsening: both packages build the model (its level
    plan) and refuse the assembly at set_matrices, as the reference does
    (mg_define_matrix.f90:108-112)."""
    from mgroms_tpu import NHModel as JModel
    from mgroms_tpu_torch import NHModel
    c = tseamount(16, 16, 16)
    args = (c.dx, c.dy, c.zeta, c.h)
    kw = dict(hc=c.hc, theta_b=c.theta_b, theta_s=c.theta_s)
    m = NHModel(16, 16, 16, cfg=TConfig(aggressive=True), device="cpu")
    jm = JModel(16, 16, 16, cfg=JConfig(aggressive=True))
    plan = lambda lv: [(s.nzg, s.nyg, s.nxg, s.aggressive_from_prev)
                       for s in lv]
    assert plan(m.levels) == plan(jm.levels)
    assert m.levels[1].aggressive_from_prev
    for model in (m, jm):
        with pytest.raises(NotImplementedError, match="aggressive"):
            model.set_matrices(*args, **kw)
