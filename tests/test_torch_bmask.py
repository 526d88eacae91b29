"""Land masking (``bmask``) in the port == JAX in float64, on the CPU.

- ``extend_rmask``, the masked band assembly (``assemble_bands``) against
  JAX's and against the numpy transliteration of the reference
  (tests/test_assembly_pin.py), every level of a masked seamount
  hierarchy, the masked RHS and projection;
- the masked seamount 16^3 solve of tests/test_bmask.py (a western land
  strip and an island): its history against JAX's, land decoupled from
  water in the operator, nondivergent water, land RHS blind to u and v;
- the same solve on a 2 x 2 mesh of CPU tiles against the single-device
  solve;
- perf mode on the masked operator: the row-sum-consistent pivots of the
  bfloat16 operator against JAX's on every column, land and ring columns
  included, and the perf-mode solve with K4's plain version against
  JAX's K4 in interpret mode.

Inputs are numpy arrays from a seed.  Tolerance 1e-12 x max|JAX| unless
a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_erosion

from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.assembly import assemble_bands as jassemble
from mgroms_tpu.assembly import build_operators as jbuild
from mgroms_tpu.bc import extend_h1 as jext
from mgroms_tpu.bc import extend_rmask as jextend_rmask
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.levels import build_level_plan
from mgroms_tpu.ops.projection import correct_uvw as jcorrect
from mgroms_tpu.ops.rhs import compute_rhs as jrhs
import mgroms_tpu.ops.pallas.sweep_fused as jsf
import mgroms_tpu.ops.relax_compact as jrc
from mgroms_tpu_torch import NHModel, SolverConfig
from mgroms_tpu_torch.assembly import assemble_bands, build_operators
from mgroms_tpu_torch.bc import extend_h1, extend_rmask
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops import relax_compact as trc
from mgroms_tpu_torch.ops.projection import correct_uvw
from mgroms_tpu_torch.ops.rhs import compute_rhs
from mgroms_tpu_torch.ops.stencil import residual
from test_assembly_pin import _grids, _np_define_matrix

torch.set_num_threads(1)

N = 16


def close(got, want, tol=1e-12):
    want = np.asarray(want, dtype=np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, dtype=np.float64))
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def land_mask(ny, nx):
    """tests/test_bmask.py's mask: the western two columns and a 2 x 2
    island mid-domain are land."""
    rmask = np.ones((ny, nx))
    rmask[:, :2] = 0.0
    rmask[ny // 2: ny // 2 + 2, nx // 2: nx // 2 + 2] = 0.0
    return rmask


def _models(**kw):
    """The masked seamount 16^3 model in both packages."""
    c = setup_seamount(N, N, N)
    rmask = land_mask(N, N)
    jm = JModel(N, N, N, cfg=JConfig(bmask=True, **kw))
    jm.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=jnp.asarray(rmask),
                    hc=c.hc, theta_b=c.theta_b, theta_s=c.theta_s)
    m = NHModel(N, N, N, cfg=SolverConfig(bmask=True, **kw), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=rmask, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    return jm, m, rmask


@pytest.fixture(scope="module")
def masked():
    return _models()


@pytest.mark.parametrize("bmask", [False, True])
def test_extend_rmask_matches_jax(bmask):
    r = np.random.default_rng(3).uniform(size=(2, 5, 7)).round()
    got = extend_rmask(t(r), bmask)
    close(got, jextend_rmask(jnp.asarray(r), bmask), 0)
    if bmask:
        ring = np.ones(got.shape[-2:], bool)
        ring[1:-1, 1:-1] = False
        assert np.abs(got.numpy()[:, ring]).max() == 0.0


@pytest.mark.parametrize("nz", [2, 5])
def test_assemble_bands_bmask_matches_jax_and_fortran(nz):
    """Random grids and a random land mask with a land ring: every band
    == JAX's to 1e-12 x max, and every entry the reference writes == the
    numpy transliteration of define_matrix (its bmask cross terms and the
    pre-diagonal ring mirror) to 1e-12."""
    dx, dy, zr, zw, rmask = _grids(nz, 6, 7, seed=nz)
    op = assemble_bands(t(dx), t(dy), t(zr), t(zw), t(rmask), True)
    jop = jax.jit(jassemble, static_argnums=5)(
        *(jnp.asarray(a) for a in (dx, dy, zr, zw, rmask)), True)
    close(op.cA, jop.cA)
    close(op.umask, jop.umask, 0)
    close(op.vmask, jop.vmask, 0)
    if nz > 2:
        ref, _ = _np_define_matrix(dx, dy, zr, zw, rmask, True)
        written = ~np.isnan(ref)
        ours = op.cA.numpy()
        for n in range(8):
            np.testing.assert_allclose(ours[n][written[n]],
                                       ref[n][written[n]], rtol=1e-12,
                                       atol=1e-12, err_msg=f"band {n + 1}")


def test_masked_hierarchy_rhs_and_projection_match_jax():
    """build_operators with bmask on the masked seamount (every level, the
    coarse ones all water with the bmask ring), then compute_rhs and
    correct_uvw on random velocities, against JAX's."""
    c = setup_seamount(N, N, N)
    rmask = land_mask(N, N)
    levels = build_level_plan(N, N, N)
    ops, fm = build_operators(levels, t(c.dx), t(c.dy), t(c.zeta), t(c.h),
                              t(rmask), c.hc, c.theta_b, c.theta_s,
                              SolverConfig(bmask=True))
    j = lambda a: jnp.asarray(np.asarray(a, np.float64))
    jops, jfm = jax.jit(lambda *a: jbuild(levels, *a, c.hc, c.theta_b,
                                          c.theta_s, JConfig(bmask=True)))(
        j(c.dx), j(c.dy), j(c.zeta), j(c.h), j(rmask))
    for op, jop in zip(ops, jops):
        close(op.cA, jop.cA)
        close(op.umask, jop.umask, 0)
        close(op.vmask, jop.vmask, 0)
    for f in jfm._fields:
        close(getattr(fm, f), getattr(jfm, f))
    rng = np.random.default_rng(12)
    u = rng.standard_normal((N, N + 2, N + 1))
    v = rng.standard_normal((N, N + 1, N + 2))
    w = rng.standard_normal((N + 1, N + 2, N + 2))
    p = rng.standard_normal((N, N, N))
    close(compute_rhs(fm, t(u), t(v), t(w), True),
          jax.jit(jrhs, static_argnums=4)(jfm, j(u), j(v), j(w), True))
    jproj = jax.jit(lambda m, p, u, v, w: jcorrect(m, jext(p), u, v, w))
    for got, want in zip(correct_uvw(fm, extend_h1(t(p)), t(u), t(v), t(w)),
                         jproj(jfm, j(p), j(u), j(v), j(w))):
        close(got, want)


def test_masked_solve_matches_jax(masked):
    """The 16^3 masked solve of tests/test_bmask.py: history == JAX's at
    rel 1e-10 (atol 1e-15, the other history tests' floor), pressure and
    corrected velocities to 1e-10 x max, and the same properties."""
    jm, m, rmask = masked
    *juvw, jp, jinfo = jm.solve(*jvel(N, N, N, dtype=jnp.float64), tol=1e-9,
                                maxiter=30)
    u, v, w = initial_velocities(N, N, N, device="cpu")
    uc, vc, wc, p, info = m.solve(u, v, w, tol=1e-9, maxiter=30)
    assert info.res <= 1e-9 and info.niter == jinfo.niter
    np.testing.assert_allclose(info.history, jinfo.history, rtol=1e-10,
                               atol=1e-15)
    close(p, jp, 1e-10)
    for got, want in zip((uc, vc, wc), juvw):
        close(got, want, 1e-10)
    # nondivergent water, 2 cells off the walls and off the land's ring
    div = m.rhs(uc, vc, wc).numpy()
    b0 = m.rhs(u, v, w).numpy()
    water = rmask > 0.5
    interior = np.zeros_like(water)
    interior[3:-3, 3:-3] = True
    wat_int = binary_erosion(water, iterations=2) & interior
    assert np.abs(div[:, wat_int]).max() <= 1e-8 * np.abs(b0).max()


def test_masked_operator_decouples_land(masked):
    """A p on water is unchanged when land values change, and the RHS on
    land columns off the coast does not see u and v (tests/test_bmask.py;
    its own mask has no such column, so this part takes a wider one)."""
    _, m, rmask = masked
    cA = m.backend.ops[0].cA
    rng = np.random.default_rng(0)
    shp = (N, N, N)
    p = t(rng.standard_normal(shp))
    land3 = t((1.0 - rmask)[None])
    p2 = p + 7.5 * land3 * t(rng.standard_normal(shp))
    zero = torch.zeros(shp, dtype=torch.float64)
    Ap1 = -residual(extend_h1(p), zero, cA, True)
    Ap2 = -residual(extend_h1(p2), zero, cA, True)
    water3 = np.broadcast_to(rmask[None], shp) > 0.5
    np.testing.assert_allclose(Ap1.numpy()[water3], Ap2.numpy()[water3],
                               rtol=0, atol=1e-11)
    # the RHS part on a wider mask (4 land columns, a 4 x 4 island), whose
    # land has columns off the coast
    wide = np.ones((N, N))
    wide[:, :4] = 0.0
    wide[6:10, 6:10] = 0.0
    c = setup_seamount(N, N, N)
    m = NHModel(N, N, N, cfg=SolverConfig(bmask=True), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=wide, hc=c.hc,
                   theta_b=c.theta_b, theta_s=c.theta_s)
    u, v, w = initial_velocities(N, N, N, device="cpu")
    b1 = m.rhs(u, v, w).numpy()
    b2 = m.rhs(u + t(rng.standard_normal(u.shape)),
               v + t(rng.standard_normal(v.shape)), w).numpy()
    land_int = binary_erosion(wide < 0.5)
    assert land_int.sum() >= N
    np.testing.assert_allclose(b1[:, land_int], b2[:, land_int], rtol=0,
                               atol=1e-9)


def test_masked_solve_on_a_2x2_mesh_matches_single_device(masked):
    """The masked solve distributed over a 2 x 2 mesh of CPU tiles (the
    ring at the physical edges only, never at the seams) == the
    single-device solve: history at rel 1e-9, pressure to 1e-9 x max."""
    _, m, _ = masked
    u, v, w = initial_velocities(N, N, N, device="cpu")
    *_, p1, info1 = m.solve(u, v, w, tol=0.0, maxiter=3)
    c = setup_seamount(N, N, N)
    md = NHModel(N, N, N, cfg=SolverConfig(bmask=True), device="cpu")
    md.set_matrices(c.dx, c.dy, c.zeta, c.h, rmask=land_mask(N, N),
                    hc=c.hc, theta_b=c.theta_b, theta_s=c.theta_s)
    md.distribute(2, 2, devices=["cpu"] * 4, comm="shard_map")
    assert md.backend.plan.shards[0].sharded
    *_, p2, info2 = md.solve(u, v, w, tol=0.0, maxiter=3)
    np.testing.assert_allclose(info2.history, info1.history, rtol=1e-9,
                               atol=1e-15)
    close(p2, p1.numpy(), 1e-9)


def test_masked_consistent_pivots_match_jax():
    """The bfloat16 operator's row-sum-consistent pivots on the masked
    level-0 operator (float32) == JAX's to rtol 1e-6 on every column, the
    land columns (no horizontal coupling) and the ring columns beside the
    coast included; the rounded operator keeps A's row sums there."""
    c = setup_seamount(N, N, N)
    levels = build_level_plan(N, N, N)
    ops, _ = build_operators(levels, t(c.dx), t(c.dy), t(c.zeta), t(c.h),
                             t(land_mask(N, N)), c.hc, c.theta_b, c.theta_s,
                             SolverConfig(bmask=True))
    cA = ops[0].cA.float()
    tp = trc.attach_lp(trc.build_compact_pack(cA, True))
    jp = jrc.attach_lp(jrc.build_compact_pack(jnp.asarray(cA.numpy()), True))
    jbet2, _ = jsf.consistent_pivots(jp, jnp.bfloat16)
    for m_, (a, b) in enumerate(trc._TKEYS):
        np.testing.assert_allclose(tp.lp.bet[m_].numpy(),
                                   np.asarray(jp.lp[2][m_]), rtol=1e-6)
        np.testing.assert_allclose(tp.lp.bet[m_].numpy(),
                                   np.asarray(jbet2[m_]), rtol=1e-6)
        nz, H, W = tp.d[m_].shape
        ones = {k: torch.ones((nz, H + 2, W + 2)) for k in trc._TKEYS}
        g = trc.gather_blocks(ones, trc.block_views(tp, m_), a, b, True)
        g_lp = trc.gather_blocks(
            ones, tuple(x.float() for x in trc.block_views(tp, m_, lp=True)),
            a, b, True)
        np.testing.assert_allclose((1.0 / tp.lp.bet[m_][0] + g_lp[0]).numpy(),
                                   (tp.d[m_][0] + g[0]).numpy(), rtol=2e-6,
                                   atol=2e-6)


def test_masked_perf_mode_matches_jax_interpret():
    """Perf mode (float32, bfloat16 smoother operator, V(1,1)) on the
    masked seamount with pallas_interpret=True: the port's K4 plain
    version against JAX's K4 in interpret mode.  The first cycle within
    rel 1e-3 of JAX's, both solves <= 1e-4, cycle counts within one (the
    limits of tests/test_torch_sweep_fused.py's perf-mode test)."""
    kw = dict(dtype="float32", fused_bands_bf16=True, ns_pre=1, ns_post=1,
              pallas_interpret=True)
    jm, m, _ = _models(**kw)
    assert any(pk is not None and pk.lp is not None and pk.ebands is not None
               for pk in m.backend.packs)
    jinfo = jm.solve(*jvel(N, N, N, dtype=jnp.float32), tol=1e-4,
                     maxiter=12)[-1]
    u, v, w = initial_velocities(N, N, N, dtype=torch.float32, device="cpu")
    info = m.solve(u, v, w, tol=1e-4, maxiter=12)[-1]
    assert abs(info.history[1] / jinfo.history[1] - 1) <= 1e-3
    assert info.res <= 1e-4 and jinfo.res <= 1e-4
    assert abs(info.niter - jinfo.niter) <= 1
