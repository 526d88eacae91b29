"""The port's multi-device layer (mgroms_tpu_torch/parallel) against the JAX
package's, on a mesh of CPU devices driven from one process.

- the shard plan equals ``levels.build_shard_plan`` across grids and meshes;
- halo_extend, extend_quads_shard, shard_face_masks and the blocked-layout
  helpers equal JAX's (under ``jax.shard_map`` on the 8 virtual CPU
  devices) bit for bit;
- the distributed rhs / project / check_nondivergence equal JAX's to
  1e-12 x max;
- the slice as a whole: seamount 32x16x8 on a (4, 2) mesh with the
  shard_map backend gives JAX's distributed pressure and the port's
  single-device one to rtol 1e-9 (history 1e-4, the tolerances of
  tests/test_shardmap.py), and a staged-agglomeration grid the port's
  single-device pressure;
- the lock-step runner: collectives, errors, and the mesh's defaults.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mgroms_tpu.levels as jlev
import mgroms_tpu.parallel.exchange as jex
from mgroms_tpu import NHModel as JModel
from mgroms_tpu import SolverConfig as JConfig
from mgroms_tpu.cases.seamount import initial_velocities as jvel
from mgroms_tpu.parallel import make_mesh as jmesh
from mgroms_tpu.parallel import physics as jphys
from mgroms_tpu_torch import NHModel, SolverConfig, solver
from mgroms_tpu_torch import levels as tlev
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.ops.relax_compact import relax_compact, split_quads
from mgroms_tpu_torch.parallel import exchange as tex
from mgroms_tpu_torch.parallel import mesh as tmesh
from mgroms_tpu_torch.parallel import physics as tphys
from mgroms_tpu_torch.parallel.shardmap_backend import ShardMapBackend

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
SPEC3 = P(None, "py", "px")


def t(a):
    return torch.tensor(np.asarray(a))


def tiles(x, npx, npy, extra=(0, 0)):
    return tmesh.split_tiles(x, (npy, npx), tmesh.make_mesh(
        npx, npy, CPU8).devices, extra)


def blocked(tl):
    return tmesh.join_tiles(tl, "cpu").numpy()


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("grid,mesh", [((32, 32, 32), (4, 2)),
                                       ((64, 64, 16), (2, 4)),
                                       ((32, 16, 8), (4, 2)),
                                       ((1024, 1024, 64), (2, 2)),
                                       ((48, 24, 8), (3, 1)),
                                       ((16, 16, 16), (1, 1))])
@pytest.mark.parametrize("nsmall", [4, 8])
def test_shard_plan_equal(grid, mesh, nsmall):
    npx, npy = mesh
    j = jlev.build_shard_plan(jlev.build_level_plan(*grid), npx, npy, nsmall)
    tl = tlev.build_level_plan(*grid)
    got = tlev.build_shard_plan(tl, npx, npy, nsmall)
    assert ([dataclasses.asdict(x) for x in got]
            == [dataclasses.asdict(x) for x in j])
    assert tlev.describe(tl, got) == jlev.describe(
        jlev.build_level_plan(*grid), j)


# ------------------------------------------------------------ exchange

def test_halo_extend_equals_jax():
    """Seam and physical-edge halos of every tile (the blocked output)."""
    nz, ny, nx = 3, 8, 16
    x = np.random.default_rng(0).standard_normal((nz, ny, nx))
    f = jax.jit(jax.shard_map(jex.halo_extend, mesh=jmesh(4, 2),
                              in_specs=(SPEC3,), out_specs=SPEC3))
    want = np.asarray(f(jnp.asarray(x)))
    mesh = tmesh.make_mesh(4, 2, CPU8)
    got = tmesh.shard_map(tex.halo_extend, mesh)(tiles(t(x), 4, 2))
    np.testing.assert_array_equal(blocked(got), want)


@pytest.mark.parametrize("mesh", [(4, 2), (2, 2)])
def test_extend_quads_shard_equals_jax(mesh):
    npx, npy = mesh
    nz, ny, nx = 4, 4 * npy, 4 * npx
    x = np.random.default_rng(1).standard_normal((nz, ny, nx))
    local = lambda p_l: jex.extend_quads_shard(
        {k: v for k, v in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                              (p_l[:, a::2, b::2] for a in (0, 1)
                               for b in (0, 1)))})
    f = jax.jit(jax.shard_map(local, mesh=jmesh(npx, npy),
                              in_specs=(SPEC3,), out_specs=SPEC3))
    want = {k: np.asarray(v) for k, v in f(jnp.asarray(x)).items()}
    tm = tmesh.make_mesh(npx, npy, CPU8)
    got = tmesh.shard_map(lambda p_l: tex.extend_quads_shard(
        split_quads(p_l)), tm)(tiles(t(x), npx, npy))
    for k in want:
        np.testing.assert_array_equal(blocked(got.map(lambda e: e[k])),
                                      want[k])


def test_compact_color_update_with_seam_exchange_matches_single():
    """One compact sweep per tile with the seam exchange equals the
    single-tile sweep (tests/test_shardmap.py:207 in the port)."""
    nz, ny, nx = 5, 16, 32
    rng = np.random.default_rng(5)
    cA = t(0.2 * rng.random((8, nz, ny + 2, nx + 2)) - 0.1)
    cA[0] -= 4.0
    p, b = (t(rng.standard_normal((nz, ny, nx))) for _ in range(2))
    want = relax_compact(p, b, cA, 1, "RB", True)
    mesh = tmesh.make_mesh(4, 2, CPU8)
    got = tmesh.shard_map(
        lambda p_l, b_l, c_l: relax_compact(p_l, b_l, c_l, 1, "RB", True,
                                            extend_fn=tex.extend_quads_shard),
        mesh)(tiles(p, 4, 2), tiles(b, 4, 2), tiles(cA, 4, 2, (2, 2)))
    np.testing.assert_allclose(blocked(got), want.numpy(), rtol=1e-12,
                               atol=1e-13)


def test_shard_face_masks_equal_jax():
    ny_l, nx_l = 4, 4

    def local():
        um, vm = jex.shard_face_masks(ny_l, nx_l, jnp.float64)
        return um[None], vm[None]

    f = jax.jit(jax.shard_map(local, mesh=jmesh(4, 2), in_specs=(),
                              out_specs=(SPEC3, SPEC3)))
    want = [np.asarray(w) for w in f()]
    got = tmesh.shard_map(
        lambda: tuple(m[None] for m in tex.shard_face_masks(
            ny_l, nx_l, torch.float64)), tmesh.make_mesh(4, 2, CPU8))()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(blocked(g), w)


@pytest.mark.parametrize("extra", [(2, 1), (1, 2), (2, 2), (0, 0)])
def test_blocked_layout_helpers_equal_jax(extra):
    npy, npx = 2, 4
    a = np.random.default_rng(2).standard_normal((3, 8 + extra[0],
                                                  16 + extra[1]))
    want = np.asarray(jex.block_overlapped(jnp.asarray(a), npy, npx, *extra))
    got = tex.block_overlapped(t(a), npy, npx, *extra)
    np.testing.assert_array_equal(got.numpy(), want)
    # the tiles of split_tiles are the blocks
    np.testing.assert_array_equal(blocked(tiles(t(a), npx, npy, extra)),
                                  want)
    np.testing.assert_array_equal(
        tex.unblock_overlapped(got, npy, npx, *extra).numpy(),
        np.asarray(jex.unblock_overlapped(jnp.asarray(want), npy, npx,
                                          *extra)))
    if extra == (2, 2):
        np.testing.assert_array_equal(
            tex.block_extended(t(a), npy, npx).numpy(),
            np.asarray(jex.block_extended(jnp.asarray(a), npy, npx)))


def test_velocity_blocking_round_trips():
    npy, npx, nz, ny, nx = 2, 4, 3, 8, 16
    rng = np.random.default_rng(3)
    u, v, w = (t(rng.standard_normal(s)) for s in
               ((nz, ny + 2, nx + 1), (nz, ny + 1, nx + 2),
                (nz + 1, ny + 2, nx + 2)))
    bl = tphys.block_velocities(u, v, w, npy, npx)
    jb = jphys.block_velocities(*(jnp.asarray(x.numpy()) for x in (u, v, w)),
                                npy, npx)
    for a, b_ in zip(bl, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    for a, b_ in zip(tphys.unblock_velocities(*bl, npy, npx), (u, v, w)):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())


# ------------------------------------------------------------- physics

def _port_model(nx, ny, nz, mesh, cfg=None):
    c = setup_seamount(nx, ny, nz)
    m = NHModel(nx, ny, nz, cfg=SolverConfig(**(cfg or {})), device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    m.distribute(*mesh, devices=CPU8, comm="shard_map")
    return m


def _models(nx, ny, nz, mesh, cfg=None):
    c = setup_seamount(nx, ny, nz)
    j = JModel(nx, ny, nz, cfg=JConfig(**(cfg or {})))
    j.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    j.distribute(*mesh, comm="shard_map")
    return j, _port_model(nx, ny, nz, mesh, cfg)


def _band_tiles(monkeypatch, m_fn):
    """A port model built by ``m_fn`` with every quad level and tile
    holding the band stack only (the card's rule, forced here through
    solver.band_stack_wanted); its per-tile packs are checked."""
    monkeypatch.setattr(solver, "band_stack_wanted", lambda cfg, on_card: True)
    m = m_fn()
    tiles = [tl for pk in m.backend.packs if pk is not None
             for tl in (pk.flat() if isinstance(pk, tmesh.Tiles) else (pk,))]
    assert any(isinstance(pk, tmesh.Tiles) for pk in m.backend.packs)
    assert tiles and all(tl.blocks is None and tl.ebands is not None
                         for tl in tiles)
    return m


@pytest.fixture(scope="module")
def models_4x2():
    """Seamount 32x16x8 (default config: compact) distributed over the
    (4, 2) mesh, by JAX and by the port."""
    return _models(32, 16, 8, (4, 2))


def test_distributed_physics_matches_jax(models_4x2):
    nx, ny, nz = 32, 16, 8
    j, m = models_4x2
    rng = np.random.default_rng(11)
    u, v, w = (np.asarray(x) + rng.standard_normal(x.shape)
               for x in jvel(nx, ny, nz))
    p = rng.standard_normal((nz, ny, nx))
    close = lambda got, want: np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0,
        atol=1e-12 * np.abs(np.asarray(want)).max())
    close(m.rhs(u, v, w), j.rhs(u, v, w))
    for got, want in zip(m.project(p, u, v, w), j.project(p, u, v, w)):
        close(got, want)
    close(m.check_nondivergence(u, v, w), j.check_nondivergence(u, v, w))
    assert isinstance(m.backend, ShardMapBackend)
    assert m.backend.ops[0].cA.shape == (2, 4)


# ------------------------------------------------------ the whole slice

@pytest.fixture(scope="module")
def seamount_4x2(models_4x2):
    """Seamount 32x16x8, compact, 4 F-cycles: JAX distributed (shard_map
    on the (4, 2) mesh), the port distributed and single-device."""
    nx, ny, nz = 32, 16, 8
    j, m = models_4x2
    u, v, w = jvel(nx, ny, nz)
    pj, ij = j.pressure_solve(j.rhs(u, v, w), tol=1e-10, maxiter=4)
    ut, vt, wt = initial_velocities(nx, ny, nz, device="cpu")
    pt, it = m.pressure_solve(m.rhs(ut, vt, wt), tol=1e-10, maxiter=4)
    s = NHModel(nx, ny, nz, device="cpu")
    c = setup_seamount(nx, ny, nz)
    s.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    ps, is_ = s.pressure_solve(s.rhs(ut, vt, wt), tol=1e-10, maxiter=4)
    return dict(jax=(np.asarray(pj), ij), port=(pt.numpy(), it),
                single=(ps.numpy(), is_), model=m)


@pytest.mark.parametrize("other", ["jax", "single", "band tiles"])
def test_distributed_solve_matches(monkeypatch, seamount_4x2, other):
    """The port's distributed solve against JAX's and the port's
    single-device one; and, with the band stack on every tile (the card's
    rule), JAX's and bit for bit the gather-block tiles' history."""
    p, info = seamount_4x2["port"]
    if other == "band tiles":
        m = _band_tiles(monkeypatch, lambda: _port_model(32, 16, 8, (4, 2)))
        ut, vt, wt = initial_velocities(32, 16, 8, device="cpu")
        pb, ib = m.pressure_solve(m.rhs(ut, vt, wt), tol=1e-10, maxiter=4)
        assert ib.history == info.history and torch.equal(pb, t(p))
        p, info = pb.numpy(), ib
        other = "jax"
    p_ref, i_ref = seamount_4x2[other]
    assert info.niter == i_ref.niter == 4
    assert info.history[-1] < 1e-2 * info.history[0]
    np.testing.assert_allclose(p, p_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(p_ref).max())
    np.testing.assert_allclose(info.history, i_ref.history, rtol=1e-4,
                               atol=1e-15)


def test_distributed_routing(seamount_4x2):
    """Level 0 sharded on both axes in quads with per-tile packs; the
    coarser levels replicated (the JAX plan), K4 never on a sharded
    level."""
    be = seamount_4x2["model"].backend
    assert [s.sharded for s in be.plan.shards] == [True, False, False]
    assert be.state_quads(0) and be.packs[0].shape == (2, 4)
    assert be.supports_fused_residual(0) and not be._use_sweep(0)
    assert not be.supports_fused_rr(0)      # level 1 is replicated
    assert be.state_quads(1) and not isinstance(be.packs[1], tmesh.Tiles)


@pytest.fixture(scope="module")
def fc_jax_4x2():
    """JAX's distributed FC solve of seamount 32x16x8 on (4, 2), 2
    F-cycles: (pressure, SolveInfo)."""
    nx, ny, nz = 32, 16, 8
    c = setup_seamount(nx, ny, nz)
    j = JModel(nx, ny, nz, cfg=JConfig(relax_method="FC"))
    j.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    j.distribute(4, 2, comm="shard_map")
    return j.pressure_solve(j.rhs(*jvel(nx, ny, nz)), tol=1e-10, maxiter=2)


@pytest.mark.parametrize("layout", ["blocks", "bands"])
def test_distributed_fc_solve_matches_jax(monkeypatch, fc_jax_4x2, layout):
    """The four-colour ordering through the tiles: K1's FC orchestration
    per tile with the seam exchange before each colour, seamount 32x16x8
    on (4, 2), 2 F-cycles: JAX's distributed pressure to rtol 1e-9, with
    the tiles holding the gather blocks or the band stack."""
    nx, ny, nz = 32, 16, 8
    build = lambda: _port_model(nx, ny, nz, (4, 2),
                                cfg=dict(relax_method="FC"))
    m = _band_tiles(monkeypatch, build) if layout == "bands" else build()
    assert m.backend.state_quads(0) and m.backend._use_compact_shard(0)
    pj, ij = fc_jax_4x2
    u, v, w = initial_velocities(nx, ny, nz, device="cpu")
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=1e-10, maxiter=2)
    pj = np.asarray(pj)
    np.testing.assert_allclose(p.numpy(), pj, rtol=1e-9,
                               atol=1e-9 * np.abs(pj).max())
    np.testing.assert_allclose(info.history, ij.history, rtol=1e-9,
                               atol=1e-15)


def test_distributed_gs_solve_matches_single():
    """GS has no quad form: comm='auto' resolves to the GSPMD layer, and
    comm='shard_map' runs the masked column-Jacobi relax per tile with the
    tile's origin, as the GSPMD layer's tiles do; 3 F-cycles on (4, 2)
    of either equal the port's single-device GS solve."""
    from mgroms_tpu_torch.parallel import DistributedBackend
    nx, ny, nz = 32, 16, 8
    c = setup_seamount(nx, ny, nz)
    out = []
    for comm in (None, "auto", "shard_map"):
        m = NHModel(nx, ny, nz, cfg=SolverConfig(relax_method="GS"),
                    device="cpu")
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                       theta_s=c.theta_s)
        if comm:
            m.distribute(4, 2, devices=CPU8, comm=comm)
            assert type(m.backend) is (DistributedBackend if comm == "auto"
                                       else ShardMapBackend)
            assert not any(m.backend.state_quads(lev)
                           for lev in range(m.backend.nlevs))
        u, v, w = initial_velocities(nx, ny, nz, device="cpu")
        out.append(m.pressure_solve(m.rhs(u, v, w), tol=1e-12, maxiter=3))
    p1, i1 = out[0]
    for p2, i2 in out[1:]:
        np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=0,
                                   atol=1e-12 * float(p1.abs().max()))
        np.testing.assert_allclose(i2.history, i1.history, rtol=1e-12)


def test_staged_agglomeration_solve_matches_single():
    """64x64x16 on a (2, 4) mesh stages both axes -> both -> one ->
    replicated (tests/test_distributed.py:80); one F-cycle against the
    port's single-device solve."""
    nx, ny, nz = 64, 64, 16
    c = setup_seamount(nx, ny, nz)
    out = []
    for mesh in (None, (2, 4)):
        m = NHModel(nx, ny, nz, device="cpu")
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        if mesh:
            m.distribute(*mesh, devices=CPU8)
            flags = [(s.shard_py, s.shard_px) for s in m.backend.plan.shards]
            assert flags[0] == (True, True)
            assert flags[2] in ((False, True), (True, False))
            assert not m.backend.plan.shards[3].sharded
        u, v, w = initial_velocities(nx, ny, nz, device="cpu")
        out.append(m.pressure_solve(m.rhs(u, v, w), tol=1e-12, maxiter=1))
    (p1, i1), (p2, i2) = out
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=1e-9,
                               atol=1e-9 * float(p1.abs().max()))
    np.testing.assert_allclose(i2.history, i1.history, rtol=1e-4)


# -------------------------------------------------- mesh and the runner

def test_make_mesh_raises_without_enough_devices():
    with pytest.raises(ValueError, match="need 8 devices"):
        tmesh.make_mesh(4, 2, ["cpu"] * 7)
    with pytest.raises(ValueError, match="one kind"):
        tmesh.Mesh([["cpu", "meta"]])
    mesh = tmesh.make_mesh(2, 2, CPU8)
    assert mesh.shape == (2, 2) and not mesh.on_card


def test_collectives_and_errors():
    mesh = tmesh.make_mesh(4, 2, CPU8)
    x = tiles(torch.arange(8.0).reshape(1, 2, 4), 4, 2)
    s = tmesh.shard_map(lambda a: tex.psum2(a.sum()), mesh)(x)
    assert all(float(v) == 28.0 for v in s.flat())
    idx = tmesh.shard_map(lambda: (tmesh.axis_index("py"),
                                   tmesh.axis_index("px")), mesh)()
    assert idx[0].grid == ((0,) * 4, (1,) * 4)
    assert idx[1].grid == ((0, 1, 2, 3),) * 2

    def bad(a):
        if tmesh.axis_index("px") == 2:
            raise KeyError("tile fault")
        return tex.halo_extend(a)

    with pytest.raises(KeyError, match="tile fault"):
        tmesh.shard_map(bad, mesh)(x)

    def early(a):
        if tmesh.axis_index("px") == 0:
            return a
        return tex.halo_extend(a)

    with pytest.raises(RuntimeError, match="lock step"):
        tmesh.shard_map(early, mesh)(x)
    with pytest.raises(RuntimeError, match="inside shard_map"):
        tex.halo_extend(torch.zeros(1, 2, 2))


@pytest.mark.parametrize("grid", [(64, 64, 64), (1024, 1024, 64)])
@pytest.mark.parametrize("kind", ["RB", "FC", "GS"])
def test_compact_gate_on_tiles_is_the_single_device_rule(grid, kind):
    """The sharded compact gate is the single-device rule applied to the
    tile, on a mesh of the card as on the CPU: on seamount 64^3 and CUC
    1024^2 x 64 cut 2x2 it agrees with solver.compact_eligible on every
    level, and comm='auto' resolves to shard_map wherever a level is
    compact (the card's former width gate left seamount 64^3 on 2x2 with
    none)."""
    from mgroms_tpu_torch.parallel.shardmap_backend import (
        compact_shard_eligible, default_comm)
    from mgroms_tpu_torch.solver import compact_eligible
    cfg = SolverConfig(relax_method=kind)
    levels = tlev.build_level_plan(*grid)
    plan = tmesh.MeshPlan.create(tmesh.make_mesh(2, 2, ["cuda:0"] * 4),
                                 levels)
    assert plan.mesh.on_card
    for spec, sh in zip(levels, plan.shards):
        assert compact_shard_eligible(spec, sh, cfg) \
            == compact_eligible(spec, cfg)
    assert default_comm(levels, plan, cfg) == \
        ("gspmd" if kind == "GS" else "shard_map")


def test_gspmd_and_unknown_comm_raise():
    """'gspmd', and 'auto' (which resolves to it with compact=False),
    build the GSPMD backend; an unknown layer raises."""
    from mgroms_tpu_torch.parallel import DistributedBackend
    c = setup_seamount(16, 16, 16)
    for comm in ("gspmd", "auto"):
        m = NHModel(16, 16, 16, cfg=SolverConfig(compact=False),
                    device="cpu")
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                       theta_s=c.theta_s)
        m.distribute(2, 2, devices=CPU8, comm=comm)
        assert type(m.backend) is DistributedBackend
    with pytest.raises(ValueError, match="unknown comm"):
        m.distribute(2, 2, devices=CPU8, comm="mpi")


def test_jax_blocked_state_carries_over(models_4x2):
    """JAX's blocked level-0 cA and per-shard packs, as numpy, become the
    port's tiles (convert.tiles_from_numpy / pack_tiles_from_numpy): they
    equal the port's own to 1e-12, and a distributed solve on them gives
    JAX's distributed pressure."""
    from mgroms_tpu_torch.convert import (pack_tiles_from_numpy,
                                          tiles_from_numpy)
    j, _ = models_4x2
    nx, ny, nz = 32, 16, 8
    c = setup_seamount(nx, ny, nz)
    m = NHModel(nx, ny, nz, device="cpu")
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    m.distribute(4, 2, devices=CPU8)
    be = m.backend
    cA = tiles_from_numpy(np.asarray(j.backend.ops[0].cA), (2, 4),
                          device="cpu")
    jp = j.backend.packs[0]
    pk = pack_tiles_from_numpy(
        {f: [np.asarray(x) for x in getattr(jp, f)]
         for f in ("blocks", "d", "ud", "bet", "rblocks")}, (2, 4),
        jp.real_matrix, device="cpu")
    for a, b_ in zip(cA.flat(), be.ops[0].cA.flat()):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0,
                                   atol=1e-12 * float(b_.abs().max()))
    for a, b_ in zip(pk.flat(), be.packs[0].flat()):
        for x, y in zip(a.blocks + a.bet, b_.blocks + b_.bet):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(y.abs().max()))
    be.ops[0] = be.ops[0]._replace(cA=cA)
    be.packs[0] = pk
    u, v, w = initial_velocities(nx, ny, nz, device="cpu")
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=1e-10, maxiter=2)
    pj, ij = j.pressure_solve(j.rhs(*jvel(nx, ny, nz)), tol=1e-10,
                              maxiter=2)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(pj)).max())
