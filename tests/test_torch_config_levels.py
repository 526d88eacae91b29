"""The port's copies of the pure-Python pieces equal the JAX package's.

mgroms_tpu_torch cannot import mgroms_tpu (its __init__ imports jax), so it
carries copies of SolverConfig/read_namelist, the level plan and the gather
term tables; these tests hold the copies equal to the originals.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import mgroms_tpu.config as jcfg
import mgroms_tpu.levels as jlev
import mgroms_tpu.ops.relax_compact as jrc
import mgroms_tpu_torch.config as tcfg
import mgroms_tpu_torch.levels as tlev
import mgroms_tpu_torch.ops.relax_compact as trc

torch.set_num_threads(1)


def test_solver_config_fields_and_defaults_equal():
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(jcfg.SolverConfig)]
    tf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(tcfg.SolverConfig)]
    assert tf == jf
    assert tcfg._NML_KEYS == jcfg._NML_KEYS
    assert tcfg._NML_BOOL == jcfg._NML_BOOL
    for bad in (dict(relax_method="XX"), dict(cmatrix="x"),
                dict(interp_type="linear", restrict_type="linear")):
        with pytest.raises(ValueError):
            tcfg.SolverConfig(**bad)


def test_read_namelist_equal(tmp_path):
    path = tmp_path / "nh_namelist"
    path.write_text("&nhparam\n"
                    "  solver_prec = 1.d-9, ! comment\n"
                    "  solver_maxiter = 17\n"
                    "  ns_pre = 2\n"
                    "  relax_method = 'RB'\n"
                    "  cmatrix = 'simple'\n"
                    "  netcdf_output = .false.\n"
                    "/\n")
    base = dict(dtype="float32")
    j = jcfg.read_namelist(str(path), base=jcfg.SolverConfig(**base))
    t = tcfg.read_namelist(str(path), base=tcfg.SolverConfig(**base))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (dataclasses.asdict(tcfg.read_namelist(str(tmp_path / "none")))
            == dataclasses.asdict(jcfg.read_namelist(str(tmp_path / "none"))))


@pytest.mark.parametrize("grid", [(16, 16, 16), (32, 32, 32), (64, 64, 64),
                                  (1024, 1024, 64), (48, 24, 8)])
def test_level_plan_equal(grid):
    j = jlev.build_level_plan(*grid)
    t = tlev.build_level_plan(*grid)
    assert ([dataclasses.asdict(x) for x in t]
            == [dataclasses.asdict(x) for x in j])
    assert tlev.find_grid_levels(*grid) == jlev.find_grid_levels(*grid)
    assert tlev.describe(t) == jlev.describe(j)


@pytest.mark.parametrize("grid,mesh", [((1024, 1024, 64), (2, 2)),
                                       ((64, 64, 16), (2, 4))])
def test_shard_plan_copy_equal(grid, mesh):
    """ShardSpec's fields and build_shard_plan's plan (the staged axis
    drops, nsmall) equal the JAX package's."""
    jf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jlev.ShardSpec)]
    tf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(tlev.ShardSpec)]
    assert tf == jf
    for nsmall in (8, 32):
        j = jlev.build_shard_plan(jlev.build_level_plan(*grid), *mesh,
                                  nsmall=nsmall)
        t = tlev.build_shard_plan(tlev.build_level_plan(*grid), *mesh,
                                  nsmall=nsmall)
        assert ([dataclasses.asdict(x) for x in t]
                == [dataclasses.asdict(x) for x in j])


def test_gather_term_tables_equal():
    assert trc._BASE_TERMS == jrc._BASE_TERMS
    assert trc._REAL_TERMS == jrc._REAL_TERMS
    assert trc._TKEYS == jrc._TKEYS
    assert trc._RB_TARGETS == jrc._RB_TARGETS
    assert trc._FC_TARGETS == jrc._FC_TARGETS
    for real in (True, False):
        assert trc.gather_keys(real) == jrc.gather_keys(real)
    assert trc.real_only_keys() == jrc.real_only_keys()


def test_import_leaves_jax_out():
    code = ("import sys, mgroms_tpu_torch, mgroms_tpu_torch.model, "
            "mgroms_tpu_torch.convert, mgroms_tpu_torch.drivers.cuc, "
            "mgroms_tpu_torch.drivers.seamount, "
            "mgroms_tpu_torch.ops.kernels.relax_tiled, "
            "mgroms_tpu_torch.ops.kernels.sweep_packed, "
            "mgroms_tpu_torch.ops.kernels.roofline, "
            "mgroms_tpu_torch.ops.kernels.rdma_halo, "
            "mgroms_tpu_torch.ops.kernels.dma_probe, "
            "mgroms_tpu_torch.parallel, "
            "mgroms_tpu_torch.parallel.shardmap_backend, "
            "mgroms_tpu_torch.parallel.physics, "
            "mgroms_tpu_torch.scripts.micro_sweep_fused, "
            "mgroms_tpu_torch.scripts.micro_packed_parts, "
            "mgroms_tpu_torch.scripts.micro_roofline, "
            "mgroms_tpu_torch.scripts.micro_dma_probe, "
            "mgroms_tpu_torch.scripts.micro_colour_update, "
            "mgroms_tpu_torch.scripts.micro_solve, "
            "mgroms_tpu_torch.scripts.micro_relax_fused, "
            "mgroms_tpu_torch.refine, "
            "mgroms_tpu_torch.scripts.refine_solve, "
            "mgroms_tpu_torch.capture, "
            "mgroms_tpu_torch.ops.kernels.device_loop, "
            "mgroms_tpu_torch.scripts.solve_wall, "
            "mgroms_tpu_torch.scripts.loop_graph_build, "
            "mgroms_tpu_torch.io.diagnostics, "
            "mgroms_tpu_torch.utils, mgroms_tpu_torch.utils.tictoc, "
            "mgroms_tpu_torch.velocity, mgroms_tpu_torch.cases.rndtopo, "
            "mgroms_tpu_torch.cases.analytic_rhs, "
            "mgroms_tpu_torch.drivers.rndtopo, "
            "mgroms_tpu_torch.drivers.common, "
            "mgroms_tpu_torch.scripts.profile_cuc, "
            "mgroms_tpu_torch.scripts.schedule_sweep, "
            "mgroms_tpu_torch.parallel.backend, "
            "mgroms_tpu_torch.scripts.scaling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mgroms_tpu')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
