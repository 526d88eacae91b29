"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):

1. Build the CUDA kernels from mgroms_tpu_torch/csrc/ and hold each one to
   its plain torch version on the card, with the max ulp printed:
   K1 on every colour of both orderings (one launch a colour: the two
   targets of an RB colour, one of FC) and K2 on the RB colours, on the
   band stack and on the gather blocks, in float32, float64 and (K1) on
   the bfloat16 operator, to 0 ulp, at the CUC level-0 quads (timed, each
   RB colour beside the same targets as two one-target launches), its
   level-4 quads, every seamount 64^3 quad level, ragged widths (7, 33,
   70 against the 64-column tile) and nz 2 with H = W = 1; K3 (all four
   target quads a
   launch) on the band stack and on the gather blocks, in its coarse-RHS,
   residual and z-pair modes, to 0 ulp, at the CUC level-0 quads (timed),
   its level-4 quads (4, 32, 32), ragged widths, nz 2 and in float64;
   K4 (one sweep; each instance's launch plan printed: threads a block,
   blocks per SM, grid, shared memory) on float32 state with float32 and
   bfloat16 bands at the CUC level-0 quad shape (64, 512, 512), at the
   CUC level-4 quad shape (4, 32, 32) and at a ragged shape, on float64
   state with float64 bands at (64, 512, 512) (timed) and a ragged shape,
   and with bfloat16 bands (a float64 K4 level's band stack copy and
   float64 pivots) at (64, 512, 512) (timed), (4, 32, 32) and a ragged
   shape with and without 'real', its bytes counted as it reads them (the
   24 band quads, its bound on the 48 gather blocks printed beside),
   held to 0 ulp; K5 at the
   CUC level-0 shape
   (64, 1024, 1024), at a ragged shape and once in float64; K6 in each
   ordering (RB, FC, GS), to 0 ulp, in each of its three forms (forced):
   one block with 40 sweeps at the coarsest levels of CUC (2, 32, 32) and
   seamount (4, 4, 4), at a ragged (3, 5, 7) and once in float64; a
   thread block cluster with 3 sweeps at CUC level 4 (4, 64, 64) and at
   ragged (2, 17, 9) and (4, 33, 17), and refusing CUC level 3
   (8, 128, 128) and a float64 level (its records would not sit in
   registers); a launch per colour step with 3 sweeps at CUC level 3,
   (64, 64, 64) and the CUC level-0 shape (the floor of a launch per
   colour step printed beside its bound); each timed one-launch form
   printed with its device time, the step floor of K10's step_floor
   (ncolor x sweeps steps in one launch of the same form) and the step
   form's times at the same shape.  Time each
   against its plain version
   (CUDA events, median of 20) beside its bound: the larger of its bytes
   (each input read once, each output written once) over 3.35 TB/s and
   its operations over the float32 peak of 67 TFLOP/s; each kernel's
   line in the json is timed at the shape its path gives it (K1 on the
   bfloat16 stack at (64, 32, 32)).  At (64, 512, 512) one K4 sweep is
   also timed against one sweep of two K1 launches and their two halo
   extensions, with either operator type.  K8 (one packed sweep, every
   chunk) at the CUC level-0 quad
   shape (64, 512, 512) with the card-default plan, f32 and bfloat16
   bands, at level 1 (32, 256, 256), at a shape with 3 chunks and 3
   tiles, without 'real', and in float64 at (64, 512, 512) (timed) and a
   ragged shape, held to 0 ulp, its launch plan (threads, window, shared
   memory, blocks per SM) and registers printed, its bound (what its
   outputs depend on, read once) beside the streams as stored, the
   unique bytes of the same sweep and this design's own traffic (the
   bands once per colour), the earlier design's times beside; K9 in both
   modes at the
   level-0 state and RHS shapes, exact, beside one strided PyTorch copy
   (library_ms); K10's dma_only in its three variants at (64, 512, 512)
   and on bfloat16 blocks (all, blocks), and on an RB colour's float32
   and bfloat16 band stacks (dma_only_bands), exact, fma_run within
   its stated tolerance, and step_floor at K6's one-launch shapes
   (roofline.STEP_FLOOR_CASES), exact; the ring forms' registers
   printed.  K7 at CUC level 0 split over a
   virtual (1, 4) mesh (four (64, 1024, 256) tiles, both real_matrix
   values), 0 ulp from its plain version and from K5 on the whole
   grid; its registers, launch plan (tile, ring, shared memory, blocks,
   blocks an SM) and this design's own traffic (rdma_halo.design_bytes)
   printed beside its bound and the earlier design's time.  K11, the
   load-rate
   probes (windows, blocks, j-lead windows, one wide stream), every row
   of the JAX script's two probe sets at a small shape and at its own
   (nz 64, H 512, tj 16, ws 24), to 0 ulp, timed beside one PyTorch call
   of the same sum (library_ms).  Last, the asynchronous copies in the
   SASS of K11's staged_sum_kernel and wide_stream_kernel (bulk copies)
   and of K1-K2, K4, K3, K6's step form, K8, K7 and K10's window ring
   (cp.async), per instance
   (cuobjdump -sass).  The device loop's condition kernel
   (csrc/device_loop.cu) against its plain version, exactly (counter,
   history slot, decision, run count), in float32 and float64 at a NaN
   residual, at i == maxiter, at res == tol, inside the loop and in its
   prologue; timed (events and device time) beside its bytes bound and
   its latency floor (the device time of one int32 += 1).  Last, K4 (one
   sweep, float32 and float64, on the float32/float64 and the bfloat16
   band stack), K3 (its three modes, both operator layouts) and K1-K2
   (every colour, both layouts, K1 also on the bfloat16 operator) on the
   level-0 operator of a land-masked CUC 128^2 x 32 (bmask: phase 20's
   coastal strip and island, whose columns couple to no neighbour), each
   to 0 ulp from its plain version (masked_kernels).  The physics kernel
   (csrc/rhs_fused.cu, the divergence RHS in one pass) against
   ops/rhs.compute_rhs to 0 ulp: at the CUC 1024^2 x 64 float32 main
   path (the model's metrics; timed, median of 20, beside its bound), in
   float64 and with bmask on the land-masked CUC 128^2 x 32
   (rhs_kernels).
2. Seamount 64^3, float32: NHModel.set_matrices -> solve -> check_
   nondivergence; the first F-cycle's residual within 2% of the float64
   golden, <= 1e-4 within 3 F-cycles, max|div| cut >= 100x over the whole
   grid and over the interior, K4 and K3 launched and no other kernel.
3. Seamount 32^3, float64 on the card: the golden history to the golden
   test's tolerance.
4. CUC 1024^2 x 64 (synthetic slope), float32, default config — the main
   path at the full width of the flagship grid: <= 1e-4 within 8
   F-cycles, interior max|div| cut >= 100x, whole-grid ratio <= 2.5e-2
   (its wall-ring remnant grows with resolution, see below), K4 and K3
   launched and no other kernel (counted in this run only), K3 once per
   down-leg restriction (15 a F-cycle) and once per level-0 residual,
   the physics kernel once a rhs call (the solve's, the two checks' and
   the interior ratio's).
5. Seamount 64^3 with use_pallas=True: K6 on the coarsest level, one
   launch per call (one block).
6. CUC 1024^2 x 64 with use_pallas=True: the same.
7. CUC 1024^2 x 64 with use_pallas=True, compact=False: every level in
   full layout, K6 does all relaxation in the form its gate names per
   level (relax_fused.form: one block on the coarsest level, a cluster
   on level 4, one launch per colour step above), each form launched
   exactly as often as the gate predicts, and K5 the residual on the
   levels at least 256 wide; no quad kernel is launched.
8. CUC 1024^2 x 64 with pallas_fused_sweep=False: the per-colour route,
   K1, K2 (the emitted residual) and K3 (its level-0 residual too) on the
   band stack.
9. CUC 1024^2 x 64 in perf mode (fused_bands_bf16=True, V(1,1)): K4 on
   bfloat16 blocks and K3, the defect-form outer step; <= 1e-4 within 12
   F-cycles, its cycles printed beside phase 4's.
10. Seamount 64^3 in perf mode with pallas_fused_sweep=False: K1 on the
   bfloat16 band stack and K3; <= 1e-4 within 6 F-cycles.
11. The level-0 smoother micro-benchmarks at the CUC level-0 shape, run
   in this process through their timing functions
   (mgroms_tpu_torch/scripts/): micro_sweep_fused (one sweep by the K1
   route, K4 and the packed sweep K8 + K9, f32 and bfloat16, timed in
   turns; the packed iterates held to K4's after 2 sweeps and each route
   to the plain sweep; exactly the kernels of each route launched),
   micro_packed_parts and micro_roofline (K1 against K10's dma_only, the
   FMA rate of K10's fma_run, K10's step_floor at K6's one-launch
   shapes), micro_dma_probe (K11's load rates by
   pattern, every probe launched) and micro_colour_update (K1 and K2 at
   the CUC level-0 quads, both layouts, and an RB colour as two
   one-target launches); their rows are printed.
12. CUC 1024^2 x 64, default config, NHModel.distribute(2, 2,
   comm="shard_map") over a virtual mesh of four tiles on the one card
   (the reference's testcuc decomposition; no interconnect is measured):
   <= 1e-4 within 8 F-cycles, the history within 1e-6 of phase 8 (the
   single-device K1-K3 route) and the pressure's deviation from phase 8's
   printed, phase 4's max|div| limits, exactly the kernels its routing
   predicts (DIST_KERNELS: K1-K3 per tile on every level, the tiles
   routed by the single-device compact rule).
13. The residual of phase 12's pressure by two schedules: the shard_map
   backend's on the 2x2 tiles (K5 per tile) and K7 on a (1, 4) re-cut,
   bit for bit, four launches each.
14. CUC 1024^2 x 64 with relax_method='FC' (four colours), default
   config: K1 (one target quad per colour) and K3 on the band stack, no
   K2 and no K4.
15. CUC 1024^2 x 64, FC, use_pallas=True, compact=False: K6's FC form in
   its three forms (as in phase 7) and K5; the history within 1e-3 of
   phase 14's.
16. CUC 1024^2 x 64 with relax_method='GS' (column-Jacobi), use_pallas=
   True: every level in full layout, K6's GS form (one block on the
   coarsest level, the step form above: GS takes no cluster) and K5;
   GS_CYCLES fixed F-cycles, each cutting the residual, mean factor
   >= 2.

17. CUC 1024^2 x 64 in float64 with fused_bands_bf16=True (V(3,2)): K4's
   (float64, bfloat16) instance and K3 and no other kernel, every quad
   level on the band stack and its bfloat16 copy; <= 1e-11 within
   F64_MAXITER F-cycles, phase 4's max|div| limits, the traced F-cycle.
   Beside it seamount 64^3 in float64 with and without bfloat16 bands:
   their F-cycles to 1e-11 within one of each other.
18. refine.refined_pressure_solve (mixed-precision defect correction:
   float32 F-cycles, float64 residuals) on CUC 1024^2 x 64 to 1e-12
   within REFINE_ROUNDS rounds, the inner solve in phase 4's config and
   in perf mode (phase 9's), both relaxing the coarsest level as those
   phases do, and in a run of its own phase 4's config with the direct
   coarsest solve (scripts/refine_solve.py's default, as the JAX
   script's), each launching exactly its path's kernels;
   rounds, inner F-cycles, history, seconds and the pair's peak memory
   (scripts/refine_solve.py's JSON line).
19. The loop modes (loop_phase): scripts/solve_wall.py on CUC 1024^2 x 64
   to 1e-4 in the JAX script's configuration (coarsest='direct', the
   metrics offloaded after the right-hand side), the eager host loop, the
   replayed host loop and the device loop (one CUDA graph, a WHILE node
   around the captured step and the condition kernel), timed (the three
   medians printed), equal histories, the one-off capture and
   instantiation seconds (the WHILE body's printed) and the peak from an
   empty card (its JSON line);
   scripts/loop_graph_build.py on seamount 64^3, the default
   configuration with one and two F-cycles a check and use_pallas with
   one: the device loop's build seconds against its node count (cloned
   and, for the time only, captured into the WHILE body), its solves
   against the replayed host loop's, hist_cpc2[k] == hist_cpc1[2k].
20. CUC 1024^2 x 64, float32, bmask=True: land over the western 2 % of
   the columns (the shelf side) and a 16 x 16 island mid-domain
   (cuc_land_mask): <= 1e-4 within BMASK_MAXITER F-cycles, printed beside
   phase 4's; the interior water max|div| (2 cells off the walls, the
   water eroded twice, as tests/test_bmask.py) cut >= 100x; K4 and K3
   and no other kernel; the replayed history equal to the eager one.
21. CUC 1024^2 x 64, float32, coarsest='direct' (the coarsest level one
   product with its dense inverse): <= 1e-4 within 8 F-cycles, K4 and K3
   the only hand-written kernels; its F-cycles, replayed median, step
   graph node count, device ops and idle share printed beside phase 4's
   (a record, no claim).
22. Seamount 64^3, float32, tridiag='pcr' (PCR on the masked relax
   level, the coarsest; K4 and K3 keep Thomas): <= 1e-4 within 3
   F-cycles, its history printed beside phase 2's.
23. Small checks: netcdf_output on seamount 32^3 into a temporary
   directory (every file of tests/test_diagnostics.py::
   test_netcdf_output_stage_dumps written, p_end equal to the returned
   pressure); gs_exact (relax_method='GS') on seamount 8^3 in float64 on
   the card, eagerly (graph=True refused), equal to the same solve on the
   CPU to 1e-12 relative; testgalerkin on seamount 64^3, level 1, its
   ratio printed and within (3, 5); on that model the pressure solve of
   cases/analytic_rhs.rhs_seamount (the dipole) to <= 1e-4, K4 and K3
   and no other kernel; velocity.velocities_from_interior followed by
   fill_velocity_halos equal to the first call's output.
24. drivers.rndtopo.main at the reference driver's 64^3, float32, --tol
   1e-4 --maxiter 8 --profile: <= 1e-4, the captured step's kernels K4
   and K3 only, the interior max|div| cut >= 100x, the printed tictoc
   table a row for every level, the replayed history equal to the eager
   one.
25. CUC 1024^2 x 64, float32, coarsest='direct' (scripts/profile_cuc.py's
   model): offload_metrics() lowers torch.cuda.memory_allocated by >=
   OFFLOAD_MIN_BYTES; the next rhs equal bit for bit to the one before;
   the replayed solve after a second offload the history of phase 21;
   profile_cuc.run on that model: every level's relax, every level's
   prolong but the coarsest's, the rows' device-time sum within [0.9,
   1.25] x the replayed F-cycle's traced device busy and under 1.25 x the
   eager F-cycle's CUDA-event median, all three printed, and the
   per-level rows.
26. The GSPMD comm layer on a virtual 2x2 mesh of the card (no
   interconnect is measured; the routing above gspmd_phase):
   (a) phase 7's configuration (CUC, use_pallas, compact=False) under
   distribute(2, 2, comm='auto'), which resolves to the GSPMD backend:
   <= 1e-4 within 8 F-cycles, the history within 1e-6 of phase 7's, the
   pressure's deviation from phase 7's printed, phase 4's max|div|
   limits, K6 on every relax of every (sharded, gathered) level in the
   forms and numbers phase 7's gate gives, K5 never; (b) seamount 64^3,
   default config, comm='gspmd': levels 0-2 sharded in plain torch,
   levels 3-4 replicated, K4 and K3 launched exactly as predicted
   (replicated_quads), the pressure bit for bit and the history within
   1e-6 of the single-device solve with levels 0-2 in full layout
   (layout_reference), the history within 1e-3 of phase 2's; (c)
   scripts/scaling.run_one at seamount 128^2 x 64 (coarsest='direct') on
   1x1 and on 2x2 under both layers: eager F-cycle ms (CUDA events), the
   1x1 replay, the overhead factor, the lock-step runner's rounds per
   F-cycle and a traced step's idle share.

Every single-device solve (phases 2-10, 14-22, the inner solves of 18)
replays its captured step (capture.py; the model's first solve captures
it): phases 2-10 and 14-17 hold the replayed solve to the same model's
eager solve (graph=False) to every digit of the history, the pressure bit
for bit and the same launch counts (phases 20-22 too), and print the one-off warm-up,
capture and instantiation seconds; the launch counts every check reads
are the replayed solve's: a replay adds its graph's kernel nodes, by
function, to the counters, and the device loop its body's times the
runs its condition kernel counted on the device (capture.py).  Phase 12
and phase 26 (distributed backends) stay eager.

Every phase with quad levels (2, 4-6, 8-10, 12, 14, 17, 20-22) checks that every
quad level (every tile on phase 12's mesh) holds the band stack only, no
gather blocks, whatever route smooths it; every phase prints its peak
device memory (set-up and solve).

Phases 5-10 and 12-16 run in float32, 17 in float64.  Phases 5-8 hold
their history to the matching default phase's (2 or 4) within rel 1e-6
(1e-3 with compact=False, whose sums round in another order, and for
phase 8, whose residuals are emitted where phase 4's are fresh).  Every
float32 phase reaches <= 1e-4 within its cycle limit, meets its default
phase's max|div| limits and launches every kernel of its path and no
other.

Phases 2, 4-10, 12, 14-17 and 20-22 also time one F-cycle (CUDA events, median
of 5) eagerly and, but for phase 12, as a replay, and trace one F-cycle
with torch.profiler (device activity only), eagerly and as a replay:
device ops, device busy time against the same traced step's wall time
(the idle share), for the eager step K4's, K3's, K1-K2's and each K6
form's launches and device time where they run and the top device ops;
the replay's op count beside the eager step's plus the copies back into
the static buffers.

The line before last is a JSON object with, for each kernel, its launches
in the phase that is its path (4 for K4, K3 in both its modes and the
physics kernel, 6 for
K6's one-block form, 7 for K5 and K6's cluster and per-colour-step
forms, 8 for K1 and K2, 9 for K4 on bfloat16 bands, 17 for K4 on
bfloat16 bands with a float64 state, 10 for K1 on the bfloat16 stack, 11 for K8-K11 and K10's step floor, 13 for K7, 15 for
K6's FC forms, 16 for its GS forms, 19 for the device loop's condition),
its error against the plain
version, both times and its
bound (K6's one-launch forms also their device time); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mgroms_tpu_torch import NHModel, SolverConfig, velocity
from mgroms_tpu_torch.bc import extend_h1
from mgroms_tpu_torch.capture import captured_step
from mgroms_tpu_torch.cases import analytic_rhs
from mgroms_tpu_torch.cases.cuc import setup_cuc_synthetic
from mgroms_tpu_torch.cases.seamount import initial_velocities, setup_seamount
from mgroms_tpu_torch.levels import describe
from mgroms_tpu_torch.ops import relax_compact as rc
from mgroms_tpu_torch.ops.kernels import (_build, launches, reset_launches,
                                          set_launches)
from mgroms_tpu_torch.ops.kernels import device_loop as kdl
from mgroms_tpu_torch.ops.kernels import dma_probe as dp
from mgroms_tpu_torch.ops.kernels import rdma_halo as k7
from mgroms_tpu_torch.ops.kernels import relax_fused as kf
from mgroms_tpu_torch.ops.kernels import relax_tiled as kt
from mgroms_tpu_torch.ops.kernels import rhs_fused as krhs
from mgroms_tpu_torch.ops.kernels import roofline as rl
from mgroms_tpu_torch.ops.kernels import stencil_tiled as ks
from mgroms_tpu_torch.ops.kernels import sweep_fused as ksf
from mgroms_tpu_torch.ops.kernels import sweep_packed as sp
from mgroms_tpu_torch.ops.rhs import compute_rhs, wall_face_masks
from mgroms_tpu_torch.parallel import mesh as pmesh
from mgroms_tpu_torch.parallel.exchange import unblock_overlapped
from mgroms_tpu_torch.scripts import micro_colour_update as mcu
from mgroms_tpu_torch.scripts import micro_dma_probe as mdp
from mgroms_tpu_torch.scripts import micro_packed_parts as mpp
from mgroms_tpu_torch.scripts import micro_relax_fused as mrf
from mgroms_tpu_torch.scripts import micro_roofline as mr
from mgroms_tpu_torch.scripts import micro_sweep_fused as msf
from mgroms_tpu_torch.scripts import (loop_graph_build, profile_cuc,
                                      refine_solve, solve_wall)
from mgroms_tpu_torch.scripts._timing import card_line, median_ms
from mgroms_tpu_torch.solver import solve_init, solve_step, testgalerkin

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "mgroms_tpu_torch/csrc/"
# kernel -> (source, the TPU kernel it replaces, the phase that is its path)
KERNELS = {
    "color_update": ("relax_tiled.cu",
                     "mgroms_tpu/ops/pallas/relax_tiled.py:147", 8),
    "color_update_bf16": ("relax_tiled.cu",
                          "mgroms_tpu/ops/pallas/relax_tiled.py:147", 10),
    "color_update_emit": ("relax_tiled.cu",
                          "mgroms_tpu/ops/pallas/relax_tiled.py:247", 8),
    "residual_restrict": ("rr_fused.cu",
                          "mgroms_tpu/ops/pallas/relax_tiled.py:340", 4),
    "residual_quads": ("rr_fused.cu", "mgroms_tpu/ops/relax_compact.py:615",
                       4),
    "relax_fused_sweep": ("sweep_fused.cu",
                          "mgroms_tpu/ops/pallas/sweep_fused.py:509", 4),
    "relax_fused_sweep_bf16": ("sweep_fused.cu",
                               "mgroms_tpu/ops/pallas/sweep_fused.py:509", 9),
    "relax_fused_sweep_bf16_f64": ("sweep_fused.cu",
                                   "mgroms_tpu/ops/pallas/sweep_fused.py:509",
                                   17),
    "residual_tiled": ("stencil_tiled.cu",
                       "mgroms_tpu/ops/pallas/stencil_tiled.py:75", 7),
    "fused_relax": ("relax_fused.cu",
                    "mgroms_tpu/ops/pallas/relax_fused.py:99", 6),
    "fused_relax_cluster": ("relax_fused.cu",
                            "mgroms_tpu/ops/pallas/relax_fused.py:99", 7),
    "fused_relax_step": ("relax_fused.cu",
                         "mgroms_tpu/ops/pallas/relax_fused.py:99", 7),
    "fused_relax_fc": ("relax_fused.cu",
                       "mgroms_tpu/ops/pallas/relax_fused.py:99", 15),
    "fused_relax_cluster_fc": ("relax_fused.cu",
                               "mgroms_tpu/ops/pallas/relax_fused.py:99", 15),
    "fused_relax_step_fc": ("relax_fused.cu",
                            "mgroms_tpu/ops/pallas/relax_fused.py:99", 15),
    "fused_relax_gs": ("relax_fused.cu",
                       "mgroms_tpu/ops/pallas/relax_fused.py:99", 16),
    "fused_relax_step_gs": ("relax_fused.cu",
                            "mgroms_tpu/ops/pallas/relax_fused.py:99", 16),
    "sweep_packed": ("sweep_packed.cu",
                     "mgroms_tpu/ops/pallas/sweep_packed.py:519", 11),
    "sweep_packed_bf16": ("sweep_packed.cu",
                          "mgroms_tpu/ops/pallas/sweep_packed.py:519", 11),
    "pack_streams": ("sweep_packed.cu",
                     "mgroms_tpu/ops/pallas/sweep_packed.py:591", 11),
    "dma_only": ("roofline.cu", "scripts/micro_roofline.py:123", 11),
    "fma_run": ("roofline.cu", "scripts/micro_roofline.py:266", 11),
    # no TPU counterpart: the floor of K6's one-launch forms, named by
    # the kernel it measures
    "step_floor": ("roofline.cu", "mgroms_tpu/ops/pallas/relax_fused.py:99",
                   11),
    "residual_overlap_x": ("rdma_halo.cu",
                           "mgroms_tpu/ops/pallas/rdma_halo.py:132", 13),
    "probe_windows": ("dma_probe.cu", "scripts/micro_dma_probe.py:28", 11),
    "probe_blocks": ("dma_probe.cu", "scripts/micro_dma_probe.py:60", 11),
    "probe_windows_jlead": ("dma_probe.cu", "scripts/micro_dma_probe.py:165",
                            11),
    "probe_wide_stream": ("dma_probe.cu", "scripts/micro_dma_probe.py:242",
                          11),
    # no Pallas kernel: the JAX package leaves the device loop's condition
    # and history update to XLA inside lax.while_loop
    "loop_condition": ("device_loop.cu", "mgroms_tpu/solver.py:731", 19),
    # no Pallas kernel: XLA fuses the JAX package's compute_rhs
    "rhs_fused": ("rhs_fused.cu", "mgroms_tpu/ops/rhs.py:49", 4),
}
# the physics kernels run wherever NHModel.rhs does, outside the solve and
# whatever its route: the phases' path checks leave them out
PHYSICS = {"rhs_fused"}
REL_TOL = 1e-6
# phases 14-15 (FC): the cycle limit, set beside phase 14 in main()
FC_MAXITER = 3
# phase 16 (GS) runs this fixed number of F-cycles.  The port's CPU runs
# of the synthetic CUC slope in float32 reach the float32 floor within
# two F-cycles and stall after it (128^2 x 32: 1.8e-5, then factors
# 1.37, 1.00; 256^2 x 64: 4.3e-5, then 1.02, 1.00; 512^2 x 64: 5.05e-5,
# 4.32e-5, then a 0.01 % rise); at 1024^2 x 64 the first F-cycle reaches
# 1.635e-4 (measured on an H100 80GB HBM3 at 700 W), above 1e-4, so two:
# the second is the last that can cut before the floor.  Each must cut
# the residual, by >= 2x on the mean (tests/test_solver.py:164 pins that
# mean factor for JAX's GS), to <= 1e-4
GS_CYCLES = 2
# phase 17 (CUC, float64, bfloat16 bands, V(3,2)) reaches 1e-11 within
# this many F-cycles: 1.5x the 4 of its first run on the card (7.497e-12
# after the fourth, on an H100 80GB HBM3 at 700 W)
F64_MAXITER = 6
# phase 18: the refined solve's round limit (refine_solve.run's default)
REFINE_ROUNDS = 8
# phase 20 (CUC with land masking) reaches 1e-4 within this many F-cycles
BMASK_MAXITER = 12
# phase 21 (CUC, coarsest='direct') and phase 22 (seamount 64^3, PCR)
DIRECT_MAXITER = 8
PCR_MAXITER = 3
# phase 25: what offload_metrics must give back at CUC 1024^2 x 64 in
# float32: the metrics are 387 planes and 5 fields of 1026^2 values
# (392 x 4,210,704 B), less umask and vmask, which level 0's operator
# shares
OFFLOAD_MIN_BYTES = 1.60e9
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak
F32_FLOPS = 67e12                # float32 outside the tensor cores


def check_path(counts, busy):
    """Every kernel of ``busy`` launched, every other kernel not."""
    check(all((counts[k] > 0) == (k in busy)
              for k in KERNELS if k not in PHYSICS),
          f"launches {counts}, expected exactly {sorted(busy)}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nbytes_, flops):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_ulp(got, want) -> float:
    """max |got - want| in units of the spacing of float at |want|."""
    a = want.abs()
    spacing = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return float(((got - want).abs() / spacing).max())


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------ phase 1

def kernel_inputs(nz, H, W, dtype, dev, seed, lp=False, bands=False,
                  real=True):
    """Random diagonally dominant operator pack (with the low-precision
    smoother operator when ``lp``, with the band stack K4 reads when
    ``bands``), state quads and RHS quads, made on the card from a seeded
    generator.  A float64 pack with ``lp`` is a float64 K4 level's: the
    band stack, its bfloat16 copy and float64 pivots, no gather blocks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=dev, dtype=dtype)
    cA = 0.2 * u(8, nz, 2 * H + 2, 2 * W + 2) - 0.1
    cA[0] -= 4.0
    if lp and dtype == torch.float64:
        pack = rc.attach_lp(rc.build_band_pack(cA, real))
    else:
        pack = rc.build_compact_pack(cA, real)
        if lp:
            pack = rc.attach_lp(pack)
        if bands:
            pack = rc.attach_bands(pack, cA)
    del cA
    q = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
    bq = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
    return pack, q, bq


def compare(name, got, want, res_scale):
    """max |kernel - plain| and max ulp, held to 1e-6 x max|plain| for
    solutions, 1e-6 x max|b| for residual outputs (a cancellation)."""
    if isinstance(got, tuple):       # emit: (solution, raw residual)
        err_s = float((got[0] - want[0]).abs().max())
        err_r = float((got[1] - want[1]).abs().max())
        check(err_s <= REL_TOL * float(want[0].abs().max()),
              f"{name} solution off by {err_s}")
        check(err_r <= REL_TOL * res_scale, f"{name} residual off by {err_r}")
        return (max(err_s, err_r),
                max(max_ulp(got[0], want[0]), max_ulp(got[1], want[1])))
    err = float((got - want).abs().max())
    limit = REL_TOL * (res_scale or float(want.abs().max()))
    check(err <= limit, f"{name} off by {err} (limit {limit})")
    return err, max_ulp(got, want)


def flat(parts) -> torch.Tensor:
    """One 1-D tensor of a list of per-chunk results (K8: tuples of the
    four quads; K9: the streams)."""
    return torch.cat([(torch.stack(p) if isinstance(p, tuple) else p)
                      .flatten() for p in parts])


def hold(results, name, shape, dtype, kern, plain, res_scale, nbytes_,
         flops, timed, exact=False, library=None):
    """Hold one kernel call to its plain version (to 0 ulp with
    ``exact``); with ``timed`` also time both (and ``library``, the one
    PyTorch call computing the same function) and keep the numbers under
    ``name`` in ``results``."""
    got, want = kern(), plain()
    if isinstance(got, dict):                 # K4, K3: per target quad
        check(sorted(got) == sorted(want), f"{name}: targets differ")
        got, want = (torch.stack([x[t] for t in sorted(got)])
                     for x in (got, want))
    elif isinstance(got, list):               # K8, K9: per chunk
        got, want = flat(got), flat(want)
    err, ulp = compare(name, got, want, res_scale)
    torch.cuda.synchronize()
    print(f"kernel {name:22s} {str(shape):17s} {str(dtype):14s} "
          f"max|kernel-plain| = {err:.3e} ({ulp:g} ulp)")
    check(not exact or ulp == 0, f"{name} {shape} is {ulp} ulp off")
    if not timed:
        return
    ms = median_ms(kern)
    plain_ms = median_ms(plain)
    library_ms = median_ms(library) if library else None
    bound_ms, bound_by = bound(nbytes_, flops)
    if timed == "json":
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
    print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          + (f"library {library_ms:.4f} ms, " if library else "")
          + f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes_ / 1e9:.4f} GB, "
          f"{flops / 1e9:.4f} GFLOP)")


def kernel_phase(dev):
    results = {}
    colour_kernels(dev, results)
    rr_kernels(dev, results)
    sweep_kernels(dev, results)
    full_layout_kernels(dev, results)
    packed_kernels(dev, results)
    roofline_kernels(dev, results)
    overlap_kernels(dev, results)
    probe_kernels(dev, results)
    loop_kernels(dev, results)
    sass_async_copies()
    masked_kernels(dev, results)
    rhs_kernels(dev, results)
    return results


# the device loop's condition (state dtype; rsq, bnorm, it, prologue, tol):
# a NaN residual (0/0, as b == 0 gives) in a check and in the prologue,
# i == maxiter, res == tol (tol None: the residual itself), inside the
# loop, the prologue
LOOP_MAXITER, LOOP_CPC = 8, 2
LOOP_CASES = [(0.0, 0.0, 0, False, 1e-4), (0.0, 0.0, 0, True, 1e-4),
              (4e-6, 1.0, 6, False, 1e-4), (1e-8, 1.0, 0, False, None),
              (2.5e-7, 3.0, 2, False, 1e-4), (2.5e-7, 3.0, 3, True, 1e-4),
              (7.3e-3, 0.37, 1, False, 1e-6)]


def loop_buffers(rsq, bnorm, it0, tol, dtype, dev, capacity):
    f64 = dict(dtype=torch.float64, device=dev)
    return dict(rsq=torch.tensor(rsq, dtype=dtype, device=dev),
                bnorm=torch.tensor(bnorm, dtype=dtype, device=dev),
                it=torch.tensor(it0, dtype=torch.int32, device=dev),
                hist=torch.full((capacity,), float("nan"), **f64),
                lim=torch.tensor([float(LOOP_MAXITER), tol], **f64),
                cont=torch.tensor(9, dtype=torch.int32, device=dev),
                runs=torch.tensor(3, dtype=torch.int32, device=dev))


def loop_kernels(dev, results):
    """The device loop's condition kernel (csrc/device_loop.cu) against its
    plain version on the card, exactly (counter, history slot, decision,
    run count), in float32 and float64 at LOOP_CASES; timed in float32
    (the main path's type) in the loop's mode: CUDA events around the
    call (host enqueue included) and its device time (torch.profiler),
    beside its bound: 48 bytes (the two norms, the counters and the
    limits read, the counters, the history slot and the decision written)
    over the card's memory rate, and its real floor, a launch and one
    dependent global round trip, measured as the device time of
    PyTorch's kernel that adds 1 to one int32 in device memory (read,
    then a dependent write)."""
    for dtype in (torch.float32, torch.float64):
        for rsq, bnorm, it0, init, tol in LOOP_CASES:
            if tol is None:
                tol = float(torch.sqrt(torch.tensor(rsq, dtype=dtype))
                            .double() / bnorm)
            k = loop_buffers(rsq, bnorm, it0, tol, dtype, dev,
                             LOOP_MAXITER + LOOP_CPC)
            q = {n: t.clone() for n, t in k.items()}
            kdl.loop_condition(k["rsq"], k["bnorm"], k["it"], k["hist"],
                               k["lim"], LOOP_CPC, init, k["cont"],
                               k["runs"])
            kdl.loop_condition_plain(q["rsq"], q["bnorm"], q["it"],
                                     q["hist"], q["lim"], LOOP_CPC, init,
                                     q["cont"], q["runs"])
            torch.cuda.synchronize()
            check(all(torch.equal(k[n].nan_to_num(-1.0),
                                  q[n].nan_to_num(-1.0))
                      for n in ("it", "hist", "cont", "runs")),
                  f"loop_condition {dtype} {(rsq, bnorm, it0, init, tol)}: "
                  f"{k} != {q}")
        print(f"kernel loop_condition         {str(dtype):14s} "
              f"{len(LOOP_CASES)} cases: counter, history, decision and "
              "run count equal to the plain version (0 ulp)")
    # timed in the loop's mode: the counter grows 2 a call, so the history
    # holds every call of the warm-ups and the timed reps
    k = loop_buffers(2.5e-7, 3.0, 0, 1e-4, torch.float32, dev, 8192)
    args = (k["rsq"], k["bnorm"], k["it"], k["hist"], k["lim"], LOOP_CPC,
            False, k["cont"], k["runs"])
    ms = median_ms(lambda: kdl.loop_condition(*args))
    dev_ms = mrf.device_ms(lambda: kdl.loop_condition(*args))
    k["it"].zero_()
    plain_ms = median_ms(lambda: kdl.loop_condition_plain(*args))
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = mrf.device_ms(lambda: one.add_(1))
    nbytes_ = 4 * 4 + 16 + 4 * 3 + 8
    bound_ms, bound_by = bound(nbytes_, 4)
    results["loop_condition"] = dict(max_abs_err=0.0, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=None,
                                     dev_ms=dev_ms, latency_floor_ms=floor_ms)
    print(f"  loop_condition (one thread): kernel {ms:.4f} ms (CUDA events "
          f"around the call), device time {dev_ms:.5f} ms; latency floor "
          f"(a launch and one dependent global round trip: one int32 += 1) "
          f"{floor_ms:.5f} ms device time; plain {plain_ms:.4f} ms; bytes "
          f"bound {bound_ms:.3e} ms ({bound_by}: {nbytes_} bytes)")


# K1 and K2, a colour a launch (quad shape, dtype, timed): "json" times the
# CUC level-0 quads (phase 8's level 0; K1 on the bfloat16 operator at the
# seamount 64^3 level-0 quads, phase 10's, "bf16"), "print" another
# shape: the CUC level-4 quads; every seamount 64^3 quad level (phase 10's
# path); widths 7, 33 and 70 against the 64-column tile, nz 2 with
# H = W = 1; float64
COLOUR_CASES = [
    ((64, 512, 512), torch.float32, "json"),
    ((4, 32, 32), torch.float32, "print"),
    ((64, 32, 32), torch.float32, "bf16"),
    ((32, 16, 16), torch.float32, None),
    ((16, 8, 8), torch.float32, None),
    ((8, 4, 4), torch.float32, None),
    ((6, 5, 7), torch.float32, None),
    ((2, 1, 1), torch.float32, None),
    ((4, 3, 70), torch.float32, None),
    ((3, 5, 33), torch.float32, None),
    ((6, 5, 7), torch.float64, None),
    ((2, 1, 1), torch.float64, None),
    ((3, 5, 33), torch.float64, None),
    ((64, 512, 512), torch.float64, None),
]
# every colour of both orderings: the RB pairs, then the FC single targets
COLOURS = rc.colour_targets("RB") + rc.colour_targets("FC")


def _stk(d) -> torch.Tensor:
    """The per-target outputs of a colour update, stacked in key order."""
    return torch.stack([d[t] for t in sorted(d)])


def colour_kernels(dev, results):
    """K1 on every colour of both orderings (a launch a colour: both
    targets of an RB colour, one of FC) and K2 on the RB colours, on the
    band stack and on the gather blocks, in float32, float64 and (K1) on
    the bfloat16 operator beside float32 state: 0 ulp from the plain
    versions at every COLOUR_CASES shape.  Bounds as
    scripts/micro_colour_update.cost counts them: the operator as the
    launch reads it, the two sibling quads, the diagonal siblings' plane
    0, each target's column fields and outputs, each once.  Beside each
    timed RB colour the same two targets as two one-target launches (the
    FC form), as the per-target route launched them."""
    for shape, dtype, timed in COLOUR_CASES:
        nz, H, W = shape
        for layout in ("bands", "blocks"):
            lps = (False, True) if dtype == torch.float32 else (False,)
            for lp in lps:
                pack, e, bq = mcu.inputs(dev, nz, H, W, dtype, layout, lp,
                                         seed=sum(shape))
                main = layout == "bands" and (timed == "json" and not lp
                                              or timed == "bf16" and lp)
                json_ = "json" if main else ("print" if timed else None)
                k1 = "color_update_bf16" if lp else "color_update"
                for colour in COLOURS:
                    rb = len(colour) == 2
                    call = (lambda c=colour: _stk(kt.color_update(
                        e, bq, pack, c)))
                    plain = (lambda c=colour: _stk(kt.color_update_plain(
                        e, bq, pack, c)))
                    nb, fl = mcu.cost(pack, colour, False, dtype)
                    t = json_ if colour == rc.colour_targets("RB")[0] \
                        or (colour == rc.colour_targets("FC")[1]
                            and timed and not lp) else None
                    if t and not rb:
                        t = "print"
                    label = (f"{shape} {layout} {'RB' if rb else 'FC'} "
                             f"{colour}" + (" bf16" if lp else ""))
                    hold(results, k1, label, dtype, call, plain, None, nb,
                         fl, t, exact=True)
                    if t and rb:
                        two = median_ms(lambda c=colour: [
                            kt.color_update(e, bq, pack, (x,)) for x in c])
                        print(f"  {label}: the two targets as two "
                              f"one-target launches {two:.4f} ms")
                    if rb and not lp:
                        nb, fl = mcu.cost(pack, colour, True, dtype)
                        scale = max(float(bq[x].abs().max()) for x in colour)
                        hold(results, "color_update_emit", label, dtype,
                             lambda c=colour: tuple(_stk(d) for d in
                                                    kt.color_update_emit(
                                                        e, bq, pack, c)),
                             lambda c=colour: tuple(_stk(d) for d in
                                                    kt.color_update_emit_plain(
                                                        e, bq, pack, c)),
                             scale, nb, fl,
                             json_ if colour == rc.colour_targets("RB")[1]
                             else None, exact=True)
                del pack, e, bq
                torch.cuda.empty_cache()


# K3 (quad shape, dtype, timed): "json" times the CUC level-0 quads
# (phase 4's level 0), "print" its level-4 quads; ragged widths (33, 70
# against the 64-column tile), one quad with nz 2, float64
RR_CASES = [
    ((64, 512, 512), torch.float32, "json"),
    ((4, 32, 32), torch.float32, "print"),
    ((6, 5, 7), torch.float32, None),
    ((4, 3, 70), torch.float32, None),
    ((3, 5, 33), torch.float32, None),
    ((6, 5, 7), torch.float64, None),
    ((2, 1, 1), torch.float64, None),
]


def rr_kernels(dev, results):
    """K3 in both operator layouts (the band stack of the K4 levels, the
    gather blocks of the K1-K2 route and the tiles) and its modes (the
    coarse RHS; the residual of the four targets; the z-pair sums of two)
    against its plain version, to 0 ulp.  Bytes as it reads them: the
    operator (the 24 band quads' values, or the 48 gather blocks and the
    'real' pairs), the four extended state quads, bq, d and ud of the four
    targets, and the output.  Flops per point and target the 30-flop
    residual, 8 'real' flops per column and target, and the z-pair and
    coarse sums (3.5 per fine point)."""
    for shape, dtype, timed in RR_CASES:
        nz, H, W = shape
        g = torch.Generator(device=dev).manual_seed(sum(shape) + 7)
        u = lambda *sh: torch.rand(sh, generator=g, device=dev, dtype=dtype)
        cA = 0.2 * u(8, nz, 2 * H + 2, 2 * W + 2) - 0.1
        cA[0] -= 4.0
        packs = {"bands": rc.build_band_pack(cA, True),
                 "blocks": rc.build_compact_pack(cA, True)}
        del cA
        q = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
        bq = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
        e = rc.extend_quads(q)
        e4 = tuple(e[k] for k in rc._TKEYS)
        n = nz * H * W
        scale = max(float(x.abs().max()) for x in bq.values())
        for layout, pack in packs.items():
            op = (rc.NBANDS * nz * (H + 2) * (W + 2) * pack.ebands
                  .element_size() if layout == "bands"
                  else nbytes(*pack.blocks, *pack.rblocks))
            read = op + nbytes(*e4, *bq.values(), *pack.d, *pack.ud)
            modes = [("residual", rc._TKEYS, 4 * n, 4 * 30 * n)]
            if nz % 2 == 0:
                modes = [("coarse", rc._TKEYS, n // 2,
                          4 * 30 * n + 7 * (n // 2))] + modes \
                    + [("zsum", ((0, 0), (1, 1)), n, 2 * 30 * n + n)]
            for mode, targets, nout, flops in modes:
                name = ("residual_quads" if mode == "residual"
                        else "residual_restrict")
                call = lambda: kt.residual_restrict(e4, bq, pack, mode,
                                                    targets)
                plain = lambda: kt.residual_restrict_plain(e4, bq, pack,
                                                           mode, targets)
                hold(results, name, f"{shape} {layout} {mode}", dtype, call,
                     plain, scale, read + nout * dtype.itemsize,
                     flops + 8 * len(targets) * H * W,
                     (timed if layout == "bands" and mode != "zsum"
                      else ("print" if timed and mode != "zsum" else None)),
                     exact=True)
        del packs, q, bq, e, e4
        torch.cuda.empty_cache()


# (shape, dtype, low-precision operator, K4 timed, 'real').  "json" times
# the shape a kernel's main path gives it: K4 at the CUC level-0 quad
# (phases 4, 9 and, float64 on bfloat16 bands, 17); "print" times another
# shape (the (double, double) instance at the CUC level-0 quad).  Where a
# K1 instance takes the same operator, one K4 sweep timed for the json
# line is also timed against one sweep of two K1 launches.
SWEEP_CASES = [
    ((64, 512, 512), torch.float32, False, "json", True),
    ((64, 512, 512), torch.float32, True, "json", True),
    ((64, 512, 512), torch.float64, True, "json", True),
    ((64, 512, 512), torch.float64, False, "print", True),
    ((128, 512, 512), torch.float32, False, "print", True),
    ((4, 32, 32), torch.float32, False, "print", True),
    ((4, 32, 32), torch.float64, True, None, True),
    ((4, 32, 32), torch.float64, True, None, False),
    ((6, 5, 7), torch.float32, False, None, True),
    ((6, 5, 7), torch.float32, True, None, True),
    ((6, 5, 7), torch.float64, False, None, True),
    ((6, 5, 7), torch.float64, True, None, True),
    ((6, 5, 7), torch.float64, True, None, False),
]


def sweep_kernels(dev, results):
    """K4 (one sweep) against its plain version to 0 ulp.  Bytes of K4,
    each input read once as K4 reads it: the four state and RHS quads, the
    24 band quads (bands 3..8 of the operator, the stack's content), ud
    and bet, and the four new quads; its bound on the 48 gather blocks and
    the 'real' pair that the first port read is printed beside.  Flops
    four times K1's on one target.  Where K4 is timed for the json line,
    one K4 sweep is also timed against one sweep of the K1 route (two K1
    launches, a colour each, and the two halo extensions: relax_tiled.
    relax_compact_tiled_quads) on the same band stack.  Prints each
    launch's plan (threads a block, blocks per SM, grid, shared memory)."""
    for shape, dtype, lp, k4_timed, real in SWEEP_CASES:
        nz, H, W = shape
        pack, q, bq = kernel_inputs(*shape, dtype, dev, seed=sum(shape),
                                    lp=lp, bands=True, real=real)
        blocks, rblocks, bet, _ = rc.smoother_operator(pack, dtype)
        stack, _, band = ksf.sweep_bands(pack, dtype)
        name = ksf.ENTRIES[(dtype, band)][1]
        print(f"  {name} {shape} real={real}: launch plan "
              f"{ksf.launch_plan(shape, dtype, band)}")
        n = bq[(0, 0)].numel()
        col = n // shape[0]
        state = nbytes(*q.values(), *bq.values(), *pack.ud, *bet,
                       *q.values())
        band_bytes = rc.NBANDS * nz * (H + 2) * (W + 2) * stack.element_size()
        hold(results, name, shape, dtype,
             lambda: ksf.relax_fused_sweep(q, bq, pack, 1),
             lambda: ksf.relax_fused_sweep_plain(q, bq, pack, 1), None,
             state + band_bytes, 4 * (30 * n + 8 * col), k4_timed,
             exact=True)
        if k4_timed == "json" and blocks is not None:
            old = state + nbytes(*blocks, *rblocks)
            print(f"  {name} {shape} bound on the band quads "
                  f"{bound(state + band_bytes, 0)[0]:.6f} ms "
                  f"({(state + band_bytes) / 1e9:.4f} GB); on the gather "
                  f"blocks {bound(old, 0)[0]:.6f} ms ({old / 1e9:.4f} GB)")
        if k4_timed == "json" and (dtype, band) in kt.COLOUR_ENTRIES:
            k4 = median_ms(lambda: ksf.relax_fused_sweep(q, bq, pack, 1))
            k1 = median_ms(lambda: kt.relax_compact_tiled_quads(q, bq, pack,
                                                                1))
            print(f"  one sweep at {shape}, {'bfloat16' if lp else dtype} "
                  f"band stack: K4 {k4:.4f} ms, two K1 launches + two halo "
                  f"extensions {k1:.4f} ms")
        del pack, blocks, rblocks, bet, stack, q, bq
        torch.cuda.empty_cache()
    sweep_ring_depths(dev)


# (quads, the ring depths timed in turns): the seamount's level 0 at the
# plan's depth (7) against the shallowest ring, and CUC's level 0 at the
# plan's (2 blocks an SM x 2 planes) against the deepest ring that fits
# one block (13)
RING_CASES = [((128, 512, 512), (0, 2)), ((64, 512, 512), (0, 13))]


def sweep_ring_depths(dev):
    """K4 (float32, on the band stack) at forced ring depths against the
    plan's own (0), timed in turns (a, b, b, a; median of 20 each) and
    held to one another bit for bit; prints each launch plan."""
    for shape, depths in RING_CASES:
        pack, q, bq = kernel_inputs(*shape, torch.float32, dev,
                                    seed=sum(shape), bands=True)
        outs, ms = {}, {d: [] for d in depths}
        for d in depths:
            outs[d] = ksf.relax_fused_sweep(q, bq, pack, 1, ahead=d)
            plan = ksf.launch_plan(shape, torch.float32, torch.float32, d)
            print(f"  relax_fused_sweep {shape} ahead {d or 'plan'}: "
                  f"launch plan {plan}")
        for d in depths + depths[::-1]:
            ms[d].append(median_ms(
                lambda: ksf.relax_fused_sweep(q, bq, pack, 1, ahead=d)))
        a, b = depths
        check(all(torch.equal(outs[a][t], outs[b][t]) for t in rc._TKEYS),
              f"K4 {shape}: ring depths {a} and {b} differ")
        print(f"  K4 one sweep at {shape}: "
              + ", ".join(f"ahead {d or 'plan'} {ms[d][0]:.4f} / "
                          f"{ms[d][1]:.4f} ms" for d in depths))
        del pack, q, bq, outs
        torch.cuda.empty_cache()


# kernel -> what its staging must show in the SASS: the bulk copies of
# K11's ring, the asynchronous copies of K1-K2's, K4's, K3's, K6's step
# form's, K8's, K7's and K10's window ring (dma_only's windows and all)
SASS_ASYNC = {"sweep_packed_kernel": ("LDGSTS", "UBLKCP", "UTMALDG"),
              "staged_sum_kernel": ("UBLKCP", "UTMALDG"),
              "wide_stream_kernel": ("UBLKCP", "UTMALDG"),
              "colour_kernel": ("LDGSTS", "UBLKCP", "UTMALDG"),
              "sweep_kernel": ("LDGSTS", "UBLKCP", "UTMALDG"),
              "rr_kernel": ("LDGSTS", "UBLKCP", "UTMALDG"),
              "relax_step": ("LDGSTS", "UBLKCP", "UTMALDG"),
              "overlap_kernel": ("LDGSTS", "UBLKCP", "UTMALDG"),
              "dma_only_ring_kernel": ("LDGSTS", "UBLKCP", "UTMALDG")}


def sass_async_copies():
    """Print, per instance of K11's two kernels, of K1-K2, of K4, of K3,
    of K6's step form, of K8, of K7 and of K10's window ring, how many
    asynchronous-copy instructions
    its SASS holds (cuobjdump -sass of the built library), and check that
    each stages through them."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"  SASS: {tool} not found; the staging instructions are not "
              "checked")
        return
    sass = subprocess.run([tool, "-sass", _build.BuildInfo.path],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = next((k for k in SASS_ASYNC if k in fn), None)
            key = fn
            if name:
                counts[key] = (name, collections.Counter())
            continue
        if name:
            for op in SASS_ASYNC[name]:
                if op in line:
                    counts[key][1][op] += 1
    for fn, (name, c) in sorted(counts.items()):
        print(f"  SASS {name} ({fn[-40:]}): "
              + ", ".join(f"{op} {c[op]}" for op in SASS_ASYNC[name]))
        check(sum(c.values()) > 0, f"{fn}: no asynchronous copy in the SASS")


def full_inputs(nz, ny, nx, dtype, dev, seed):
    """Random bands with a dominant diagonal (a well-conditioned Thomas
    solve), state and RHS of a full-layout level, made on the card from a
    seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=dev, dtype=dtype)
    cA = 0.2 * u(8, nz, ny + 2, nx + 2) - 0.1
    cA[0] -= 4.0
    return cA, 2 * u(nz, ny, nx) - 1, 2 * u(nz, ny, nx) - 1


# (kernel, ordering, shape, dtype, sweeps, timed): "json" times the shape
# the main path gives the kernel (CUC), "print" times another path's
# shape; K6 in each ordering and form, forced whatever the gate says (the
# "json" shapes are the gate's): one block at the coarsest levels of CUC
# (2, 32, 32) and seamount (4, 4, 4), at a ragged shape and in float64; a
# cluster at CUC level 4 (4, 64, 64) (GS "print": the gate gives it the
# step form) and at ragged shapes; the per-colour step form at CUC level
# 3 (8, 128, 128), (64, 64, 64) and CUC level 0
FULL_LAYOUT_CASES = [
    ("residual_tiled", None, (64, 1024, 1024), torch.float32, None, "json"),
    ("residual_tiled", None, (3, 5, 7), torch.float32, None, None),
    ("residual_tiled", None, (8, 16, 33), torch.float64, None, None),
] + [case for kind, k in kf.KINDS.items() for case in (
    (k.block, kind, (2, 32, 32), torch.float32, 40, "json"),
    (k.block, kind, (4, 4, 4), torch.float32, 40, "print"),
    (k.block, kind, (3, 5, 7), torch.float32, 3, None),
    (k.block, kind, (2, 32, 32), torch.float64, 40, None),
    (k.cluster, kind, (4, 64, 64), torch.float32, 3,
     "json" if kf.form((4, 64, 64), torch.float32, kind) == "cluster"
     else "print"),
    (k.cluster, kind, (2, 17, 9), torch.float32, 3, None),
    (k.cluster, kind, (4, 33, 17), torch.float32, 3, None),
    (k.step, kind, (8, 128, 128), torch.float32, 3, "print"),
    (k.step, kind, (64, 64, 64), torch.float32, 3, "print"),
    (k.step, kind, (64, 1024, 1024), torch.float32, 3, "json"))]


# levels the cluster form refuses (its records would not sit in
# registers): CUC level 3, and CUC level 4 in float64
CLUSTER_REFUSED = [((8, 128, 128), torch.float32),
                   ((4, 64, 64), torch.float64)]


def refused(fn) -> bool:
    """Whether ``fn`` raises a refused launch, with no K6 launch."""
    before = dict(kf.LAUNCHES)
    try:
        fn()
    except RuntimeError as e:
        return "launch failed" in str(e) and kf.LAUNCHES == before
    return False


def step_bytes(cA, p, kind) -> int:
    """The bytes one colour step of K6's per-step form must move: the
    operator rows of its colour's columns (RB: all of cA, a sector holds
    both colours; FC: the rows of its j-parity; GS: all), the state, and
    b and the output of its columns."""
    if kind == "FC":
        return (nbytes(cA) + 2 * nbytes(p)) // 2 + nbytes(p)
    return nbytes(cA) + 3 * nbytes(p)


def k6_form(name) -> str:
    """The form of a K6 ``LAUNCHES`` name."""
    return next(f for k in kf.KINDS.values() for f in kf.FORMS
                if k.name(f) == name)


def full_layout_kernels(dev, results):
    """K5 and K6 (every ordering, every form, to 0 ulp) against their
    plain versions.  Flops per point: K5 the 30-flop residual; K6 per
    sweep (each column is solved once a sweep in every ordering) the
    gather (23), RHS (1), the Thomas recurrence with its two divisions (7
    forward, 2 back) and the commit (2); both add 8 plane-0 'real' flops
    per column (per sweep for K6).  A timed one-launch form is printed
    with its device time (torch.profiler), the step floor (K10
    step_floor, ncolor x sweeps steps in the same form) and the step
    form's times at the same shape."""
    for name, kind, shape, dtype, ns, timed in FULL_LAYOUT_CASES:
        nz, ny, nx = shape
        cA, p, b = full_inputs(*shape, dtype, dev, seed=sum(shape))
        col = ny * nx
        if name == "residual_tiled":
            pe = extend_h1(p).contiguous()
            kern = lambda: ks.residual_tiled(pe, b, cA, True)
            plain = lambda: ks.residual_tiled_plain(pe, b, cA, True)
            res_scale = float(b.abs().max())
            cost = (nbytes(pe, b, cA, b), 30 * p.numel() + 8 * col)
        else:
            form = k6_form(name)
            check(timed != "json" or kf.launch_name(p, kind) == name,
                  f"{shape} {dtype} does not take {name}")
            kern = lambda: kf.fused_relax_form(p, b, cA, ns, kind, True,
                                               form)
            plain = lambda: kf.fused_relax_plain(p, b, cA, ns, kind, True)
            res_scale = None
            cost = (nbytes(p, b, cA, p), ns * (35 * p.numel() + 8 * col))
        hold(results, name, shape, dtype, kern, plain, res_scale, *cost,
             timed, exact=kind is not None)
        if kind is not None and timed:
            nsteps = ns * kf.KINDS[kind].ncolor
            if form == "step":
                floor = nsteps * step_bytes(cA, p, kind)
                print(f"  {name} {shape}: floor of a launch per colour step "
                      f"{bound(floor, 0)[0]:.6f} ms ({floor / 1e9:.4f} GB)")
            else:
                plan = {}
                kf.fused_relax_form(p, b, cA, ns, kind, True, form, plan)
                x = p.contiguous()
                fl = lambda: rl.step_floor(x, nsteps, form == "cluster")
                step = lambda: kf.fused_relax_form(p, b, cA, ns, kind, True,
                                                   "step")
                x1 = torch.zeros((1, 1, 1), device=dev)
                empty = lambda: [rl.step_floor(x1, 0) for _ in range(nsteps)]
                dev_ms = mrf.device_ms(kern)
                floor_dev = mrf.device_ms(fl)
                if timed == "json":
                    results[name]["dev_ms"] = dev_ms
                print(f"  {name} {shape} x {ns}: {plan}; device "
                      f"{dev_ms:.4f} ms; step floor ({nsteps} steps) "
                      f"device {floor_dev:.4f} ms, events "
                      f"{median_ms(fl):.4f} ms: kernel / floor "
                      f"{dev_ms / floor_dev:.2f}; the step form at this "
                      f"shape: events {median_ms(step):.4f} ms, device "
                      f"{mrf.device_ms(step):.4f} ms; its floors: "
                      f"{nsteps} empty launches device "
                      f"{mrf.device_ms(empty):.4f} ms, events "
                      f"{median_ms(empty):.4f} ms, its bytes "
                      f"{bound(nsteps * step_bytes(cA, p, kind), 0)[0]:.6f}"
                      f" ms; the gate's form {kf.form(shape, dtype, kind)}")
        del cA, p, b, kern, plain
        torch.cuda.empty_cache()
    for shape, dtype in CLUSTER_REFUSED:
        cA, p, b = full_inputs(*shape, dtype, dev, seed=sum(shape))
        for kind in kf.KINDS:
            check(refused(lambda: kf.fused_relax_form(p, b, cA, 3, kind, True,
                                                      "cluster")),
                  f"the cluster form took {shape} {dtype} {kind}")
        print(f"  cluster form {shape} {dtype}: refused in every ordering "
              f"(the gate's form {kf.form(shape, dtype, 'RB')})")
        del cA, p, b


# (quad shape, dtype, bfloat16 bands, real, plan (tj, nchunks), timed):
# "json" at the shape of phase 11 (the CUC level-0 quad, the card-default
# plan), "print" another; one shape with 3 chunks and 3 tiles (seams,
# first and last tile), one without 'real', float64 at the level-0 shape
# (an 8-column window) and at a ragged one
PACKED_CASES = [
    ((64, 512, 512), torch.float32, False, True,
     (sp.DEFAULT_TJ, sp.DEFAULT_NCHUNKS), "json"),
    ((64, 512, 512), torch.float32, True, True,
     (sp.DEFAULT_TJ, sp.DEFAULT_NCHUNKS), "json"),
    ((64, 512, 512), torch.float64, False, True,
     (sp.DEFAULT_TJ, sp.DEFAULT_NCHUNKS), "print"),
    ((32, 256, 256), torch.float32, False, True,
     (sp.DEFAULT_TJ, sp.DEFAULT_NCHUNKS), "print"),
    ((6, 12, 96), torch.float32, False, True, (4, 3), None),
    ((16, 64, 64), torch.float32, False, False, (8, 2), None),
    ((6, 12, 96), torch.float64, False, True, (4, 3), None),
]


# the earlier design's times at the CUC level-0 shape (a thread a column,
# every term from device memory, colour 0 through a store in device
# memory; PERF.md section 6, H100 80GB HBM3 at 700 W), printed beside this
# run's
PACKED_EARLIER_MS = {("sweep_packed", torch.float32): "5.742-6.096",
                 ("sweep_packed_bf16", torch.float32): "8.335-8.436",
                 ("sweep_packed", torch.float64): "not timed",
                 "state": "0.482-0.525", "rhs seam": "0.151-0.179"}


def ptxas_lines(name: str) -> list:
    """The -Xptxas -v lines of every instance of kernel ``name`` in this
    process's build log (registers, spills, shared memory)."""
    out, keep = [], False
    for line in _build.BuildInfo.log.splitlines():
        if line.startswith("["):
            keep = False
        elif ("Compiling entry function" in line
              or "Function properties" in line):
            keep = name in line
        if keep:
            out.append(line.strip())
    return out


def packed_kernels(dev, results):
    """K8 (one packed sweep: every chunk on pre-packed streams) and K9
    (both modes, at the shapes a sweep gives it) against their plain
    versions, exactly.  Bytes of K8: every element of the packed streams
    the outputs depend on, read once, and the four output quads
    (sweep_packed.needed_bytes); flops as K4's.  Beside them the streams
    as stored, the unique bytes of the same sweep (what K4's bound
    counts) and this design's own traffic (sweep_packed.design_bytes: the
    bands once per colour).  First, K8's and K9's registers, spills and
    shared memory (-Xptxas -v) and each K8 case's launch plan."""
    for line in ptxas_lines("sweep_packed_kernel") + ptxas_lines("pack_"):
        print(f"  ptxas {line}")
    for shape, dtype, lp, real, (tj, C), timed in PACKED_CASES:
        nz, H, W = shape
        g = torch.Generator(device=dev).manual_seed(sum(shape))
        u = lambda *s: torch.rand(s, generator=g, device=dev, dtype=dtype)
        cA = 0.2 * u(8, nz, 2 * H + 2, 2 * W + 2) - 0.1
        cA[0] -= 4.0
        pack = rc.build_compact_pack(cA, real)
        sop = sp.build_sweep_operator(cA, pack, nz, H, W, tj=tj, nchunks=C,
                                      band_dtype=torch.bfloat16 if lp
                                      else None)
        del cA, pack
        q = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
        bq = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
        pbq, pqs = sp.pack_rhs(bq, tj, C)
        psts = sp.pack_state(q, tj, C)
        args = [(psts[c], sop.pband[c], sop.ppiv[c], sop.pseam[c], pbq[c],
                 pqs[c], tj, nz, real, c == 0, c == C - 1) for c in range(C)]
        n = nz * H * W
        stored = nbytes(*psts, *sop.pband, *sop.ppiv, *sop.pseam, *pbq,
                        *pqs)
        isz, bsz = q[(0, 0)].element_size(), sop.pband[0].element_size()
        need = sp.needed_bytes(nz, H, W, tj, C, isz, bsz, real)
        nb = sum(need.values())
        uniq = sp.unique_bytes(nz, H, W, isz, bsz)
        own = sp.design_bytes(nz, H, W, tj, C, isz, bsz)
        name = "sweep_packed_bf16" if lp else "sweep_packed"
        band = torch.bfloat16 if lp else dtype
        print(f"  {name} {shape} {dtype}: launch plan "
              f"{sp.launch_plan(nz, tj, W // C, dtype, band)}")
        hold(results, name, shape, dtype,
             lambda: [sp.sweep_chunk(*a) for a in args],
             lambda: [sp.sweep_chunk_plain(*a) for a in args], None, nb,
             4 * (30 * n + 8 * H * W), timed, exact=True)
        print(f"  {name} {shape} plan tj {tj}, {C} chunk(s): needed (GB) "
              + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in need.items())
              + f", total {nb / 1e9:.4f}; packed streams as stored "
              f"{stored / 1e9:.4f} GB; unique bytes of the sweep (GB) "
              + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in uniq.items())
              + f", total {sum(uniq.values()) / 1e9:.4f}; this design's "
              "traffic (GB) "
              + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in own.items())
              + f", total {sum(own.values()) / 1e9:.4f} "
              f"({bound(sum(own.values()), 0)[0]:.4f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:g} TB/s)")
        if timed and shape == (64, 512, 512):
            print(f"  {name} {dtype} at (64, 512, 512), earlier design: "
                  f"{PACKED_EARLIER_MS[(name, dtype)]} ms")
        if shape == (64, 512, 512) and dtype == torch.float32 and not lp:
            for mode, arrs, rows, wpad in (
                    ("state", tuple(sp._pad_rows(sp._pad_cols(e, 1), 1,
                                                 H + 4)
                                    for e in rc.extend_quads(q).values()),
                     tj + 4, 4),
                    ("rhs seam", tuple(sp._pad_cols(sp._pad_rows(
                        bq[t], 1, H + 2), 1) for t in sp._COLOR0),
                     tj + 2, -2)):
                pk = (arrs, tj, rows, W // C, wpad, C)
                outs = sp.pack_streams(*pk)
                # seam mode reads two values a source row: its bytes are
                # the values it moves, in and out
                moved = nbytes(*arrs, *outs) if mode == "state" \
                    else 2 * nbytes(*outs)
                hold(results, "pack_streams", f"{shape} {mode}", dtype,
                     lambda: list(sp.pack_streams(*pk)),
                     lambda: list(sp.pack_streams_plain(*pk)), None,
                     moved, 0,
                     "json" if mode == "state" else "print", exact=True,
                     library=lambda: sp.pack_streams_library(*pk))
                print(f"  pack_streams {mode}, earlier design: "
                      f"{PACKED_EARLIER_MS[mode]} ms")
                del arrs, outs, pk
        del sop, q, bq, pbq, pqs, psts, args
        torch.cuda.empty_cache()


def roofline_kernels(dev, results):
    """K10: dma_only in its three variants at the CUC level-0 quad shape
    on K1's operands with the 'real' pair, and on bfloat16 blocks in two,
    and on an RB colour's float32 and bfloat16 band stacks
    (dma_only_bands) (exact; bytes: each loaded array read once, the
    output written once; flops: one add per value loaded),
    fma_run (within roofline.FMA_RTOL of its float64 plain version), and
    step_floor at K6's one-launch shapes (exact; bytes: the state in and
    out; flops: roofline.step_floor_flops)."""
    nz, H, W = 64, 512, 512
    for line in ptxas_lines("dma_only"):
        print(f"  ptxas {line}")
    o = mr.operands(dev, nz, H, W)
    n, col = nz * H * W, H * W
    adds = {"all": (26, 6), "windows": (12, 4), "blocks": (12, 2)}
    b16 = (o["blocks"].to(torch.bfloat16), o["rb"].to(torch.bfloat16))
    cases = [(w, o["blocks"], o["rb"]) for w in rl.WHICH] \
        + [(w, *b16) for w in ("all", "blocks")]
    for which, blocks, rb in cases:
        lp = blocks.dtype == torch.bfloat16
        a = (o["e3"], o["bq"], blocks, o["ud"], o["bet"], None, which, rb)
        hold(results, "dma_only", f"{(nz, H, W)} {which}"
             + (" bf16 blocks" if lp else ""), torch.float32,
             lambda: rl.dma_only(*a), lambda: rl.dma_only_plain(*a), None,
             rl.dma_only_bytes(nz, H, W, which, lp=lp),
             adds[which][0] * n + adds[which][1] * col,
             "json" if which == "all" and not lp else "print", exact=True)
    del o, a, b16, cases
    colour = rc.colour_targets("RB")[0]
    for lp in (False, True):
        pack, e, bq = mcu.inputs(dev, nz, H, W, lp=lp)
        hold(results, "dma_only", f"{(nz, H, W)} bands"
             + (" bf16" if lp else ""), torch.float32,
             lambda: rl.dma_only_bands(e, bq, pack, colour),
             lambda: rl.dma_only_bands_plain(e, bq, pack, colour), None,
             rl.dma_only_bands_bytes(nz, H, W, colour, lp), 30 * n,
             "print", exact=True)
        del pack, e, bq
    torch.cuda.empty_cache()
    x = torch.rand(rl.FMA_BLOCK, device=dev) + 0.5
    scale = float(rl.fma_run_plain(x).abs().max())
    hold(results, "fma_run", f"{rl.FMA_BLOCK} x {rl.FMA_TILES}",
         torch.float32, lambda: rl.fma_run(x), lambda: rl.fma_run_plain(x),
         rl.FMA_RTOL / REL_TOL * scale, 2 * nbytes(x), rl.fma_flops(),
         "json")
    for shape, nsteps, cluster in rl.STEP_FLOOR_CASES:
        g = torch.Generator(device=dev).manual_seed(sum(shape))
        xs = torch.rand(shape, generator=g, device=dev) + 0.5
        hold(results, "step_floor", f"{shape} x {nsteps}"
             + (" cluster" if cluster else ""), torch.float32,
             lambda: rl.step_floor(xs, nsteps, cluster)[0],
             lambda: rl.step_floor_plain(xs, nsteps), None, 2 * nbytes(xs),
             rl.step_floor_flops(shape, nsteps),
             "json" if shape == (2, 32, 32) else "print", exact=True)


# K7's four (64, 1024, 256) launches in its first design (a thread a
# column over plane chunks, separate seam blocks; PERF.md, H100 80GB HBM3,
# 700 W)
OVERLAP_EARLIER_MS = "2.107-2.212"


def virtual_mesh(dev, npx, npy):
    """An (npy, npx) mesh of ``dev`` repeated: every tile on the one card."""
    return pmesh.make_mesh(npx, npy, [dev] * (npx * npy))


def overlap_kernels(dev, results):
    """K7 at CUC level 0 (64, 1024, 1024) f32 split over a virtual (1, 4)
    mesh, four (64, 1024, 256) tiles, both ``real_matrix`` values: 0 ulp
    from its plain version (halo_extend + stencil.residual per tile) and
    from K5 on the whole grid.  Timed: the four launches (kernel), the
    plain version through shard_map; printed beside them the four launches
    through shard_map (the lock-step runner's host cost).  Bytes: each
    tile's extended bands, p and b read once and r written once; flops
    K5's."""
    nz, ny, nx, npx = 64, 1024, 1024, 4
    for line in ptxas_lines("overlap_kernel"):
        print(f"  ptxas {line}")
    print(f"  residual_overlap_x launch plan (64, 1024, 256) f32 "
          f"{k7.launch_plan(ny, nx // npx)}, f64 "
          f"{k7.launch_plan(ny, nx // npx, torch.float64)}")
    own = k7.design_bytes(nz, ny, nx // npx)
    cA, p, b = full_inputs(nz, ny, nx, torch.float32, dev, seed=132)
    mesh = virtual_mesh(dev, npx, 1)
    cut = lambda a, extra=(0, 0): pmesh.split_tiles(a, (1, npx),
                                                    mesh.devices, extra)
    pt, bt, ct = cut(p), cut(b), cut(cA, (2, 2))
    nb = nbytes(*pt.flat(), *bt.flat(), *ct.flat(), *bt.flat())
    for real in (True, False):
        k5 = ks.residual_tiled(extend_h1(p).contiguous(), b, cA, real)
        via = lambda fn: pmesh.shard_map(
            lambda p_l, b_l, c_l: fn(p_l, b_l, c_l, real), mesh)(pt, bt, ct)
        row = pt.grid[0]

        def kern():
            return [k7.residual_overlap_tile(
                row[i], bt.grid[0][i], ct.grid[0][i], real,
                row[i - 1] if i else None,
                row[i + 1] if i < npx - 1 else None) for i in range(npx)]

        hold(results, "residual_overlap_x", f"4 x {(nz, ny, nx // npx)} "
             f"real={real}", torch.float32, kern,
             lambda: list(via(k7.residual_overlap_x_plain).flat()),
             float(b.abs().max()), nb, 30 * p.numel() + 8 * ny * nx,
             "json" if real else None, exact=True)
        if real:
            moved = npx * sum(own.values())
            print(f"  residual_overlap_x: this design moves (GB, four "
                  f"tiles) " + ", ".join(f"{k} {npx * v / 1e9:.4f}"
                                         for k, v in own.items())
                  + f", total {moved / 1e9:.4f} "
                  f"({bound(moved, 0)[0]:.4f} ms at "
                  f"{HBM_BYTES_PER_S / 1e12:g} TB/s) beside the bound's "
                  f"{nb / 1e9:.4f} GB ({bound(nb, 0)[0]:.4f} ms); earlier "
                  f"design {OVERLAP_EARLIER_MS} ms")
        got = pmesh.join_tiles(via(k7.residual_overlap_x), dev)
        check(torch.equal(got, k5), f"K7 != K5 on the whole grid "
              f"(real={real}): max ulp {max_ulp(got, k5)}")
        print(f"  K7 == K5 on the whole (64, 1024, 1024) grid, "
              f"real={real}: 0 ulp")
        if real:
            print(f"  the four K7 launches through shard_map: "
                  f"{median_ms(lambda: via(k7.residual_overlap_x)):.4f} ms")
        del k5, got
    del cA, p, b, pt, bt, ct
    torch.cuda.empty_cache()


# K11 at a small shape (None) and at the JAX script's (mdp.cases()): the
# json line of each probe times case A's row of its layout
PROBE_JSON = {"windows": ("probe_windows", "element_windows_132"),
              "blocks": ("probe_blocks", "aligned_blocks_128"),
              "jlead": ("probe_windows_jlead", "jlead_windows_132x24"),
              "wide": ("probe_wide_stream", "one_wide_zmajor_stream")}


def probe_kernels(dev, results):
    """K11: each probe at a small shape (nz 2, H 16, tj 8, ws 12) and at
    the JAX script's (nz 64, H 512, tj 16, ws 24), both probe sets, to 0
    ulp from its plain version (the same left-to-right sums); timed with
    its one-call PyTorch sum (library_ms) at case A's row of its layout.
    Bytes: each input byte the sum reads once (for the window probes the
    summed H x 128 slice of each plane, what their plain version and
    library call read) and the output written once; the window probes'
    own loads, every window at every step (the JAX script's count), and
    each window byte once (unique) are printed beside."""
    for small in (True, False):
        geom = (2, 16, 8, 12) if small else (mdp.NZ, mdp.H, mdp.TJ, mdp.WS)
        nz, H, tj, ws = geom
        for k, (label, probe, shape, nb) in enumerate(mdp.cases(*geom)):
            name, json_label = PROBE_JSON[probe]
            X = mdp.inputs(shape, dev, k)
            kern, plain, lib = mdp.calls(probe, X, tj, ws, H)
            nsum = mdp.WIDE_GROUPS if probe == "wide" else shape[0]
            n_add = (nsum - 1) * nz * H * dp.LANES
            hold(results, name, f"{label} {geom}", torch.float32, kern,
                 plain, None, nb["slice"], n_add,
                 "json" if label == json_label and not small else None,
                 exact=True, library=lib)
            if not small:
                print(f"  {label}: the JAX script's count "
                      f"{nb['jax'] / 1e9:.4f} GB, unique "
                      f"{nb['unique'] / 1e9:.4f} GB, summed slice "
                      f"{nb['slice'] / 1e9:.4f} GB")
            del X, kern, plain, lib
            torch.cuda.empty_cache()


# ------------------------------------------------------- slice phases

def run_model(nx, ny, nz, case, dtype, dev, tol, maxiter, mesh=None,
              rmask=None, water=None, comm="shard_map", **cfg):
    """The user's path: NHModel -> set_matrices [-> distribute over a
    virtual ``mesh`` (npx, npy) of ``dev`` with the layer ``comm``] ->
    solve -> check_
    nondivergence, with ``SolverConfig(dtype=dtype, **cfg)``.  Returns the
    model, SolveInfo, the max|div| ratios after/before over the whole grid
    and over the interior (the 2-cell wall ring excluded), set-up seconds
    and peak device memory; the pressure is kept as ``m.p_solved``.
    ``rmask`` is the land mask (set_matrices'); with ``water`` (a (ny, nx)
    boolean array) the max|div| ratio over those columns is kept as
    ``m.water_ratio``.
    On a single-device model the solve replays its captured step (the
    model's first solve captures it) and is then held to the same model's
    eager solve (:func:`eager_check`); the launch counts left are the
    replayed solve's."""
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype=dtype, **cfg), device=dev)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, rmask=rmask,
                   hc=case.hc, theta_b=case.theta_b, theta_s=case.theta_s)
    if mesh:
        m.distribute(*mesh, devices=[dev] * (mesh[0] * mesh[1]),
                     comm=comm)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    u, v, w = initial_velocities(nx, ny, nz, dtype=m.dtype, device=dev)
    before = launches()
    uc, vc, wc, p, info = m.solve(u, v, w, tol=tol, maxiter=maxiter)
    div = float(m.check_nondivergence(uc, vc, wc))
    div0 = float(m.check_nondivergence(u, v, w))
    inner = float(m.rhs(uc, vc, wc)[:, 2:-2, 2:-2].abs().max())
    if water is not None:
        cols = torch.as_tensor(water, device=dev)
        m.water_ratio = float(m.rhs(uc, vc, wc)[:, cols].abs().max()) / div0
        print(f"  water max|div| ratio {m.water_ratio:.3e} over "
              f"{int(cols.sum())} columns")
    check(torch.isfinite(p).all() and p.shape == (nz, ny, nx),
          "pressure not finite / wrong shape")
    m.p_solved = p
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  history {['%.4e' % h for h in info.history]}")
    print(f"  set-up {setup_s:.3f} s, solve {info.time_s:.3f} s, "
          f"max|div| {div0:.4e} -> {div:.4e} (ratio {div / div0:.3e}; "
          f"interior ratio {inner / div0:.3e}), peak memory "
          f"{peak / 2**30:.3f} GiB")
    if m.backend.capturable:
        eager_check(m, (u, v, w), info, tol, maxiter, before)
    return m, info, div / div0, inner / div0, setup_s, peak


def eager_check(m, uvw, info, tol, maxiter, before):
    """The model's solve of the same velocities with graph=False (the
    eager loop) against its replayed solve ``info``: the same history to
    every digit, the same pressure bit for bit, and the same launches
    (the replayed solve's, the counts' growth from ``before``: the
    replays counted from the captured graph's kernel nodes, against the
    launches the wrappers enqueue in the eager solve); the counts are
    left as the replayed solve left them."""
    after = launches()
    replayed = {k: n - before[k] for k, n in after.items()}
    check(len(m.backend.graphs) == 1, "the solve replayed no captured step")
    step = next(iter(m.backend.graphs.values()))
    reset_launches()
    *_, p, einfo = m.solve(*uvw, tol=tol, maxiter=maxiter, graph=False)
    eager = launches()
    set_launches(after)
    check(einfo.history == info.history,
          f"replayed history {info.history} != eager {einfo.history}")
    check(torch.equal(p, m.p_solved), "replayed pressure != eager")
    solver = lambda c: {k: n for k, n in c.items() if k not in PHYSICS}
    check(solver(eager) == solver(replayed), f"replayed launches "
          f"{replayed} != eager {eager}")
    print(f"  graph=False solve {einfo.time_s:.3f} s against {info.time_s:.3f}"
          f" s replayed (first solve: warm-up {step.warmup_s:.3f} s, capture "
          f"{step.capture_s:.3f} s, instantiation {step.instantiate_s:.3f} s;"
          f" the step's graph: {step.nodes} nodes, kernel nodes "
          f"{dict(step.launches)}): history equal to every digit, pressure "
          f"bit for bit, launches equal")


def check_band_levels(m):
    """Every quad level holds its operator as the band stack only, whatever
    route smooths it (K4, or K1-K2), the tiles of a distributed level too:
    no gather blocks of either precision.  Prints the levels and the
    stacks' size."""
    be = m.backend
    levels = [lev for lev in range(be.nlevs) if be.state_quads(lev)]
    if not levels:              # compact=False or GS: no quad level
        return
    stacks = 0
    for lev in levels:
        pk = be.packs[lev]
        for tile in (pk.flat() if hasattr(pk, "flat") else (pk,)):
            check(tile.blocks is None and tile.ebands is not None
                  and (tile.lp is None or tile.lp.blocks is None),
                  f"level {lev} holds gather blocks beside its band stack")
            stacks += nbytes(tile.ebands,
                             tile.lp.ebands if tile.lp else None)
    print(f"  quad levels {levels} hold the band stack only (no gather "
          f"blocks): {stacks / 2**30:.3f} GiB of stacks")


def print_fcycle(m, reps=5):
    """Prints and returns (eager, replayed) of profile_cuc.fcycle_ms on
    model ``m`` and the initial velocities' right-hand side (replayed:
    None on a distributed model), the median of ``reps``."""
    u, v, w = initial_velocities(m.nx, m.ny, m.nz, dtype=m.dtype,
                                 device=m.device)
    replay, eager = profile_cuc.fcycle_ms(m, m._rhs_state(u, v, w),
                                          reps=reps)
    print(f"  F-cycle median of {reps} {eager:.3f} ms eager"
          + (f", {replay:.3f} ms replayed" if replay is not None else ""))
    return eager, replay


def device_events(prof) -> list:
    """(name, start us, end us) of each device op of a finished trace,
    read from the profiler's raw results: ``prof.events()`` builds the
    event tree in Python, seconds for a 100k-op trace."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    events = raw.events() if raw is not None else []
    if not events or not hasattr(events[0], "end_ns"):
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == cuda]
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in events if e.device_type() == cuda]


def trace(fn, tries=3, warm=True):
    """One call of ``fn`` under torch.profiler (device activity only),
    after a warm-up call (``warm``): (device ops, busy ms, traced wall
    ms, ops and device us by name).  A trace that recorded no device op
    is taken again, up to ``tries`` times (the profiler now and then
    drops a trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = device_events(prof)
        if dev:
            break
    spans = sorted((a, b) for _, a, b in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, a, b in dev:
        by_name[name][0] += 1
        by_name[name][1] += b - a
    return len(dev), busy_us / 1e3, wall_ms, by_name


def profile_fcycle(m, top=8, warm=True):
    """One F-cycle (solver.solve_step, after a warm-up step unless the
    caller just ran them: ``warm``) under torch.profiler, tracing device activity only, eagerly and (on a
    single-device model) as a replay of the captured step.  Prints the
    device ops traced, the union of their intervals (device busy) against
    the wall time of the same traced step, the idle share 1 - busy/wall,
    and for the eager step the ``top`` device ops by time.  The replay
    runs the eager step's ops and the copies back into the static buffers
    (p and r: a quad level's four quads each, or one array each; ||r||^2
    and ||r||): the counts are printed with their difference (the
    profiler drops a few events of a ~40k-op trace now and then; the
    launch counts are held exactly by :func:`eager_check`); a replay
    trace with no device op fails.  Returns the eager step's (ops, busy
    ms, idle share) and the replay's (None without one)."""
    be = m.backend
    u, v, w = initial_velocities(m.nx, m.ny, m.nz, dtype=m.dtype,
                                 device=m.device)
    p, bs, r, _, _ = solve_init(be, m._rhs_state(u, v, w))
    state = [p, r]

    def eager():
        state[0], state[1], _ = solve_step(be, state[0], bs, state[1],
                                           m.cfg)

    n, busy_ms, wall_ms, by_name = trace(eager, warm=warm)
    out = {"eager": (n, busy_ms, 1 - busy_ms / wall_ms), "replay": None}
    print(f"  profile: {n} device ops, device busy {busy_ms:.3f} ms "
          f"of {wall_ms:.3f} ms traced wall, idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    for label, match in (("K4", ("sweep_kernel<",)), ("K3", ("rr_kernel<",)),
                         ("K1-K2", ("colour_kernel<",)),
                         ("K6 one block", ("relax_resident<", "false>")),
                         ("K6 cluster", ("relax_resident<", "true>")),
                         ("K6 step", ("relax_step<",))):
        ks_ = [v for k, v in by_name.items() if all(x in k for x in match)]
        if ks_:
            print(f"  profile: {label} {sum(n for n, _ in ks_)} launches, "
                  f"{sum(us for _, us in ks_) / 1e3:.3f} ms device time "
                  "per F-cycle")
    for name, (k, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"    {us / 1e3:10.3f} ms {k:7d}x  {name[:90]}")
    if be.capturable:
        step = captured_step(be, m.cfg)
        step.load(state[0], bs, state[1])
        copies = 2 * (4 if be.state_quads(0) else 1) + 2
        rn, rbusy, rwall, _ = trace(step.replay)
        check(rn > 0, "the profiler traced no device op of a replay")
        print(f"  profile (replay): {rn} device ops (the eager step's {n} "
              f"+ {copies} copies: {'equal' if rn == n + copies else 'differ'}"
              f" by {rn - n - copies}), device busy {rbusy:.3f} ms of "
              f"{rwall:.3f} ms traced wall, idle share "
              f"{1 - rbusy / rwall:.4f}")
        out["replay"] = (rn, rbusy, 1 - rbusy / rwall)
    return out


def k6_expected(m) -> collections.Counter:
    """K6's launches a F-cycle by ``LAUNCHES`` name, from the gate: on
    every full-layout level K6 smooths, the coarsest relaxed L times a
    F-cycle (ns_coarsest sweeps), level lev < L-1 lev + 1 times before
    and after its coarse correction (ns_pre, ns_post sweeps); one launch a
    call in the one-launch forms, ncolor a sweep in the step form."""
    be, cfg = m.backend, m.cfg
    k = kf.KINDS[cfg.relax_kind]
    L = len(m.levels)
    out = collections.Counter()
    for lev, spec in enumerate(m.levels):
        if be.state_quads(lev) or not be._use_pallas(lev):
            continue
        form = kf.form((spec.nzg, spec.nyg, spec.nxg), torch.float32,
                       cfg.relax_kind)
        calls = ([(L, cfg.ns_coarsest)] if lev == L - 1 else
                 [(lev + 1, cfg.ns_pre), (lev + 1, cfg.ns_post)])
        for n, ns in calls:
            out[k.name(form)] += n * (k.ncolor * ns if form == "step" else 1)
    return out


def path_phase(title, grid, case, dev, maxiter, ref, rtol, div_limits, cfg,
               busy, tol=1e-4):
    """One float32 phase at the case's full size, on the path that
    ``cfg`` selects, solved to ``tol`` (0: exactly ``maxiter`` cycles):
    <= 1e-4 within ``maxiter`` cycles, the whole-grid and
    interior max|div| ratios within ``div_limits``, exactly the kernels
    ``busy`` launched, and with use_pallas K6 in the forms the gate names
    (``k6_expected``), each exactly as often; with ``rtol`` the history
    against the default phase's ``ref`` within it.  Where K5 runs, 7
    times per F-cycle plus once in solve_init.  Returns the
    launch counts, the SolveInfo and the pressure, on the host (a later
    phase's peak device memory holds nothing of this one)."""
    print(f"== {title}")
    t0 = time.perf_counter()
    nx, ny, nz = grid
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(nx, ny, nz, case, "float32",
                                            dev, tol=tol, maxiter=maxiter,
                                            **cfg)
    counts = launches()
    print(f"  launches {counts}")
    check_band_levels(m)
    if ref is not None:
        n = min(len(info.history), len(ref))
        dev_rel = max(abs(a / b - 1)
                      for a, b in zip(info.history[:n], ref[:n]))
        print(f"  history vs the reference phase: max rel deviation "
              f"{dev_rel:.3e} over {n} entries (limit {rtol})")
        check(rtol is None or dev_rel <= rtol,
              f"history {info.history} vs reference {ref}")
    check(info.res <= 1e-4 and info.niter <= maxiter,
          f"{info.res} after {info.niter} cycles")
    check(ratio <= div_limits[0] and inner <= div_limits[1],
          f"max|div| cut only to {ratio} (interior {inner})")
    k6 = k6_expected(m)
    print(f"  K6 launches a F-cycle by form (the gate): {dict(k6)}")
    check_path(counts, set(busy) | set(k6))
    for name, n in k6.items():
        check(counts[name] == n * info.niter,
              f"K6 {name} {counts[name]} times, expected {n} a F-cycle")
    if "residual_tiled" in busy:
        check(counts["residual_tiled"] == 7 * info.niter + 1,
              f"K5 {counts['residual_tiled']} times")
    print_fcycle(m)
    profile_fcycle(m)
    p = m.p_solved.cpu()
    del m
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts, info, p


# the kernels one sweep of each micro_sweep_fused route launches
ROUTE_KERNELS = {
    "tiled": {"color_update"},
    "fused_f32": {"relax_fused_sweep"},
    "fused_bf16": {"relax_fused_sweep_bf16"},
    "packed_f32": {"sweep_packed", "pack_streams"},
    "packed_bf16": {"sweep_packed_bf16", "pack_streams"},
}


def micro_phase(dev):
    """Phase 11: the four micro entry points' timing functions, three at
    the CUC level-0 shape and the load-rate probes (K11) at the JAX
    script's.  The packed iterates against K4's after 2 sweeps within
    micro_sweep_fused.CHECK_RTOL (f32 and bfloat16), every route against
    the plain sweep within it, exactly each route's kernels launched, and
    every K11 probe launched.  Returns the phase's launch counts."""
    print("== phase 11: level-0 smoother micro-benchmarks, CUC level 0 "
          "(64, 1024, 1024), and the load-rate probes")
    t0 = time.perf_counter()
    reset_launches()
    rows, per_route = msf.timed(dev)
    print(json.dumps({"micro_sweep_fused": rows}))
    print(json.dumps({"micro_sweep_fused_launches": per_route}))
    for route, busy in ROUTE_KERNELS.items():
        check(set(per_route[route]) == busy,
              f"{route} launched {per_route[route]}, expected {busy}")
    for key, val in rows.items():
        if key.startswith("check_"):
            check(val <= msf.CHECK_RTOL, f"{key} = {val}")
    print(json.dumps({"micro_packed_parts": mpp.timed(dev)}))
    print(json.dumps({"micro_roofline": mr.timed(dev)}))
    print(json.dumps({"micro_colour_update": mcu.timed(dev)}))
    print(json.dumps({"micro_dma_probe": mdp.timed(dev)}))
    counts = launches()
    print(f"  launches {counts}")
    for name, (_, _, phase) in KERNELS.items():
        check(phase != 11 or counts[name] > 0, f"{name} not launched")
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts


# The routing of phase 12 (CUC 1024^2 x 64 on a virtual 2x2 mesh): every
# level stays sharded on both axes (local tiles 512 .. 16, all >= nsmall);
# every tile is even, so every level passes the compact gate
# (shardmap_backend.compact_shard_eligible, the single-device rule on the
# tile): levels 0-4 keep quad state and run K1 (sweeps), K2 (the emitted
# residual of the down-leg) and K3 per tile, as phase 8 runs them on the
# whole grid; the coarsest level (level 5, 16^2 tiles) smooths with K1 per
# tile on its full-layout state, where phase 8 runs the masked relax.  No
# level is replicated, so K4 never runs, and the default config has no
# K6 and no full-layout residual wide enough for K5.
DIST_COMPACT_LEVELS = (0, 1, 2, 3, 4, 5)
DIST_KERNELS = {"color_update", "color_update_emit", "residual_restrict"}
# phase 12's history against phase 8's (the single-device K1-K3 route):
# the same kernels on the same levels, so the history is held to REL_TOL


def distributed_phase(case, dev, ref, p_ref):
    """Phase 12: CUC 1024^2 x 64 f32, default config, distributed over a
    virtual 2x2 mesh of the one card (the reference's testcuc
    decomposition, mg_testcuc.f90:34-39): <= 1e-4 within 8 F-cycles, the
    history within REL_TOL of phase 8's ``ref``, phase 4's max|div|
    limits, exactly the kernels the routing predicts (DIST_KERNELS); the
    pressure's max deviation from phase 8's ``p_ref`` relative to
    max|p_ref| is printed.  Returns the model and the phase's launch
    counts."""
    print("== phase 12: CUC 1024^2 x 64 float32, distribute(2, 2, "
          "comm='shard_map') on a virtual mesh of one card (no "
          "interconnect is measured)")
    t0 = time.perf_counter()
    reset_launches()
    m, info, ratio, inner, setup_s, peak = run_model(
        1024, 1024, 64, case, "float32", dev, tol=1e-4, maxiter=8,
        mesh=(2, 2))
    counts = launches()
    print(f"  launches {counts}")
    be = m.backend
    print("  " + describe(m.levels, be.plan.shards).replace("\n", "\n  "))
    check(all(s.sharded and s.shard_py and s.shard_px
              for s in be.plan.shards), "a level left the 2x2 tiling")
    check(tuple(lev for lev in range(be.nlevs)
                if be._use_compact_shard(lev)) == DIST_COMPACT_LEVELS,
          "compact levels differ from the routing's premise")
    check_path(counts, DIST_KERNELS)
    check_band_levels(m)
    n = min(len(info.history), len(ref))
    dev_rel = max(abs(a / b - 1) for a, b in zip(info.history[:n], ref[:n]))
    print(f"  history vs phase 8: max rel deviation {dev_rel:.3e} over {n} "
          f"entries (limit {REL_TOL})")
    p_dev = float((m.p_solved.cpu() - p_ref).abs().max()
                  / p_ref.abs().max())
    print(f"  pressure vs phase 8: max|p12 - p8| / max|p8| = {p_dev:.3e}")
    check(info.res <= 1e-4, f"{info.res} after {info.niter} cycles")
    check(ratio <= 2.5e-2 and inner <= 1e-2,
          f"max|div| cut only to {ratio} (interior {inner})")
    print("  the virtual mesh: four tiles on one card")
    print_fcycle(m)
    profile_fcycle(m)
    check(dev_rel <= REL_TOL, f"history {info.history} vs phase 8 {ref}")
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return m, counts


def overlap_phase(m, dev):
    """Phase 13: the residual of phase 12's pressure on its level-0
    operator by two schedules — the shard_map backend's residual on the
    2x2 tiles (halo_extend, then K5 on each 512-wide tile) and K7 on the
    same grid re-cut into a virtual (1, 4) mesh — equal bit for bit; K5
    and K7 launch four times each and nothing else.  Returns the phase's
    launch counts."""
    print("== phase 13: K7 on a virtual (1, 4) mesh against the 2x2 "
          "shard_map residual, phase 12's pressure")
    t0 = time.perf_counter()
    be = m.backend
    u, v, w = initial_velocities(m.nx, m.ny, m.nz, dtype=m.dtype,
                                 device=dev)
    b = m.rhs(u, v, w)
    p = m.p_solved
    cA = unblock_overlapped(pmesh.join_tiles(be.ops[0].cA, dev), 2, 2, 2, 2)
    mesh = virtual_mesh(dev, 4, 1)
    cut = lambda a, extra=(0, 0): pmesh.split_tiles(a, (1, 4), mesh.devices,
                                                    extra)
    pt, bt, ct = cut(p), cut(b), cut(cA, (2, 2))
    del cA
    reset_launches()
    r_sm = be.gather(0, be.residual(0, be.place(0, p), be.place(0, b)))
    r_k7 = pmesh.join_tiles(pmesh.shard_map(
        lambda p_l, b_l, c_l: k7.residual_overlap_x(p_l, b_l, c_l, be.real),
        mesh)(pt, bt, ct), dev)
    counts = launches()
    print(f"  launches {counts}")
    check_path(counts, {"residual_tiled", "residual_overlap_x"})
    check(counts["residual_tiled"] == 4 and counts["residual_overlap_x"] == 4,
          "expected four launches of K5 and of K7")
    check(torch.equal(r_k7, r_sm),
          f"K7 != the shard_map residual: max ulp {max_ulp(r_k7, r_sm)}")
    rel = float(torch.linalg.vector_norm(r_k7) / torch.linalg.vector_norm(b))
    print(f"  K7 == shard_map residual (0 ulp); ||r||/||b|| = {rel:.4e}")
    check(rel <= 1e-4, f"relative residual {rel}")
    del pt, bt, ct, r_sm, r_k7
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts


K3 = {"residual_restrict", "residual_quads"}


def check_lp_levels(m):
    """Every quad level holds the band stack and its bfloat16 copy with the
    float64 pivots, no gather blocks (a float64 solve with bfloat16
    bands)."""
    be = m.backend
    levels = [lev for lev in range(be.nlevs) if be.state_quads(lev)]
    check(levels and all(
        be.packs[lev].lp is not None and be.packs[lev].lp.blocks is None
        and be.packs[lev].lp.ebands.dtype == torch.bfloat16
        and be.packs[lev].lp.bet[0].dtype == torch.float64
        for lev in levels),
        f"quad levels {levels} do not all hold the bfloat16 stack")


def f64_phase(case, case_seamount, dev):
    """Phase 17: CUC 1024^2 x 64 in float64 with fused_bands_bf16 (V(3,2)):
    <= 1e-11 within F64_MAXITER F-cycles, K4's (float64, bfloat16)
    instance and K3 launched and no other kernel, every quad level on the
    band stack and its bfloat16 copy, phase 4's max|div| limits, the
    traced F-cycle; beside it seamount 64^3 in float64 with and without
    the bands, whose cycles to 1e-11 lie within one of each other (the JAX
    package's criterion, tests/test_sweep_fused.py:173-195).  Returns the
    CUC run's launch counts."""
    print("== phase 17: CUC 1024^2 x 64 float64, fused_bands_bf16=True "
          "(V(3,2)), to 1e-11")
    t0 = time.perf_counter()
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(
        1024, 1024, 64, case, "float64", dev, tol=1e-11,
        maxiter=F64_MAXITER, fused_bands_bf16=True)
    counts = launches()
    print(f"  launches {counts}")
    print(f"  F-cycles to 1e-11: {info.niter} (limit {F64_MAXITER}), "
          f"solve {info.time_s:.3f} s")
    check(info.res <= 1e-11 and info.niter <= F64_MAXITER,
          f"{info.res} after {info.niter} cycles")
    check_path(counts, {"relax_fused_sweep_bf16_f64"} | K3)
    check_band_levels(m)
    check_lp_levels(m)
    check(ratio <= 2.5e-2 and inner <= 1e-2,
          f"max|div| cut only to {ratio} (interior {inner})")
    print_fcycle(m)
    profile_fcycle(m)
    del m
    torch.cuda.empty_cache()
    niter = {}
    for bf16, busy in ((True, "relax_fused_sweep_bf16_f64"),
                       (False, "relax_fused_sweep")):
        print(f"  seamount 64^3 float64, fused_bands_bf16={bf16}:")
        reset_launches()
        ms, sinfo, _, _, _, _ = run_model(
            64, 64, 64, case_seamount, "float64", dev, tol=1e-11,
            maxiter=20, fused_bands_bf16=bf16)
        check_path(launches(), {busy} | K3)
        check(sinfo.res <= 1e-11, f"seamount: {sinfo.res}")
        niter[bf16] = sinfo.niter
        del ms
    print(f"  seamount 64^3 F-cycles to 1e-11: {niter[True]} with bfloat16 "
          f"bands, {niter[False]} without")
    check(abs(niter[True] - niter[False]) <= 1, f"cycles {niter}")
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts


def refine_phase(dev):
    """Phase 18: refine.refined_pressure_solve on CUC 1024^2 x 64 to
    1e-12 within REFINE_ROUNDS rounds, the inner float32 solve in phase
    4's config (K4 and K3) and in perf mode (phase 9's: K4 on bfloat16
    bands and K3), both relaxing the coarsest level as those phases do;
    then, as a run of its own, phase 4's config with the coarsest level
    solved by its dense inverse (coarsest='direct', refine_solve's
    default, as the JAX script's).  Each launches its kernels and no
    other; rounds, inner F-cycles, history, time and the pair's peak
    memory printed (scripts/refine_solve.run)."""
    print("== phase 18: refined_pressure_solve, CUC 1024^2 x 64, tol 1e-12")
    t0 = time.perf_counter()
    for bf16, coarsest, k4 in ((False, "relax", "relax_fused_sweep"),
                               (True, "relax", "relax_fused_sweep_bf16"),
                               (False, "direct", "relax_fused_sweep")):
        reset_launches()
        row = refine_solve.run("cuc", 1024, 1024, 64, bf16_bands=bf16,
                               device=dev, max_rounds=REFINE_ROUNDS,
                               verbose=True, coarsest=coarsest)
        print(json.dumps(row))
        check(row["final_f64_rel_residual"] <= 1e-12,
              f"refine ({coarsest}) stopped at "
              f"{row['final_f64_rel_residual']} after {row['rounds']} rounds")
        check_path(launches(), {k4} | K3)
        torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")


# phase 19: solve_wall's timed solves a mode (after one that captures)
SOLVE_WALL_REPS = 3
# phase 19: seamount 64^3 runs this many F-cycles (tol 0) with one and
# with two F-cycles a check, each mode LOOP_REPS times after its build
LOOP_CYCLES = 4
LOOP_REPS = 3


def loop_phase(case, case_seamount, dev):
    """Phase 19: the convergence loop modes.  scripts/solve_wall.py on CUC
    1024^2 x 64 float32 to 1e-4, in the JAX script's configuration
    (coarsest='direct', the metrics offloaded): the eager host loop, the
    host loop replaying the captured step and the device loop (one CUDA
    graph with a WHILE node), SOLVE_WALL_REPS timed solves each after one
    that captures (their medians printed), their histories equal to every
    digit, the one-off capture
    and instantiation seconds and the peak from an empty card (its JSON
    line); the device loop's condition kernel run once a check and once a
    solve (the runs the device counted), K4 and K3 and no other kernel.
    Then seamount 64^3 float32 (scripts/loop_graph_build.run, the device
    loop built as solve_p builds it and, for its build time only, with
    the step captured into the WHILE body), in the default configuration with
    one and with two F-cycles a check and with use_pallas with one,
    LOOP_CYCLES F-cycles each, LOOP_REPS solves a mode after the build:
    each device loop's history equal to the replayed host loop's, and
    hist_cpc2[k] == hist_cpc1[2k] exactly; the build seconds beside the
    node counts and the two loops' walls.  Returns the CUC run's launch
    counts."""
    print("== phase 19: the loop modes: scripts/solve_wall.py (CUC 1024^2 x "
          "64 to 1e-4, coarsest='direct', metrics offloaded, eager / "
          "replayed / device loop); seamount 64^3 "
          "device loop against the replayed host loop, default config with "
          "cycles_per_check 1 and 2, use_pallas with 1 "
          "(scripts/loop_graph_build.py)")
    t0 = time.perf_counter()
    reset_launches()
    row = solve_wall.run(1024, 1024, 64, tol=1e-4, maxiter=8,
                         reps=SOLVE_WALL_REPS, device=dev, case=case)
    print(json.dumps({"solve_wall": row}))
    counts = launches()
    print(f"  launches {counts}")
    checks = row["device_loop"]["niter"]
    check(counts["loop_condition"] == (SOLVE_WALL_REPS + 1) * (1 + checks),
          f"loop_condition ran {counts['loop_condition']} times")
    check_path(counts, {"relax_fused_sweep", "loop_condition"} | K3)
    check(row["device_loop"]["final_rel_residual"] <= 1e-4,
          f"device loop stopped at {row['device_loop']}")
    check(row["config"]["coarsest"] == "direct"
          and row["offloaded_bytes"] > 0, f"solve_wall config {row['config']}")
    print("  solve wall (s), medians of " f"{SOLVE_WALL_REPS}: " + ", ".join(
        f"{mode} {row[mode]['wall_s_median']:.4f}"
        for mode in solve_wall.MODES) + f"; F-cycles {checks}; step warm-up "
        f"{row['step_warmup_s']:.3f} s, capture {row['step_capture_s']:.3f} "
        f"s, instantiation {row['step_instantiate_s']:.3f} s, device loop "
        f"body clone {row['loop_clone_s']:.3f} s, WHILE body instantiation "
        f"{row['loop_instantiate_s']:.3f} s; peak {row['peak_gib']:.3f} GiB "
        f"from {row['held_gib']:.3f} GiB held; metrics offloaded "
        f"{row['offloaded_bytes'] / 1e9:.3f} GB")
    hist = {}
    for use_pallas, cpcs in ((False, (1, 2)), (True, (1,))):
        for lrow in loop_graph_build.run(
                "seamount", 64, 64, 64, cpcs=cpcs, cycles=LOOP_CYCLES,
                reps=LOOP_REPS, use_pallas=use_pallas, device=dev,
                setup=case_seamount):
            cpc = lrow["cycles_per_check"]
            if not use_pallas:
                hist[cpc] = lrow["history"]
            st, lp, lc = (lrow["step"], lrow["loop"],
                          lrow["loop_captured"])
            print(f"  seamount 64^3{' use_pallas' * use_pallas}, "
                  f"cycles_per_check {cpc}: step {st['nodes']} nodes (capture"
                  f" {st['capture_s']:.3f} s, instantiation "
                  f"{st['instantiate_s']:.3f} s); device loop body "
                  f"{lp['body_nodes']} nodes, cloned in {lp['clone_s']:.3f} "
                  f"s, instantiated in {lp['instantiate_s']:.3f} s (captured "
                  f"into the body instead: {lc['capture_s']:.3f} s + "
                  f"{lc['instantiate_s']:.3f} s); solve of {LOOP_CYCLES} "
                  f"F-cycles: device loop {lrow['device_loop_wall_s']:.4f} s,"
                  f" replayed host loop {lrow['replay_wall_s']:.4f} s "
                  f"(medians of {LOOP_REPS}); "
                  f"history {['%.6e' % h for h in lrow['history']]}")
    check(len(hist[2]) == LOOP_CYCLES // 2 + 1 and all(
        h == hist[1][2 * k] for k, h in enumerate(hist[2])),
        f"cycles_per_check 2 {hist[2]} against 1 {hist[1]}")
    print("  hist_cpc2[k] == hist_cpc1[2k] for every k, exactly")
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts


# ------------------------------------------------------ phases 20-23

def cuc_land_mask(ny, nx):
    """Phase 20's land: the western 2 % of the columns (the synthetic
    slope's shelf side, x < 0.35) and a 16 x 16 island mid-domain
    (rmask 0 on land)."""
    rmask = np.ones((ny, nx))
    rmask[:, :max(1, round(0.02 * nx))] = 0.0
    j0, i0 = ny // 2 - 8, nx // 2 - 8
    rmask[j0:j0 + 16, i0:i0 + 16] = 0.0
    return rmask


def water_interior(rmask):
    """The water columns 2 cells off the walls and eroded twice off the
    land (tests/test_bmask.py's criterion)."""
    from scipy.ndimage import binary_erosion
    water = rmask > 0.5
    interior = np.zeros_like(water)
    interior[3:-3, 3:-3] = True
    return binary_erosion(water, iterations=2) & interior


def masked_kernels(dev, results):
    """Phase 1, last part: the kernels on a land-masked operator, the
    level-0 operator of CUC 128^2 x 32 with bmask and cuc_land_mask's
    land.  K4 (one sweep) on the band stack in float32 and float64 and on
    its bfloat16 copy with consistent pivots; K3 in its three modes and
    K1-K2 on every colour (K1 also on the bfloat16 operator where it has
    an instance), on the band stack and on the gather blocks: each held
    to its plain version to 0 ulp, untimed."""
    nx = ny = 128
    nz = 32
    case = setup_cuc_synthetic(nx, ny, nz)
    rmask = cuc_land_mask(ny, nx)
    for dtype in (torch.float32, torch.float64):
        m = NHModel(nx, ny, nz, cfg=SolverConfig(
            dtype=str(dtype).split(".")[1], bmask=True), device=dev)
        m.set_matrices(case.dx, case.dy, case.zeta, case.h, rmask=rmask,
                       hc=case.hc, theta_b=case.theta_b,
                       theta_s=case.theta_s)
        cA = m.ops[0].cA
        del m
        g = torch.Generator(device=dev).manual_seed(23)
        q = rc.split_quads(torch.randn((nz, ny, nx), generator=g,
                                       dtype=dtype, device=dev))
        bq = rc.split_quads(torch.randn((nz, ny, nx), generator=g,
                                        dtype=dtype, device=dev))
        e = rc.extend_quads(q)
        e4 = tuple(e[k] for k in rc._TKEYS)
        scale = max(float(x.abs().max()) for x in bq.values())
        for layout in ("bands", "blocks"):
            base = (rc.build_band_pack if layout == "bands"
                    else rc.build_compact_pack)(cA, True)
            for lp in (False, True):
                if lp and dtype == torch.float64 and layout == "blocks":
                    continue        # no bfloat16 blocks for float64 state
                pack = rc.attach_lp(base) if lp else base
                label = f"masked {layout}" + (" bf16" if lp else "")
                if layout == "bands":
                    _, _, band = ksf.sweep_bands(pack, dtype)
                    hold(results, ksf.ENTRIES[(dtype, band)][1], label,
                         dtype, lambda: ksf.relax_fused_sweep(q, bq, pack, 1),
                         lambda: ksf.relax_fused_sweep_plain(q, bq, pack, 1),
                         None, 0, 0, None, exact=True)
                band = torch.bfloat16 if lp else dtype
                if (dtype, band) in kt.COLOUR_ENTRIES:
                    k1 = "color_update_bf16" if lp else "color_update"
                    for colour in COLOURS:
                        hold(results, k1, f"{label} {colour}", dtype,
                             lambda c=colour: _stk(kt.color_update(
                                 e, bq, pack, c)),
                             lambda c=colour: _stk(kt.color_update_plain(
                                 e, bq, pack, c)), None, 0, 0, None,
                             exact=True)
                if lp:
                    continue
                for colour in rc.colour_targets("RB"):
                    hold(results, "color_update_emit", f"{label} {colour}",
                         dtype,
                         lambda c=colour: tuple(_stk(d) for d in
                                                kt.color_update_emit(
                                                    e, bq, pack, c)),
                         lambda c=colour: tuple(_stk(d) for d in
                                                kt.color_update_emit_plain(
                                                    e, bq, pack, c)),
                         scale, 0, 0, None, exact=True)
                for mode, targets in (("coarse", rc._TKEYS),
                                      ("residual", rc._TKEYS),
                                      ("zsum", ((0, 0), (1, 1)))):
                    name = ("residual_quads" if mode == "residual"
                            else "residual_restrict")
                    hold(results, name, f"{label} {mode}", dtype,
                         lambda mo=mode, tg=targets: kt.residual_restrict(
                             e4, bq, pack, mo, tg),
                         lambda mo=mode, tg=targets: kt.residual_restrict_plain(
                             e4, bq, pack, mo, tg), scale, 0, 0, None,
                         exact=True)
        del cA, q, bq, e, e4
        torch.cuda.empty_cache()


def rhs_kernels(dev, results):
    """Phase 1, physics: the one-pass divergence RHS (rhs_fused) against
    compute_rhs on the card, to 0 ulp: CUC 1024^2 x 64 float32 (the
    model's metrics, zw a view of the halo-2 field; the drivers' field and
    a seeded random one), timed beside its bound (every input read once,
    b written once); the land-masked CUC 128^2 x 32 with bmask, and
    without, in float32 and float64."""
    def velocities(nz, ny, nx, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(s, generator=g, dtype=dtype, device=dev)
                     for s in ((nz, ny + 2, nx + 1), (nz, ny + 1, nx + 2),
                               (nz + 1, ny + 2, nx + 2)))

    n, nz = 1024, 64
    case = setup_cuc_synthetic(n, n, nz)
    m = NHModel(n, n, nz, cfg=SolverConfig(dtype="float32"), device=dev)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    mt = m.metrics
    del m
    walls = wall_face_masks(n, n, mt.dx)
    for label, uvw in (
            ("drivers' field", initial_velocities(n, n, nz,
                                                  dtype=torch.float32,
                                                  device=dev)),
            ("random field", velocities(nz, n, n, torch.float32, 29))):
        read = nbytes(*uvw, mt.dx, mt.dy, mt.dzw, mt.zx, mt.zy, mt.cw,
                      mt.umask, mt.vmask, mt.rmask, *walls) + (
            mt.zw.numel() * mt.zw.element_size())
        hold(results, "rhs_fused", f"CUC {label}", torch.float32,
             lambda: krhs.rhs_fused(mt, *uvw, False),
             lambda: compute_rhs(mt, *uvw, False), None,
             read + n * n * nz * 4, 0,
             "json" if label == "random field" else None, exact=True)
    del mt, uvw, walls
    torch.cuda.empty_cache()
    n, nz = 128, 32
    case = setup_cuc_synthetic(n, n, nz)
    for dtype in (torch.float32, torch.float64):
        for bmask in (False, True):
            m = NHModel(n, n, nz, cfg=SolverConfig(
                dtype=str(dtype).split(".")[1], bmask=bmask), device=dev)
            m.set_matrices(case.dx, case.dy, case.zeta, case.h,
                           rmask=cuc_land_mask(n, n) if bmask else None,
                           hc=case.hc, theta_b=case.theta_b,
                           theta_s=case.theta_s)
            uvw = velocities(nz, n, n, dtype, 31)
            hold(results, "rhs_fused", "masked" if bmask else "walls",
                 dtype, lambda: krhs.rhs_fused(m.metrics, *uvw, bmask),
                 lambda: compute_rhs(m.metrics, *uvw, bmask), None, 0, 0,
                 None, exact=True)
            del m


def record(m, info, fcycle, prof):
    """A phase's numbers for the comparisons of phases 20-21: F-cycles,
    medians (eager, replayed), the captured step's node count, the eager
    and replayed traces' (ops, busy ms, idle share)."""
    graphs = list(m.backend.graphs.values())
    return dict(niter=info.niter, eager_ms=fcycle[0], replay_ms=fcycle[1],
                nodes=graphs[0].nodes if graphs else None,
                eager=prof["eager"], replay=prof["replay"])


def print_beside(label, rec, phase4):
    """One phase's record beside phase 4's."""
    for key, name in (("niter", "F-cycles to 1e-4"),
                      ("eager_ms", "F-cycle median eager (ms)"),
                      ("replay_ms", "F-cycle median replayed (ms)"),
                      ("nodes", "captured step graph nodes")):
        print(f"  {name}: {rec[key]} {label}, {phase4[key]} phase 4")
    for key in ("eager", "replay"):
        (n, busy, idle), (n4, busy4, idle4) = rec[key], phase4[key]
        print(f"  {key} trace: {n} device ops, busy {busy:.3f} ms, idle "
              f"share {idle:.4f} {label}; {n4} ops, busy {busy4:.3f} ms, "
              f"idle share {idle4:.4f} phase 4")


def bmask_phase(case, dev, phase4):
    """Phase 20: CUC 1024^2 x 64 float32 with bmask and cuc_land_mask's
    land (module docstring).  Returns the launch counts."""
    print("== phase 20: CUC 1024^2 x 64 float32, bmask=True (coastal strip "
          "over the western 2 % of the columns, a 16 x 16 island)")
    t0 = time.perf_counter()
    rmask = cuc_land_mask(1024, 1024)
    print(f"  land columns {int((rmask < 0.5).sum())} of {rmask.size}")
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(
        1024, 1024, 64, case, "float32", dev, tol=1e-4,
        maxiter=BMASK_MAXITER, rmask=rmask, water=water_interior(rmask),
        bmask=True)
    counts = launches()
    print(f"  launches {counts}")
    print(f"  F-cycles to 1e-4: {info.niter} with land masking (limit "
          f"{BMASK_MAXITER}), {phase4['niter']} in phase 4")
    check(info.res <= 1e-4 and info.niter <= BMASK_MAXITER,
          f"bmask: {info.res} after {info.niter} cycles")
    check(m.water_ratio <= 1e-2,
          f"interior water max|div| cut only to {m.water_ratio}")
    check_path(counts, {"relax_fused_sweep"} | K3)
    check_band_levels(m)
    rec = record(m, info, print_fcycle(m), profile_fcycle(m))
    print_beside("phase 20", rec, phase4)
    del m
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts


def direct_phase(case, dev, phase4):
    """Phase 21: CUC 1024^2 x 64 float32 with coarsest='direct' (module
    docstring).  Returns the launch counts and the history."""
    print("== phase 21: CUC 1024^2 x 64 float32, coarsest='direct'")
    t0 = time.perf_counter()
    reset_launches()
    m, info, ratio, inner, setup_s, _ = run_model(
        1024, 1024, 64, case, "float32", dev, tol=1e-4,
        maxiter=DIRECT_MAXITER, coarsest="direct")
    counts = launches()
    Ainv = m.ops[-1].Ainv
    s = m.levels[-1]
    print(f"  coarsest level {(s.nzg, s.nyg, s.nxg)}: dense inverse "
          f"{tuple(Ainv.shape)} {Ainv.dtype} ({nbytes(Ainv) / 2**20:.1f} "
          f"MiB), set-up {setup_s:.3f} s")
    print(f"  launches {counts}")
    check(info.res <= 1e-4 and info.niter <= DIRECT_MAXITER,
          f"direct: {info.res} after {info.niter} cycles")
    check(ratio <= 2.5e-2 and inner <= 1e-2,
          f"max|div| cut only to {ratio} (interior {inner})")
    check_path(counts, {"relax_fused_sweep"} | K3)
    check_band_levels(m)
    rec = record(m, info, print_fcycle(m), profile_fcycle(m))
    print_beside("phase 21", rec, phase4)
    del m, Ainv
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts, info.history


def pcr_phase(case_seamount, dev, seamount_history):
    """Phase 22: seamount 64^3 float32 with tridiag='pcr' (module
    docstring).  Returns the launch counts."""
    print("== phase 22: seamount 64^3 float32, tridiag='pcr'")
    t0 = time.perf_counter()
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(
        64, 64, 64, case_seamount, "float32", dev, tol=1e-4,
        maxiter=PCR_MAXITER, tridiag="pcr")
    counts = launches()
    print(f"  launches {counts}")
    print(f"  history {['%.6e' % h for h in info.history]} with PCR; phase "
          f"2 {['%.6e' % h for h in seamount_history]}")
    check(info.res <= 1e-4 and info.niter <= PCR_MAXITER,
          f"PCR: {info.res} after {info.niter} cycles")
    check(ratio <= 1e-2 and inner <= 1e-2,
          f"max|div| cut only to {ratio} (interior {inner})")
    check_path(counts, {"relax_fused_sweep"} | K3)
    check_band_levels(m)
    print_fcycle(m)
    del m
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")
    return counts


def small_phase(dev):
    """Phase 23: netcdf_output, gs_exact and testgalerkin at small sizes
    (module docstring)."""
    import tempfile
    from mgroms_tpu_torch.io.diagnostics import read_field
    print("== phase 23: netcdf_output (seamount 32^3), gs_exact (seamount "
          "8^3 float64), testgalerkin (seamount 64^3)")
    t0 = time.perf_counter()
    n = 32
    with tempfile.TemporaryDirectory() as out:
        m = NHModel(n, n, n, cfg=SolverConfig(
            dtype="float32", netcdf_output=True, output_dir=out), device=dev)
        c = setup_seamount(n, n, n)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        uvw = initial_velocities(n, n, n, dtype=m.dtype, device=dev)
        uc, vc, wc, p, info = m.solve(*uvw, tol=1e-4, maxiter=6)
        m.check_nondivergence(uc, vc, wc)
        files = sorted(os.listdir(out))
        want = ["dx_dx_0000_0001.nc", "dy_dy_0000_0001.nc",
                "zr_zr_0000_0001.nc", "zw_zw_0000_0001.nc",
                "b_b_0000_0001.nc", "p_end_p_0000.nc", "r_end_r_0000.nc",
                "p_p_0000_0001.nc", "check_b_0000_0001.nc"] + [
            f"cA_ca_0000_{lev:04d}.nc" for lev in range(1, len(m.levels) + 1)]
        missing = sorted(set(want) - set(files))
        print(f"  netcdf_output: {len(files)} files written, "
              f"{info.niter} F-cycles; missing {missing}")
        check(not missing, f"netcdf dumps missing: {missing}")
        pd = read_field(os.path.join(out, "p_end_p_0000.nc"), "p")
        check(np.array_equal(pd, p.cpu().numpy()),
              "p_end differs from the returned pressure")
        del m
    n = 8
    kw = dict(dtype="float64", relax_method="GS", gs_exact=True)
    hist = {}
    for d in (dev, "cpu"):
        m = NHModel(n, n, n, cfg=SolverConfig(**kw), device=d)
        c = setup_seamount(n, n, n)
        m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc,
                       theta_b=c.theta_b, theta_s=c.theta_s)
        uvw = initial_velocities(n, n, n, device=d)
        if d != "cpu":
            try:
                m.solve(*uvw, tol=0.0, maxiter=1, graph=True)
                check(False, "gs_exact accepted graph=True")
            except ValueError:
                pass
        *_, p, info = m.solve(*uvw, tol=0.0, maxiter=2)
        check(not m.backend.graphs, "gs_exact captured a graph")
        hist[str(d)] = (info.history, p.cpu(), info.time_s)
    (hc, pc, tc), (hh, ph, th) = hist[str(dev)], hist["cpu"]
    rel = max(abs(a / b - 1) for a, b in zip(hc, hh))
    perr = float((pc - ph).abs().max() / ph.abs().max())
    print(f"  gs_exact 8^3 float64: history {['%.6e' % h for h in hc]} on "
          f"the card ({tc:.2f} s), max rel deviation from the CPU's {rel:.3e}"
          f", pressure {perr:.3e} (CPU {th:.2f} s); graph=True refused")
    check(rel <= 1e-12 and perr <= 1e-12, "gs_exact differs from the CPU")
    n = 64
    m = NHModel(n, n, n, cfg=SolverConfig(dtype="float32"), device=dev)
    c = setup_seamount(n, n, n)
    m.set_matrices(c.dx, c.dy, c.zeta, c.h, hc=c.hc, theta_b=c.theta_b,
                   theta_s=c.theta_s)
    norm_c, norm_f, ratio = testgalerkin(m.backend, 1, m.cfg)
    _, _, ratio_r = testgalerkin(m.backend, 1, m.cfg, field="random")
    print(f"  testgalerkin seamount 64^3 level 1: <p, A_c p> {norm_c:.6e}, "
          f"<Pp, A_f Pp> {norm_f:.6e}, ratio {ratio:.4f} (smooth), "
          f"{ratio_r:.4f} (random)")
    check(3.0 < ratio < 5.0, f"Galerkin ratio {ratio}")
    reset_launches()
    b = analytic_rhs.rhs_seamount(n, n, n, dtype=m.dtype, device=dev)
    _, info = m.pressure_solve(b, tol=1e-4, maxiter=6)
    counts = launches()
    print(f"  rhs_seamount (the dipole) on that model: history "
          f"{['%.4e' % h for h in info.history]}, launches {counts}")
    check(info.res <= 1e-4, f"dipole solve stopped at {info.history}")
    check_path(counts, {"relax_fused_sweep"} | K3)
    g = torch.Generator(device=dev).manual_seed(23)
    inner = [torch.randn(shape, generator=g, dtype=m.dtype, device=dev)
             for shape in ((n, n, n + 1), (n, n + 1, n), (n + 1, n, n))]
    uvw = velocity.velocities_from_interior(*inner)
    filled = velocity.fill_velocity_halos(*uvw)
    check(all(torch.equal(a, b) for a, b in zip(filled, uvw)),
          "fill_velocity_halos changed velocities_from_interior's output")
    print("  velocities_from_interior then fill_velocity_halos: equal to "
          "the first call's output")
    del m
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")


def rndtopo_phase(dev):
    """Phase 24: drivers.rndtopo at the reference driver's 64^3 in float32
    on the card, --tol 1e-4 --maxiter 8 --profile (module docstring).  The
    driver's output is printed as it gave it."""
    import contextlib
    import io
    import tempfile
    from mgroms_tpu_torch.drivers import rndtopo
    from mgroms_tpu_torch.utils import tictoc
    print("== phase 24: drivers.rndtopo 64^3 float32, --tol 1e-4 --maxiter 8 "
          "--profile")
    t0 = time.perf_counter()
    n, maxiter = 64, 8
    tictoc.reset_tictoc()
    reset_launches()
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        m, info = rndtopo.main(["--nx", str(n), "--ny", str(n), "--nz",
                                str(n), "--tol", "1e-4", "--maxiter",
                                str(maxiter), "--profile", "--history",
                                os.path.join(tmp, "history.txt")])
    text = out.getvalue()
    print("\n".join("  | " + line for line in text.splitlines()))
    counts = launches()
    print(f"  launches (solve, check, profile) {counts}")
    check(info.res <= 1e-4 and info.niter <= maxiter,
          f"rndtopo: {info.res} after {info.niter} cycles")
    check(len(m.backend.graphs) == 1, "the solve replayed no captured step")
    step = next(iter(m.backend.graphs.values()))
    check_path(collections.Counter(step.launches), {"relax_fused_sweep"} | K3)
    check_path(counts, {"relax_fused_sweep"} | K3)
    L = len(m.levels)
    rows = {int(line.split()[0]) for line in text.splitlines()
            if line.strip()[:1].isdigit() and "s/" in line}
    print(f"  tictoc table rows for levels {sorted(rows)} of {L}")
    check(rows == set(range(L)), f"tictoc rows {sorted(rows)}, {L} levels")
    uvw = initial_velocities(n, n, n, dtype=m.dtype, device=dev)
    uc, vc, wc, _, rinfo = m.solve(*uvw, tol=1e-4, maxiter=maxiter)
    *_, einfo = m.solve(*uvw, tol=1e-4, maxiter=maxiter, graph=False)
    check(rinfo.history == info.history == einfo.history,
          f"replayed {rinfo.history} / eager {einfo.history} / driver "
          f"{info.history}")
    div0 = float(m.rhs(*uvw).abs().max())
    inner = float(m.rhs(uc, vc, wc)[:, 2:-2, 2:-2].abs().max()) / div0
    print(f"  history {['%.4e' % h for h in info.history]}, replayed equal "
          f"to eager; interior max|div| ratio {inner:.3e}; step kernels "
          f"{dict(step.launches)}")
    check(inner <= 1e-2, f"interior max|div| cut only to {inner}")
    tictoc.reset_tictoc()
    del m
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")


def offload_phase(case, dev, history21):
    """Phase 25: offload_metrics and scripts/profile_cuc.py on CUC 1024^2 x
    64 float32 with coarsest='direct' (module docstring); ``history21`` is
    phase 21's."""
    print("== phase 25: CUC 1024^2 x 64 float32, coarsest='direct': "
          "offload_metrics, then scripts/profile_cuc.py")
    t0 = time.perf_counter()
    nx, ny, nz = 1024, 1024, 64
    m = NHModel(nx, ny, nz, cfg=solve_wall.CONFIG, device=dev)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    uvw = initial_velocities(nx, ny, nz, dtype=m.dtype, device=dev)
    b = m.rhs(*uvw)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    t1 = time.perf_counter()
    moved = m.offload_metrics()
    t2 = time.perf_counter()
    freed = held - torch.cuda.memory_allocated(dev)
    print(f"  offload_metrics: {moved} B moved to pinned host memory in "
          f"{t2 - t1:.3f} s, device memory allocated {held} -> "
          f"{held - freed} B ({freed / 1e9:.4f} GB back, limit "
          f"{OFFLOAD_MIN_BYTES / 1e9:.2f})")
    check(freed >= OFFLOAD_MIN_BYTES, f"offload_metrics gave back {freed} B")
    t1 = time.perf_counter()
    check(torch.equal(m.rhs(*uvw), b), "rhs after offload_metrics differs")
    print(f"  the next rhs (metrics back in {time.perf_counter() - t1:.3f} s)"
          " equal bit for bit to the one before")
    m.offload_metrics()
    reset_launches()
    _, info = m.pressure_solve(b, tol=1e-4, maxiter=DIRECT_MAXITER)
    counts = launches()
    print(f"  replayed solve after the offload: history "
          f"{['%.6e' % h for h in info.history]}, phase 21 "
          f"{['%.6e' % h for h in history21]}; launches {counts}")
    check(info.history == history21, "history differs from phase 21's")
    check(m._metrics_offloaded, "the solve brought the metrics back")
    check_path(counts, {"relax_fused_sweep"} | K3)
    del b
    row = profile_cuc.run(nx, ny, nz, iters=5, device=dev, model=m)
    L = len(m.levels)
    keys = {(r["lev"], r["op"]) for r in row["rows"]}
    missing = sorted(({(lev, "relax") for lev in range(L)}
                      | {(lev, "prolong") for lev in range(L - 1)}) - keys)
    check(not missing, f"profile_cuc rows missing {missing}")
    prof = profile_fcycle(m)
    busy = prof["replay"][1]
    total = row["device_ms_sum"]
    # the upper limit is the replayed F-cycle's, 1.25 x its busy time: a
    # re-timing that measured the host's enqueue (1.0-1.24 x the eager
    # F-cycle) passes 1.25 x the eager median but not this
    lo, hi = 0.9 * busy, 1.25 * busy
    hi_eager = 1.25 * row["fcycle_ms_eager"]
    print(f"  profile_cuc device-time sum {total:.3f} ms; replayed F-cycle "
          f"traced device busy {busy:.3f} ms, eager F-cycle median "
          f"{row['fcycle_ms_eager']:.3f} ms (replayed median "
          f"{row['fcycle_ms_replay']:.3f} ms): limits [{lo:.3f}, {hi:.3f}] "
          f"(0.9 and 1.25 x busy; {total / hi:.3f} of the upper), 1.25 x "
          f"eager {hi_eager:.3f} ({total / hi_eager:.3f} of it)")
    check(lo <= total <= min(hi, hi_eager),
          f"device-time sum {total} outside [{lo}, {min(hi, hi_eager)}]")
    for r in row["rows"]:
        print(f"  level {r['lev']} {r['op']:<24s} {r['calls']:3d} calls "
              f"re-timed {r['ms']:9.4f} ms, eager pass device "
              f"{r['eager_device_ms']:9.4f} ms, host {r['eager_host_ms']:9.4f}"
              " ms")
    del m
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")


# The routing of phase 26: on a virtual 2x2 mesh a level is sharded while
# its tiles stay >= nsmall (8) wide.  (a) CUC 1024^2 x 64 with
# compact=False: every level sharded (tiles 512 .. 16), no quad level, so
# comm='auto' resolves to GSPMD; each relax is K6 on the level gathered
# onto the card, in the form and number phase 7 launches; K5 is vetoed on
# sharded levels (the per-tile plain residual instead).  (b) seamount 64^3
# default config, comm='gspmd': levels 0-2 sharded (tiles 32, 16, 8),
# full layout, plain torch per tile; levels 3-4 replicated, where level 3
# keeps its quads and its band stack: K4 (ns_pre + ns_post launches in each
# V-cycle that reaches it) and K3 (once in each), :func:`replicated_quads`.
# Its reference is the single-device solve with the same layout (levels 0-2
# in full layout: :func:`layout_reference`), whose pressure it gives bit
# for bit; against phase 2 (every level but the coarsest in quads, K4 on
# levels 0-3) its float32 history deviates by the quads' other rounding
# (3.9e-4 at the float32 floor, ~3.6e-5, on the H100), held to 1e-3 as
# phase 7's against phase 4.
GSPMD_SCALING = dict(grid=128, nz=64)


def layout_reference(case, dev, grid, full_levels, tol, maxiter):
    """The single-device float32 solve of ``case`` with levels
    ``full_levels`` in full layout (their packs dropped: the masked relax
    and the full-layout residual, as a GSPMD backend runs its sharded
    levels), eagerly: (SolveInfo, pressure)."""
    nx, ny, nz = grid
    m = NHModel(nx, ny, nz, cfg=SolverConfig(dtype="float32"), device=dev)
    m.set_matrices(case.dx, case.dy, case.zeta, case.h, hc=case.hc,
                   theta_b=case.theta_b, theta_s=case.theta_s)
    for lev in full_levels:
        m.backend.packs[lev] = None
    u, v, w = initial_velocities(nx, ny, nz, dtype=m.dtype, device=dev)
    p, info = m.pressure_solve(m.rhs(u, v, w), tol=tol, maxiter=maxiter,
                               graph=False)
    return info, p


def replicated_quads(m) -> collections.Counter:
    """K4's and K3's launches a F-cycle on the replicated quad levels of a
    GSPMD backend: level lev < L-1 is in lev + 1 of a F-cycle's V-cycles,
    each ns_pre + ns_post K4 launches and one K3 (its down-leg)."""
    be, cfg = m.backend, m.cfg
    out = collections.Counter()
    for lev in range(be.nlevs - 1):
        if be.state_quads(lev) and not be.plan.shards[lev].sharded:
            out["relax_fused_sweep"] += (lev + 1) * (cfg.ns_pre + cfg.ns_post)
            out["residual_restrict"] += lev + 1
    return out


def gspmd_phase(case, case_seamount, dev, ref7, p7, ref2):
    """Phase 26: the GSPMD comm layer on a virtual 2x2 mesh of the card —
    (a) CUC as phase 7 under comm='auto', (b) seamount 64^3 under
    comm='gspmd' (the routing above), (c) scripts/scaling.run_one at
    GSPMD_SCALING on 1x1 and 2x2 under both layers.  Each part prints its
    F-cycle ms (CUDA events), traced idle share and wall time."""
    from mgroms_tpu_torch.parallel import DistributedBackend
    from mgroms_tpu_torch.scripts import scaling
    print("== phase 26a: CUC 1024^2 x 64 float32, use_pallas=True, "
          "compact=False, distribute(2, 2, comm='auto') -> GSPMD, a virtual "
          "mesh of one card")
    t0 = time.perf_counter()
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(
        1024, 1024, 64, case, "float32", dev, tol=1e-4, maxiter=8,
        mesh=(2, 2), comm="auto", use_pallas=True, compact=False)
    counts = launches()
    be = m.backend
    print(f"  backend {type(be).__name__}, launches {counts}")
    check(type(be) is DistributedBackend, "auto did not resolve to GSPMD")
    check(all(s.sharded for s in be.plan.shards)
          and all(be._gathered(lev) for lev in range(be.nlevs)),
          "a level is not sharded, or relaxes per tile")
    k6 = k6_expected(m)
    print(f"  K6 launches a F-cycle by form (the gate): {dict(k6)}")
    check_path(counts, set(k6))
    for name, n in k6.items():
        check(counts[name] == n * info.niter,
              f"K6 {name} {counts[name]} times, expected {n} a F-cycle")
    n = min(len(info.history), len(ref7))
    dev_rel = max(abs(a / b - 1) for a, b in zip(info.history[:n], ref7[:n]))
    p_dev = float((m.p_solved.cpu() - p7).abs().max() / p7.abs().max())
    print(f"  history vs phase 7: max rel deviation {dev_rel:.3e} over {n} "
          f"entries (limit {REL_TOL}); pressure max|p26a - p7| / max|p7| = "
          f"{p_dev:.3e}")
    check(info.res <= 1e-4, f"{info.res} after {info.niter} cycles")
    check(dev_rel <= REL_TOL, f"history {info.history} vs phase 7 {ref7}")
    check(ratio <= 2.5e-2 and inner <= 1e-2,
          f"max|div| cut only to {ratio} (interior {inner})")
    print_fcycle(m)
    profile_fcycle(m, warm=False)
    del m, be
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")

    print("== phase 26b: seamount 64^3 float32, distribute(2, 2, "
          "comm='gspmd')")
    t0 = time.perf_counter()
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(
        64, 64, 64, case_seamount, "float32", dev, tol=1e-4, maxiter=6,
        mesh=(2, 2), comm="gspmd")
    counts = launches()
    be = m.backend
    want = replicated_quads(m)
    print(f"  launches {counts}; predicted a F-cycle {dict(want)}")
    check([s.sharded for s in be.plan.shards] == [True] * 3 + [False] * 2,
          "seamount 64^3 on 2x2 shards other levels than levels 0-2")
    check({k: v for k, v in counts.items() if v and k not in PHYSICS}
          == {k: v * info.niter for k, v in want.items()},
          f"launches {counts}, predicted {dict(want)} a F-cycle")
    sharded = [lev for lev in range(be.nlevs) if be.plan.shards[lev].sharded]
    iref, pref = layout_reference(case_seamount, dev, (64, 64, 64), sharded,
                                  1e-4, 6)
    rel = lambda h, r: max(abs(a / b - 1) for a, b in zip(h, r))
    n = min(len(info.history), len(iref.history))
    dev_ref = rel(info.history[:n], iref.history[:n])
    p_dev = float((m.p_solved - pref).abs().max() / pref.abs().max())
    n2 = min(len(info.history), len(ref2))
    dev2 = rel(info.history[:n2], ref2[:n2])
    print(f"  history vs the single-device solve with levels {sharded} in "
          f"full layout: max rel deviation {dev_ref:.3e} over {n} entries "
          f"(limit {REL_TOL}), pressure max|p26b - p_ref| / max|p_ref| = "
          f"{p_dev:.3e} (limit 0); vs phase 2: {dev2:.3e} over {n2} entries "
          "(limit 1e-3)")
    check(info.res <= 1e-4, f"{info.res} after {info.niter} cycles")
    check(dev_ref <= REL_TOL and p_dev == 0.0,
          f"history {info.history} vs the reference {iref.history}")
    check(dev2 <= 1e-3, f"history {info.history} vs phase 2 {ref2}")
    check(ratio <= 1e-2 and inner <= 1e-2,
          f"max|div| cut only to {ratio} (interior {inner})")
    print_fcycle(m, reps=2)
    profile_fcycle(m, warm=False)
    del m, be
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")

    g, nz = GSPMD_SCALING["grid"], GSPMD_SCALING["nz"]
    print(f"== phase 26c: scripts/scaling.run_one, seamount {g}^2 x {nz} "
          "float32, coarsest='direct', 1x1 and a virtual 2x2 mesh under "
          "both layers")
    t0 = time.perf_counter()

    def probe(step):
        # the step is warm: run_one timed it
        n_ops, busy, wall, _ = trace(step, warm=False)
        return n_ops, busy, 1 - busy / wall

    base = scaling.run_one(g, g, nz, 1, 1, "float32", device=dev,
                           probe=probe)
    rows = {"1x1": base}
    for comm in ("gspmd", "shard_map"):
        rows[comm] = scaling.run_one(g, g, nz, 2, 2, "float32", comm=comm,
                                     device=dev, probe=probe)
    for key, row in rows.items():
        print(f"  {key:>9} {row.backend}: {row.t * 1e3:.3f} ms a F-cycle "
              f"eager (CUDA events, mean of {scaling.REPS})"
              + (f", {row.replay * 1e3:.3f} ms replayed" if row.replay
                 else "")
              + f", ovh {row.t / base.t:.3f}; per F-cycle {row.counts}; "
              f"traced: {row.probe[0]} device ops, busy {row.probe[1]:.3f} "
              f"ms, idle share {row.probe[2]:.4f}")
    check(rows["gspmd"].backend == "DistributedBackend"
          and rows["shard_map"].backend == "ShardMapBackend",
          "scaling.run_one built other backends")
    check(all(r.t > 0 for r in rows.values()) and base.replay
          and rows["gspmd"].counts["ppermute"] > 0
          and rows["shard_map"].counts["ppermute"] > 0,
          "scaling rows incomplete")
    torch.cuda.empty_cache()
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False); this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.BuildInfo.seconds:.2f} s) -> {_build.BuildInfo.path}")
    print(_build.BuildInfo.log.strip())

    print("== phase 1: kernels vs plain versions")
    kres = kernel_phase(dev)

    quad_k4 = {"relax_fused_sweep", "residual_restrict", "residual_quads"}
    print("== phase 2: seamount 64^3 float32")
    case_seamount = setup_seamount(64, 64, 64)
    with open(os.path.join(HERE, "tests", "goldens",
                           "seamount64_history.json")) as f:
        gold64 = json.load(f)["history"]
    reset_launches()
    m, info, ratio, inner, _, _ = run_model(64, 64, 64, case_seamount,
                                            "float32", dev, tol=1e-4,
                                            maxiter=6)
    counts = launches()
    print(f"  launches {counts}")
    check_band_levels(m)
    seamount_history = info.history
    check(abs(info.history[1] / gold64[1] - 1) <= 0.02,
          f"first cycle {info.history[1]} vs golden {gold64[1]}")
    check(info.res <= 1e-4 and info.niter <= 3,
          f"seamount: {info.res} after {info.niter} cycles")
    check_path(counts, quad_k4)
    check(ratio <= 1e-2 and inner <= 1e-2,
          f"seamount max|div| cut only to {ratio} (interior {inner})")
    print_fcycle(m)
    profile_fcycle(m)
    del m

    print("== phase 3: seamount 32^3 float64 vs the golden history")
    with open(os.path.join(HERE, "tests", "goldens",
                           "seamount32_history.json")) as f:
        gold32 = json.load(f)
    m, info, _, _, _, _ = run_model(32, 32, 32, setup_seamount(32, 32, 32),
                                    "float64", dev, tol=1e-12, maxiter=30)
    check(info.niter == gold32["niter"], f"niter {info.niter}")
    np.testing.assert_allclose(info.history, gold32["history"], rtol=1e-6,
                               atol=1e-15)
    del m

    print("== phase 4: CUC 1024^2 x 64 float32 (main path)")
    case = setup_cuc_synthetic(1024, 1024, 64)
    reset_launches()
    m, info, ratio, inner, setup_s, peak = run_model(
        1024, 1024, 64, case, "float32", dev, tol=1e-4, maxiter=8)
    counts = launches()
    print(f"  launches {counts}")
    cuc_history = info.history
    cuc_niter = info.niter
    check(info.res <= 1e-4, f"CUC: {info.res} after {info.niter} cycles")
    check_path(counts, quad_k4)
    check_band_levels(m)
    # K3: one launch per down-leg restriction, L (L - 1) / 2 an F-cycle;
    # in its residual mode the level-0 residual of solve_init and of each
    # F-cycle
    L = len(m.levels)
    print(f"  K3 launches: {counts['residual_restrict']} restrictions "
          f"({counts['residual_restrict'] / info.niter:g} a F-cycle), "
          f"{counts['residual_quads']} level-0 residuals")
    check(counts["residual_restrict"] == L * (L - 1) // 2 * info.niter
          and counts["residual_quads"] == 1 + info.niter,
          f"K3 launches {counts}")
    # the solve's rhs, check_nondivergence twice, the interior ratio's rhs
    check(counts["rhs_fused"] == 4, f"rhs_fused launches {counts}")
    # the whole-grid max sits on the wall ring, whose remnant is a property
    # of the reference's BC-in-halo discretization and grows with
    # resolution (JAX package = port: 3.7e-3 at 128^2 x 32, 7.2e-3 at
    # 256^2 x 32; 1.44e-2 here on the H100); the interior is held to the
    # 100x cut, the whole grid near its measured ratio, so a fault in the
    # emitted residual's ring patches still fails
    check(inner <= 1e-2, f"CUC interior max|div| cut only to {inner}")
    check(ratio <= 2.5e-2, f"CUC whole-grid max|div| cut only to {ratio}")
    phase4 = record(m, info, print_fcycle(m), profile_fcycle(m))
    del m
    torch.cuda.empty_cache()
    phase_counts = {4: counts}

    cuc = ((1024, 1024, 64), case, dev)
    perf = dict(fused_bands_bf16=True, ns_pre=1, ns_post=1)
    phase_counts[5], _, _ = path_phase(
        "phase 5: seamount 64^3 float32, use_pallas=True", (64, 64, 64),
        case_seamount, dev, maxiter=3, ref=seamount_history, rtol=1e-6,
        div_limits=(1e-2, 1e-2), cfg=dict(use_pallas=True),
        busy=quad_k4)
    phase_counts[6], _, _ = path_phase(
        "phase 6: CUC 1024^2 x 64 float32, use_pallas=True", *cuc,
        maxiter=8, ref=cuc_history, rtol=1e-6, div_limits=(2.5e-2, 1e-2),
        cfg=dict(use_pallas=True), busy=quad_k4)
    phase_counts[7], info7, p7 = path_phase(
        "phase 7: CUC 1024^2 x 64 float32, use_pallas=True, compact=False",
        *cuc, maxiter=8, ref=cuc_history, rtol=1e-3,
        div_limits=(2.5e-2, 1e-2), cfg=dict(use_pallas=True, compact=False),
        busy={"residual_tiled"})
    phase_counts[8], info8, p8 = path_phase(
        "phase 8: CUC 1024^2 x 64 float32, pallas_fused_sweep=False", *cuc,
        maxiter=8, ref=cuc_history, rtol=1e-3, div_limits=(2.5e-2, 1e-2),
        cfg=dict(pallas_fused_sweep=False),
        busy={"color_update", "color_update_emit", "residual_restrict",
              "residual_quads"})
    phase_counts[9], info, _ = path_phase(
        "phase 9: CUC 1024^2 x 64 float32, perf mode (bfloat16 smoother "
        "blocks, V(1,1))", *cuc, maxiter=12, ref=cuc_history, rtol=None,
        div_limits=(2.5e-2, 1e-2), cfg=perf,
        busy={"relax_fused_sweep_bf16", "residual_restrict",
              "residual_quads"})
    print(f"  F-cycles to 1e-4: {info.niter} in perf mode, {cuc_niter} in "
          f"phase 4")
    phase_counts[10], info, _ = path_phase(
        "phase 10: seamount 64^3 float32, perf mode, pallas_fused_sweep="
        "False", (64, 64, 64), case_seamount, dev, maxiter=6,
        ref=seamount_history, rtol=None, div_limits=(1e-2, 1e-2),
        cfg=dict(perf, pallas_fused_sweep=False),
        busy={"color_update_bf16", "residual_restrict", "residual_quads"})
    print(f"  F-cycles to 1e-4: {info.niter} in perf mode, "
          f"{len(seamount_history) - 1} in phase 2")

    phase_counts[11] = micro_phase(dev)
    m, phase_counts[12] = distributed_phase(case, dev, info8.history,
                                            p8)
    del p8
    phase_counts[13] = overlap_phase(m, dev)
    del m
    torch.cuda.empty_cache()

    # the FC and GS orderings (relax_method) on CUC.  Cycle limits from the
    # port's CPU runs of the synthetic CUC slope in float32 (128^2 x 32 and
    # 256^2 x 64): FC reaches 2.6e-5 / 5.2e-5 in one F-cycle on both paths,
    # as RB does (phase 4: one cycle here); 3 leaves room for this grid's
    # float32 floor
    phase_counts[14], info14, _ = path_phase(
        "phase 14: CUC 1024^2 x 64 float32, relax_method='FC'", *cuc,
        maxiter=FC_MAXITER, ref=None, rtol=None, div_limits=(2.5e-2, 1e-2),
        cfg=dict(relax_method="FC"),
        busy={"color_update", "residual_restrict", "residual_quads"})
    # compact=False: the full-layout sums round in another order than the
    # quads', as for phase 7 against phase 4
    phase_counts[15], _, _ = path_phase(
        "phase 15: CUC 1024^2 x 64 float32, relax_method='FC', "
        "use_pallas=True, compact=False", *cuc, maxiter=FC_MAXITER,
        ref=info14.history, rtol=1e-3, div_limits=(2.5e-2, 1e-2),
        cfg=dict(relax_method="FC", use_pallas=True, compact=False),
        busy={"residual_tiled"})
    phase_counts[16], info16, _ = path_phase(
        "phase 16: CUC 1024^2 x 64 float32, relax_method='GS', "
        "use_pallas=True", *cuc, maxiter=GS_CYCLES, ref=None, rtol=None,
        div_limits=(2.5e-2, 1e-2),
        cfg=dict(relax_method="GS", use_pallas=True),
        busy={"residual_tiled"},
        tol=0.0)
    h = info16.history
    factor = (h[0] / h[-1]) ** (1.0 / info16.niter)
    print(f"  GS: {info16.niter} F-cycle(s), mean factor {factor:.3f}")
    check(all(b < a for a, b in zip(h, h[1:])) and factor >= 2.0,
          f"GS F-cycles do not each cut the residual 2x on the mean: {h}")

    phase_counts[17] = f64_phase(case, case_seamount, dev)
    refine_phase(dev)
    phase_counts[19] = loop_phase(case, case_seamount, dev)
    phase_counts[20] = bmask_phase(case, dev, phase4)
    phase_counts[21], history21 = direct_phase(case, dev, phase4)
    phase_counts[22] = pcr_phase(case_seamount, dev, seamount_history)
    small_phase(dev)
    rndtopo_phase(dev)
    offload_phase(case, dev, history21)
    gspmd_phase(case, case_seamount, dev, info7.history, p7,
                seamount_history)
    del p7

    for name, (src, _, phase) in KERNELS.items():
        print(f"  {name}: {phase_counts[phase][name]} launches in phase "
              f"{phase}, source {src}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=CSRC + src, replaces=replaces,
             launches=phase_counts[phase][name], **kres[name])
        for name, (src, replaces, phase) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
