"""K6: masked line smoothing of a whole full-layout level in any of the
three orderings, its hand-written CUDA kernel and its plain torch version.

Port of ``mgroms_tpu/ops/pallas/relax_fused.py:fused_relax``: ``nsweeps``
sweeps of ``ncolor`` colour steps (:data:`KINDS`: 'RB' two parity
colours, 'FC' four, 'GS' one all-ones step, the JAX package's
column-Jacobi GS), each committing ``p + mask * (sol - p)``.  The kernel
(``csrc/relax_fused.cu``) has three forms; :func:`form` names the one a
level takes from its shape, dtype and ordering alone:

  ``block``    one launch per call, one block holding the level (its
               state in shared memory, each column's coefficients,
               Thomas factors and b computed once and held by its thread):
               the coarsest level of every cell;
  ``cluster``  the same in a thread block cluster of up to 16 blocks, a
               band of rows each, the rows next to a band read from the
               neighbour block's shared memory, the records in registers
               (float32 at nz 2 or 4 only; any other level is refused):
               CUC level 4 in RB and FC;
  ``step``     one launch per colour step (larger levels), a thread per
               column of the step's colour; RB and FC update a copy of
               ``p`` in place, GS ping-pongs.

``LAUNCHES`` counts the kernel launches of each form and ordering under
the names of :data:`KINDS`: RB under the form's name, FC and GS under it
with ``_fc`` / ``_gs`` added.
The wrapper runs the plain version for tensors on the CPU only; for a CUDA
tensor it checks device, dtype, shape and contiguity, launches the kernel
or raises (a cluster the card cannot schedule raises too).  The TPU's
VMEM gate (``fits_vmem``) has no counterpart: the step form takes any
level.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...bc import extend_h1
from .. import relax as relax_ops
from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr

FORMS = ("step", "block", "cluster")     # the kernel's form codes


class Kind(NamedTuple):
    """One ordering: the kernel's code for it (relax_fused.cu), its
    colour steps per sweep, and the ``LAUNCHES`` names of its one-block,
    cluster and per-step forms."""
    code: int
    ncolor: int
    block: str
    cluster: str
    step: str

    def name(self, form_: str) -> str:
        return getattr(self, form_)


KINDS = {kind: Kind(code, ncolor, f"fused_relax{sfx}",
                    f"fused_relax_cluster{sfx}", f"fused_relax_step{sfx}")
         for kind, code, ncolor, sfx in (("RB", 0, 2, ""), ("FC", 1, 4, "_fc"),
                                         ("GS", 2, 1, "_gs"))}

LAUNCHES = {k.name(f): 0 for k in KINDS.values() for f in FORMS}
# the kernel functions behind each count (ops/kernels/__init__.py):
# relax_resident<T, KIND, NZ, CLUSTER> (one-block and cluster forms),
# relax_step<T, KIND> (a launch a colour step)
GRAPH_NAMES = tuple(
    pair for k in KINDS.values() for pair in (
        (rf"\brelax_resident<\w+, {k.code}, -?\d+, true>", k.cluster),
        (rf"\brelax_resident<\w+, {k.code}, -?\d+, false>", k.block),
        (rf"\brelax_step<\w+, {k.code}>", k.step)))

# the H100's shared memory and threads a block; the cluster form's blocks
# (16, non-portable; 8 where 16 cannot be resident)
SMEM_BYTES = 232448
MAX_THREADS = 1024
CLUSTER_BLOCKS = (16, 8)
# the nz at which each thread holds its columns' records in registers
# (csrc/relax_fused.cu plan_resident), and the most threads a block of
# that kernel has in float32 (max_threads): the only plans the cluster
# form takes
REGISTER_THREADS = {2: 512, 4: 256}
# the gate's thresholds, from the card's timings of the three forms at the
# levels of seamount 64^3 and CUC 1024^2 x 64 (PERF.md,
# scripts/micro_relax_fused.py): the points (nz * ny * nx) of the largest
# level each one-launch form takes.  GS solves every column a step and
# beats the step form in one launch only at the coarsest levels (nz 2, 4:
# CUC level 5, seamount level 4); at 8^3 and CUC level 4 the step form
# wins, so GS takes one block only at nz 2 or 4 and never the cluster
BLOCK_POINTS = 2 * 32 * 32
CLUSTER_POINTS = 4 * 64 * 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fits(shape, itemsize: int, nblocks: int,
         max_threads: int = MAX_THREADS) -> bool:
    """Whether ``nblocks`` blocks of a one-launch form hold a level of
    ``shape``: a thread per two columns of the largest band of rows (FC:
    per two colours of a row pair), at most ``max_threads``, and in
    shared memory two state buffers, the plane-0 snapshot and the forward
    values of two columns a thread (the most any ordering takes)."""
    nz, ny, nx = shape
    rows = -(-ny // nblocks)
    threads = (rows + 1) // 2 * 2 * ((nx + 1) // 2)
    smem = (2 * nz * rows * nx + rows * nx + 2 * nz * threads) * itemsize
    return nblocks <= ny and threads <= max_threads and smem + 64 <= SMEM_BYTES


def cluster_takes(shape, dtype) -> bool:
    """Whether the cluster form takes a level of ``shape`` and ``dtype``:
    float32 at an nz of :data:`REGISTER_THREADS`, the records in
    registers in a cluster of 16 blocks and of 8."""
    nz, ny, _ = shape
    return (dtype == torch.float32 and nz in REGISTER_THREADS
            and all(fits(shape, 4, min(n, ny), REGISTER_THREADS[nz])
                    for n in CLUSTER_BLOCKS))


@functools.lru_cache(maxsize=None)
def _form(shape: tuple, dtype, kind: str) -> str:
    nz, ny, nx = shape
    points = nz * ny * nx
    if (points <= BLOCK_POINTS and fits(shape, dtype.itemsize, 1)
            and (kind != "GS" or nz in REGISTER_THREADS)):
        return "block"
    if (kind != "GS" and points <= CLUSTER_POINTS
            and cluster_takes(shape, dtype)):
        return "cluster"
    return "step"


def form(shape, dtype, kind: str) -> str:
    """The form a level of ``shape`` and ``dtype`` takes in ordering
    ``kind``: 'block' where one block holds it, up to
    :data:`BLOCK_POINTS` (GS only at nz 2 or 4); else, in RB and FC,
    'cluster' where the cluster form takes it (:func:`cluster_takes`), up
    to :data:`CLUSTER_POINTS`; else 'step'."""
    if kind not in KINDS:
        raise ValueError(f"unknown relax kind {kind!r}")
    return _form(tuple(shape), dtype, kind)


def launch_name(p: torch.Tensor, kind: str) -> str:
    """The ``LAUNCHES`` key of the form ``p`` takes in ordering ``kind``."""
    return KINDS[kind].name(form(p.shape, p.dtype, kind))


def fused_relax_plain(p, b, cA, nsweeps: int, kind: str, real_matrix: bool):
    """``nsweeps`` masked sweeps of ordering ``kind``, colour 0 first
    (ops/relax.relax with the edge-copy halo)."""
    return relax_ops.relax(p, b, cA, nsweeps, kind, real_matrix,
                           extend_fn=extend_h1)


def _step_scratch(p, kind: str, real_matrix: bool):
    """The per-step form's scratch: GS's second state buffer; RB's
    snapshot of plane 0 before each step (the 'real' diagonal couplings
    join its own colour's columns); FC none (it updates in place)."""
    if kind == "GS":
        return torch.empty_like(p)
    if kind == "RB" and real_matrix:
        return torch.empty_like(p[0])
    return None


@functools.lru_cache(maxsize=None)
def _record_bytes(shape: tuple, itemsize: int, kind: str) -> int:
    """The device memory the one-block form's records take at ``shape``
    (csrc/relax_fused.cu record_bytes): 0 where registers or shared
    memory hold them, asked once a shape."""
    return _build.load().mg_relax_fused_record_bytes(itemsize, *shape,
                                                     KINDS[kind].code)


def _resident_scratch(p, kind: str, form_: str):
    """The one-block form's records in device memory, where its plan puts
    them there; else none (the cluster form holds them in registers)."""
    if form_ != "block":
        return None
    nbytes = _record_bytes(tuple(p.shape), p.element_size(), kind)
    return (torch.empty(nbytes // p.element_size(), dtype=p.dtype,
                        device=p.device) if nbytes else None)


def fused_relax(p, b, cA, nsweeps: int, kind: str, real_matrix: bool):
    """``nsweeps`` line-relaxation sweeps of ordering ``kind`` ('RB',
    'FC' or 'GS') of a whole level (K6) in the form :func:`form` names:
    ``p``, ``b`` interior (nz, ny, nx), ``cA`` extended (8, nz, ny+2,
    nx+2), the physical boundary on every side.  Returns the new ``p``;
    the inputs are not written."""
    return fused_relax_form(p, b, cA, nsweeps, kind, real_matrix,
                            form(p.shape, p.dtype, kind))


def fused_relax_form(p, b, cA, nsweeps: int, kind: str, real_matrix: bool,
                     form_: str, plan: dict | None = None):
    """:func:`fused_relax` in the form ``form_`` (one of :data:`FORMS`,
    whatever the gate says: the tests and the timings; a cluster the
    kernel does not take, :func:`cluster_takes`, raises).  ``plan``, where
    given, receives a one-launch form's blocks, threads a block, where
    the records live ('registers', 'shared', 'device') and its shared
    memory bytes a block."""
    if kind not in KINDS:
        raise ValueError(f"unknown relax kind {kind!r}")
    if form_ not in FORMS:
        raise ValueError(f"unknown form {form_!r}")
    if on_cpu(p):
        return fused_relax_plain(p, b, cA, nsweeps, kind, real_matrix)
    nz, ny, nx = p.shape
    check_tensors({"p": p, "b": b, "cA": cA},
                  {"p": (nz, ny, nx), "b": (nz, ny, nx),
                   "cA": (8, nz, ny + 2, nx + 2)}, p.dtype, p.device)
    if nsweeps <= 0:
        return p
    out = torch.empty_like(p)
    scratch = (_step_scratch(p, kind, real_matrix) if form_ == "step"
               else _resident_scratch(p, kind, form_))
    info = (ctypes.c_int * 4)()
    lib = _build.load()
    fn = (lib.mg_relax_fused_f32 if p.dtype == torch.float32
          else lib.mg_relax_fused_f64)
    with torch.cuda.device(p.device):
        rc = fn(ptr(p), ptr(b), ptr(cA), ptr(out), ptr(scratch), nz, ny, nx,
                int(real_matrix), nsweeps, KINDS[kind].code,
                FORMS.index(form_), info,
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, f"fused_relax ({form_})")
    if plan is not None and form_ != "step":
        plan.update(blocks=info[0], threads=info[1],
                    records=("registers", "shared", "device")[info[2]],
                    smem=info[3])
    LAUNCHES[KINDS[kind].name(form_)] += (
        KINDS[kind].ncolor * nsweeps if form_ == "step" else 1)
    return out
