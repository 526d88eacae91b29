"""K6: masked line smoothing of a whole full-layout level in any of the
three orderings, its hand-written CUDA kernel and its plain torch version.

Port of ``mgroms_tpu/ops/pallas/relax_fused.py:fused_relax``: ``nsweeps``
sweeps of ``ncolor`` colour steps (:data:`KINDS`: 'RB' two parity
colours, 'FC' four, 'GS' one all-ones step, the JAX package's
column-Jacobi GS), each committing ``p + mask * (sol - p)``.  The kernel
(``csrc/relax_fused.cu``) has two forms, chosen by the level's size:

  ``fused_relax``       one launch per call, the level in one block's
                        shared memory (levels whose four fields fit
                        ``ONE_BLOCK_BYTES``: the coarsest level of every
                        cell);
  ``fused_relax_step``  one launch per colour step (larger levels), a
                        thread per column of the step's colour; RB and FC
                        update a copy of ``p`` in place, GS ping-pongs.

``LAUNCHES`` counts the kernel launches of each form and ordering under
the names of :data:`KINDS`: RB under the form's name, FC and GS under it
with ``_fc`` / ``_gs`` added.
The wrapper runs the plain version for tensors on the CPU only; for a CUDA
tensor it checks device, dtype, shape and contiguity, launches the kernel
or raises.  The TPU's VMEM gate (``fits_vmem``) has no counterpart: the
kernel takes any level.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...bc import extend_h1
from .. import relax as relax_ops
from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr



class Kind(NamedTuple):
    """One ordering: the kernel's code for it (relax_fused.cu), its
    colour steps per sweep, and the ``LAUNCHES`` names of its one-launch
    and per-step forms."""
    code: int
    ncolor: int
    block: str
    step: str


KINDS = {kind: Kind(code, ncolor, f"fused_relax{sfx}",
                    f"fused_relax_step{sfx}")
         for kind, code, ncolor, sfx in (("RB", 0, 2, ""), ("FC", 1, 4, "_fc"),
                                         ("GS", 2, 1, "_gs"))}

LAUNCHES = {name: 0 for k in KINDS.values() for name in (k.block, k.step)}

# shared memory of the one-block form: two state buffers, b and the Thomas
# multipliers (the H100 gives a block up to 227 KB)
ONE_BLOCK_BYTES = 160 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def one_block(p: torch.Tensor) -> bool:
    """Whether a level of ``p``'s shape and dtype runs in one launch."""
    return 4 * p.numel() * p.element_size() <= ONE_BLOCK_BYTES


def launch_name(p: torch.Tensor, kind: str) -> str:
    """The ``LAUNCHES`` key of the form ``p`` takes in ordering ``kind``."""
    return KINDS[kind].block if one_block(p) else KINDS[kind].step


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


def fused_relax(p, b, cA, nsweeps: int, kind: str, real_matrix: bool):
    """``nsweeps`` line-relaxation sweeps of ordering ``kind`` ('RB',
    'FC' or 'GS') of a whole level (K6): ``p``, ``b`` interior
    (nz, ny, nx), ``cA`` extended (8, nz, ny+2, nx+2), the physical
    boundary on every side.  Returns the new ``p``; the inputs are not
    written."""
    if kind not in KINDS:
        raise ValueError(f"unknown relax kind {kind!r}")
    if on_cpu(p):
        return fused_relax_plain(p, b, cA, nsweeps, kind, real_matrix)
    nz, ny, nx = p.shape
    check_tensors({"p": p, "b": b, "cA": cA},
                  {"p": (nz, ny, nx), "b": (nz, ny, nx),
                   "cA": (8, nz, ny + 2, nx + 2)}, p.dtype, p.device)
    if nsweeps <= 0:
        return p
    single = one_block(p)
    out = torch.empty_like(p)
    scratch = None if single else _step_scratch(p, kind, real_matrix)
    lib = _build.load()
    fn = (lib.mg_relax_fused_f32 if p.dtype == torch.float32
          else lib.mg_relax_fused_f64)
    with torch.cuda.device(p.device):
        rc = fn(ptr(p), ptr(b), ptr(cA), ptr(out), ptr(scratch), nz, ny, nx,
                int(real_matrix), nsweeps, KINDS[kind].code, int(single),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "fused_relax")
    LAUNCHES[launch_name(p, kind)] += (1 if single
                                       else KINDS[kind].ncolor * nsweeps)
    return out
