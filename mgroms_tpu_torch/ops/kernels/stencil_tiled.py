"""K5: the full-layout 15-point residual, its hand-written CUDA kernel and
its plain torch version.

Port of ``mgroms_tpu/ops/pallas/stencil_tiled.py:residual_tiled``.  The
kernel (``csrc/stencil_tiled.cu``) runs one thread per (j, i) column; the
TPU's j-tiles, row padding and VMEM budget (``supports``) have no
counterpart, so it takes any shape.  The wrapper runs the plain version
for tensors on the CPU only; for a CUDA tensor it checks device, dtype,
shape and contiguity, launches the kernel or raises.  ``LAUNCHES`` counts
the kernel launches.
"""

from __future__ import annotations

import torch

from .. import stencil
from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr

LAUNCHES = {"residual_tiled": 0}
# the kernel function behind the count (ops/kernels/__init__.py)
GRAPH_NAMES = ((r"\bresidual_kernel<", "residual_tiled"),)


def reset_launches() -> None:
    LAUNCHES["residual_tiled"] = 0


def residual_tiled_plain(pe, b, cA, real_matrix: bool):
    """r = b - A p (ops/stencil.residual)."""
    return stencil.residual(pe, b, cA, real_matrix)


def residual_tiled(pe, b, cA, real_matrix: bool):
    """r = b - A p on the interior (K5): ``pe`` the halo-extended state
    (nz, ny+2, nx+2), ``b`` (nz, ny, nx), ``cA`` (8, nz, ny+2, nx+2)."""
    if on_cpu(b):
        return residual_tiled_plain(pe, b, cA, real_matrix)
    nz, ny, nx = b.shape
    check_tensors({"pe": pe, "b": b, "cA": cA},
                  {"pe": (nz, ny + 2, nx + 2), "b": (nz, ny, nx),
                   "cA": (8, nz, ny + 2, nx + 2)}, b.dtype, b.device)
    r = torch.empty_like(b)
    lib = _build.load()
    fn = (lib.mg_residual_f32 if b.dtype == torch.float32
          else lib.mg_residual_f64)
    with torch.cuda.device(b.device):
        rc = fn(ptr(pe), ptr(b), ptr(cA), ptr(r), nz, ny, nx,
                int(real_matrix), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "residual_tiled")
    LAUNCHES["residual_tiled"] += 1
    return r
