"""The divergence right-hand side in one pass: its hand-written CUDA
kernel and its plain torch version.

The kernel (``csrc/rhs_fused.cu``) replaces no Pallas kernel: the JAX
package leaves ``mgroms_tpu/ops/rhs.py:compute_rhs`` to XLA, which fuses
it.  The plain version is ``ops/rhs.compute_rhs`` itself; the kernel
computes what it computes, term for term and in its order of operations,
in one pass over the fields (0 ulp).  It takes any (nz, ny, nx), float32
and float64, ``bmask`` true or false, and the face masks as inputs: the
default walls (``rhs.wall_face_masks``) and a distributed tile's
(``parallel/exchange.shard_face_masks``) are one path.

:func:`rhs_fused` runs the plain version for tensors on the CPU only; for
CUDA tensors it checks device, dtype, shape and contiguity (``zw`` may be a
view with rows of unit stride: the model's is one of the halo-2 field),
launches the kernel or raises.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..rhs import compute_rhs, wall_face_masks
from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr

LAUNCHES = {"rhs_fused": 0}
# the kernel function behind the count (ops/kernels/__init__.py)
GRAPH_NAMES = ((r"\brhs_kernel<", "rhs_fused"),)

ENTRIES = {torch.float32: "mg_rhs_fused_f32",
           torch.float64: "mg_rhs_fused_f64"}

_POINTERS = ("u", "v", "w", "dx", "dy", "zw", "dzw", "zx", "zy", "cw",
             "umask", "vmask", "rmask", "uface", "vface", "out")


class _RhsArgs(ctypes.Structure):
    """csrc/rhs_fused.cu's RhsArgs."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [("zw_plane", ctypes.c_longlong),
                   ("zw_row", ctypes.c_longlong)])


def reset_launches() -> None:
    LAUNCHES["rhs_fused"] = 0


def rhs_fused(m, u, v, w, bmask: bool, uface_mask=None, vface_mask=None):
    """b = div(fluxes) on the interior, (nz, ny, nx), from the metrics
    ``m`` (assembly.FineMetrics) and the velocities u (nz, ny+2, nx+1),
    v (nz, ny+1, nx+2), w (nz+1, ny+2, nx+2).  The face masks default to
    walls on all four sides; with ``bmask`` none is applied
    (ops/rhs.compute_rhs)."""
    if on_cpu(u):
        return compute_rhs(m, u, v, w, bmask, uface_mask, vface_mask)
    nz = u.shape[0]
    J, I = m.dx.shape
    ny, nx = J - 2, I - 2
    if bmask:
        uface_mask = vface_mask = None
    elif uface_mask is None or vface_mask is None:
        walls = wall_face_masks(ny, nx, u)
        uface_mask = walls[0] if uface_mask is None else uface_mask
        vface_mask = walls[1] if vface_mask is None else vface_mask
    plane, wplane = (J, I), (nz + 1, J, I)
    named = dict(u=u, v=v, w=w, dx=m.dx, dy=m.dy, dzw=m.dzw, zx=m.zx,
                 zy=m.zy, cw=m.cw, umask=m.umask, vmask=m.vmask,
                 rmask=m.rmask)
    shapes = dict(u=(nz, J, nx + 1), v=(nz, ny + 1, I), w=wplane, dx=plane,
                  dy=plane, dzw=wplane, zx=(nz, J, I), zy=(nz, J, I),
                  cw=wplane, umask=plane, vmask=plane, rmask=plane)
    if not bmask:
        named.update(uface=uface_mask, vface=vface_mask)
        shapes.update(uface=(ny, nx + 1), vface=(ny + 1, nx))
    check_tensors(named, shapes, u.dtype, u.device)
    zw = m.zw
    if (zw.device != u.device or zw.dtype != u.dtype
            or tuple(zw.shape) != wplane or zw.stride(-1) != 1):
        raise ValueError(f"zw: {zw.dtype} {tuple(zw.shape)} with strides "
                         f"{zw.stride()} on {zw.device}, expected "
                         f"{u.dtype} {wplane} with rows of unit stride on "
                         f"{u.device}")
    out = torch.empty((nz, ny, nx), dtype=u.dtype, device=u.device)
    args = _RhsArgs(*(ptr(t) for t in (
        u, v, w, m.dx, m.dy, zw, m.dzw, m.zx, m.zy, m.cw, m.umask, m.vmask,
        m.rmask, uface_mask, vface_mask, out)),
        zw.stride(0), zw.stride(1))
    fn = getattr(_build.load(), ENTRIES[u.dtype])
    with torch.cuda.device(u.device):
        rc = fn(ctypes.byref(args), nz, ny, nx,
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "rhs_fused")
    LAUNCHES["rhs_fused"] += 1
    return out
