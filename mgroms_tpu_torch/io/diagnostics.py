"""Diagnostics field output.

Port of ``mgroms_tpu/io/diagnostics.py``, the equivalent of
``src/mg_netcdf_out.f90``: the reference writes one netCDF-classic file
per (rank, variable, iteration) for debugging (:76-110); there is no
reader and no restart path (the solver is stateless between calls).  The
same model here: write-only dumps, one file per (variable, iteration),
gated by ``SolverConfig.netcdf_output``.

Format: netCDF classic via ``scipy.io.netcdf_file`` when scipy is present
(readable by the ncview/nco tooling the reference's dumps target), else
``.npz``.  A tensor is copied to the host before it is written.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

try:
    from scipy.io import netcdf_file
    _HAVE_NETCDF = True
except Exception:                 # pragma: no cover
    _HAVE_NETCDF = False


def _fname(base: str, vname: str, rank: Optional[int], it: Optional[int]):
    """Reference naming: the file gets `_vname[_rank][_iter]` suffixes
    (mg_netcdf_out.f90:76-110)."""
    stem, ext = os.path.splitext(base)
    if not ext:
        ext = ".nc"
    parts = [stem, vname]
    if rank is not None:
        parts.append(f"{rank:04d}")
    if it is not None:
        parts.append(f"{it:04d}")
    return "_".join(parts) + ext


def write_field(arr, vname: str, filename: str,
                rank: Optional[int] = None, iteration: Optional[int] = None
                ) -> str:
    """Dump one array (a tensor on any device, or anything numpy takes);
    returns the path written."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr)
    path = _fname(filename, vname, rank, iteration)
    if _HAVE_NETCDF:
        with netcdf_file(path, "w") as f:
            dims = []
            for ax, n in enumerate(a.shape):
                dn = f"dim{ax}"
                f.createDimension(dn, n)
                dims.append(dn)
            var = f.createVariable(vname, a.dtype.newbyteorder("="),
                                   tuple(dims))
            var[:] = a
    else:                          # pragma: no cover
        path = os.path.splitext(path)[0] + ".npz"
        np.savez(path, **{vname: a})
    return path


def read_field(path: str, vname: str) -> np.ndarray:
    """Read back a dumped field (the reference has no reader; this one lets
    tests and tooling check the dumps)."""
    if path.endswith(".npz"):
        return np.load(path)[vname]
    with netcdf_file(path, "r") as f:
        return np.array(f.variables[vname][:])
