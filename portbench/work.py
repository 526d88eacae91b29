"""The work a solve needs, counted from the level shapes and the sweep counts
of the run, and the kernels that do it.

A work class is a piece of the algorithm, whatever kernel implements it:

- ``smooth``: one red-black z-line sweep of a level, both colours;
- ``residual_restrict``: the down-leg residual of a level fused with its
  restriction to the next.

(The fresh level-0 residual's kernel maps to a class of its own,
``residual``, which no metric reads, so that it is not counted as a
``residual_restrict``.)

Bytes are those the work needs in the reference's storage, each read once
and each output written once: the operator's 8 coefficients a point with
their halo ring (the reference stores cA(8, nz, 0:ny+1, 0:nx+1)), the
state read once and written once, the right-hand side read once, and for
``residual_restrict`` the coarse right-hand side written once.  The least
time is those bytes over the card's published bandwidth (``peaks.json``);
the operations (some 30 a point and sweep) bound it far less.

Kernels map to classes by their demangled names, as the profiler prints
them, through the data files ``kernel_classes/*.json`` (``pattern``,
``class``, and the program's launch counter ``launches_key``), read in the
order of their file names; the first pattern that matches decides.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
PEAKS = json.loads((HERE / "peaks.json").read_text())


def kernel_classes() -> list:
    """(compiled pattern, class, launches key) of every table entry."""
    out = []
    for f in sorted((HERE / "kernel_classes").glob("*.json")):
        d = json.loads(f.read_text())
        out.append((re.compile(d["pattern"]), d["class"], d["launches_key"]))
    return out


def classify(name: str, table: list) -> Optional[str]:
    for pat, cls, _ in table:
        if pat.search(name):
            return cls
    return None


def operator_bytes(nz: int, ny: int, nx: int, itemsize: int) -> int:
    return 8 * nz * (ny + 2) * (nx + 2) * itemsize


def smooth_bytes(shape, itemsize: int) -> int:
    """One sweep of a level of interior ``shape`` (nz, ny, nx)."""
    nz, ny, nx = shape
    n = nz * ny * nx
    return operator_bytes(nz, ny, nx, itemsize) + 3 * n * itemsize


def residual_restrict_bytes(shape, coarse, itemsize: int) -> int:
    """The residual of a level of interior ``shape`` restricted onto the
    interior ``coarse``."""
    nz, ny, nx = shape
    n = nz * ny * nx
    nc = coarse[0] * coarse[1] * coarse[2]
    return operator_bytes(nz, ny, nx, itemsize) + (2 * n + nc) * itemsize


def fcycle_work(shapes: list, ns_pre: int, ns_post: int, itemsize: int
                ) -> dict:
    """{class: (bytes, calls)} of one F-cycle (mg_solvers.f90:104-151) on
    levels of interior ``shapes`` (finest first).  Level l above the
    coarsest is visited by l + 1 V-cycles, each ``ns_pre`` sweeps and a
    residual restricted to l + 1 on the way down and ``ns_post`` sweeps on
    the way up.  The coarsest level's solve is no class here."""
    sm = rr = 0
    nsm = nrr = 0
    for lev in range(len(shapes) - 1):
        visits = lev + 1
        sm += visits * (ns_pre + ns_post) * smooth_bytes(shapes[lev],
                                                          itemsize)
        nsm += visits * (ns_pre + ns_post)
        rr += visits * residual_restrict_bytes(shapes[lev], shapes[lev + 1],
                                               itemsize)
        nrr += visits
    return {"smooth": (sm, nsm), "residual_restrict": (rr, nrr)}


def roofline_share(ctx, cls: str) -> Optional[float]:
    """A work class's least time over the device time of the kernels that
    did it in the traced solves, in %; None where the trace has none of
    them, or where the kernels the profiler counted differ from what the
    F-cycles traced need or from the captured graph's census (the profiler
    loses events on long traces)."""
    t = ctx.trace
    if t is None or t.class_seconds.get(cls, 0.0) <= 0.0:
        return None
    nbytes, calls = ctx.work[cls]
    counted = t.class_count.get(cls, 0)
    if counted != calls * t.fcycles:
        return None
    key = next((k for _, c, k in kernel_classes() if c == cls), None)
    if ctx.census is not None and t.replays:
        if ctx.census["launches"].get(key, 0) * t.replays != counted:
            return None
    least_s = nbytes * t.fcycles / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least_s / t.class_seconds[cls]
