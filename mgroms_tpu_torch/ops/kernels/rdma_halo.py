"""K7: the residual of one tile of a (1, npx) mesh, its x-seam halo read
from the neighbour tiles — the hand-written CUDA kernel and its plain torch
version.

Port of ``mgroms_tpu/ops/pallas/rdma_halo.py:residual_overlap_x`` (kernel
``_kernel``).  The TPU kernel overlaps an inter-chip RDMA of its edge
columns with the interior columns' residual; the CUDA kernel
(``csrc/rdma_halo.cu``) is one launch per tile: a block owns a
:data:`TILE` of columns and walks the planes through a ring of
:data:`RING` planes in shared memory (state window with its halo, b, the 8
band windows), and the seam is the halo column the edge blocks stage from
the neighbours' edge columns through their device pointers; those blocks
come first in block order.  As in the JAX package no solver path routes
it: it is an alternative schedule of the shard_map residual.

:func:`residual_overlap_x` runs inside parallel.mesh.shard_map over a
(1, npx) mesh, as the JAX function runs inside ``jax.shard_map``.  For a
tile on the CPU it is its plain version, ``ops/stencil.residual`` on
``parallel/exchange.halo_extend`` of the tile (the reference of
``tests/test_rdma.py``); for a tile on the card it launches the kernel
(:func:`residual_overlap_tile`) or raises.  A neighbour on another card
must be readable through peer access (raises otherwise, no staging through
the host), and the launch waits on an event recorded on the neighbour's
stream when it deposited its tile.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import stencil
from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr

LAUNCHES = {"residual_overlap_x": 0}

# the kernel's block tile (rows, columns; a thread a point) and ring depth
# (planes k-1, k, k+1 and one in flight), as csrc/rdma_halo.cu compiles
# them (mg_residual_overlap_x_plan)
TILE = (16, 32)
RING = 4


def reset_launches() -> None:
    LAUNCHES["residual_overlap_x"] = 0


def check_peer(dev: torch.device, other: torch.device,
               can_access=None) -> None:
    """Raise unless a kernel on CUDA device ``dev`` may read ``other``'s
    memory (the same device, or peer access between the two)."""
    if other.type != "cuda":
        raise ValueError(f"neighbour tile on {other}; K7 reads CUDA tiles")
    if other == dev:
        return
    can_access = can_access or torch.cuda.can_device_access_peer
    if not can_access(dev, other):
        raise RuntimeError(f"{dev} cannot read {other} (no peer access); "
                           "K7 reads a neighbour tile in place")


def block_order(ny: int, nx: int, tile=TILE) -> list:
    """The kernel's blocks in launch order, as (row, column) tile indices:
    the first and last tile columns (the seams), row by row, then the
    interior columns, row by row."""
    nby, nbx = -(-ny // tile[0]), -(-nx // tile[1])
    edge = [0, nbx - 1] if nbx > 1 else [0]
    return ([(bj, bi) for bj in range(nby) for bi in edge]
            + [(bj, bi) for bj in range(nby) for bi in range(1, nbx - 1)])


def design_bytes(nz: int, ny: int, nx_l: int, tile=TILE, itemsize: int = 4,
                 real: bool = True) -> dict:
    """The bytes one launch on a (nz, ny, nx_l) tile moves as designed,
    halo re-reads included: per block and plane the 8 band windows
    (bands 3-5 a row taller, 6-8 a column wider), the state window with
    its two halo rows and columns, b, and r written; with ``real`` the
    two plane-0 band values off the windows."""
    tj, ti = tile
    out = dict.fromkeys(("bands", "state", "b", "r"), 0)
    for bj, bi in block_order(ny, nx_l, tile):
        rows, cols = min(tj, ny - bj * tj), min(ti, nx_l - bi * ti)
        out["bands"] += nz * (2 * rows * cols + 3 * (rows + 1) * cols
                              + 3 * rows * (cols + 1))
        out["state"] += nz * (rows + 2) * (cols + 2)
        out["b"] += nz * rows * cols
        out["r"] += nz * rows * cols
    if real:
        out["bands"] += 2 * ny * nx_l
    return {k: v * itemsize for k, v in out.items()}


def launch_plan(ny: int, nx: int, dtype=torch.float32) -> dict:
    """The kernel's plan for a (ny, nx) tile, read from the build: tile,
    ring slots, shared memory a block, blocks, blocks resident an SM
    (needs a card)."""
    out = (ctypes.c_int * 6)()
    check_launch(_build.load().mg_residual_overlap_x_plan(
        torch.tensor([], dtype=dtype).element_size(), ny, nx, out),
        "residual_overlap_x plan")
    return dict(tile=(out[0], out[1]), ring=out[2], smem=out[3],
                blocks=out[4], per_sm=out[5])


def residual_overlap_tile(p_l, b_l, cA_l, real_matrix: bool, p_west=None,
                          p_east=None, events=(None, None)):
    """One K7 launch: r = b - A p on the tile ``p_l`` (nz, ny, nx_l),
    ``b_l`` (nz, ny, nx_l), ``cA_l`` (8, nz, ny+2, nx_l+2) (its extended
    bands), the x-seam columns from ``p_west``/``p_east`` (the neighbour
    tiles (nz, ny, *), None at a domain edge), on ``p_l``'s device and
    current stream after ``events`` (recorded where the neighbours'
    tiles were final)."""
    nz, ny, nx = p_l.shape
    if nx < 2:
        raise ValueError("K7 needs at least 2 local columns")
    check_tensors({"p": p_l, "b": b_l, "cA": cA_l},
                  {"p": (nz, ny, nx), "b": (nz, ny, nx),
                   "cA": (8, nz, ny + 2, nx + 2)}, p_l.dtype, p_l.device)
    dev = p_l.device
    lib = _build.load()
    nbrs = (p_west, p_east)
    widths = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for t, ev in zip(nbrs, events):
            if t is None:
                widths.append(1)
                continue
            check_peer(dev, t.device)
            if (t.dtype != p_l.dtype or not t.is_contiguous()
                    or tuple(t.shape[:2]) != (nz, ny)):
                raise ValueError(f"neighbour tile {tuple(t.shape)} "
                                 f"{t.dtype}, expected contiguous "
                                 f"({nz}, {ny}, *) {p_l.dtype}")
            if t.device != dev:
                check_launch(lib.mg_enable_peer(t.device.index),
                             "enable peer access")
            if ev is not None:
                stream.wait_event(ev)
            widths.append(t.shape[2])
        r = torch.empty_like(b_l)
        fn = (lib.mg_residual_overlap_x_f32 if p_l.dtype == torch.float32
              else lib.mg_residual_overlap_x_f64)
        rc = fn(ptr(p_l), ptr(p_west), ptr(p_east), ptr(b_l), ptr(cA_l),
                ptr(r), nz, ny, nx, widths[0], widths[1], int(real_matrix),
                stream.cuda_stream)
        check_launch(rc, "residual_overlap_x")
        # a neighbour's later work on its own device (the reuse of its
        # tile's memory included) waits for this read
        for t in nbrs:
            if t is not None and t.device != dev:
                done = torch.cuda.Event()
                done.record(stream)
                torch.cuda.current_stream(t.device).wait_event(done)
    LAUNCHES["residual_overlap_x"] += 1
    return r


def residual_overlap_x_plain(p_l, b_l, cA_l, real_matrix: bool,
                             px_name: str = "px", py_name: str = "py"):
    """The plain version (inside shard_map): ops/stencil.residual on the
    tile extended by parallel/exchange.halo_extend."""
    from ...parallel.exchange import halo_extend
    return stencil.residual(halo_extend(p_l, py_name, px_name), b_l, cA_l,
                            real_matrix)


def residual_overlap_x(p_l, b_l, cA_l, real_matrix: bool,
                       px_name: str = "px", py_name: str = "py"):
    """r = b - A p on this tile (inside shard_map over a (1, npx) mesh):
    the neighbours' edge columns at the x seams, the Neumann mirror in y
    and at the domain edges.  ``cA_l`` is the tile's extended band stack
    (8, nz, ny+2, nx_l+2).  Bitwise ``stencil.residual(halo_extend(p),
    b, cA)``; only the schedule differs."""
    from ...parallel.mesh import all_tiles, axis_index, axis_size
    if py_name is not None and axis_size(py_name) != 1:
        raise ValueError("K7 runs on a (1, npx) mesh (y is mirrored)")
    if on_cpu(p_l):
        return residual_overlap_x_plain(p_l, b_l, cA_l, real_matrix,
                                        px_name, py_name)
    # the collective: every tile deposits its p (final on its stream at
    # the recorded event); the seam blocks read the neighbours' in place
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(p_l.device))
    row = all_tiles((p_l, ev))[0]
    i, n = axis_index(px_name), axis_size(px_name)
    west = row[i - 1] if i > 0 else (None, None)
    east = row[i + 1] if i < n - 1 else (None, None)
    return residual_overlap_tile(p_l, b_l, cA_l, real_matrix, west[0],
                                 east[0], events=(west[1], east[1]))
