"""Load-rate probes (K11): their hand-written CUDA kernels, plain torch
versions, one-call PyTorch yardsticks and byte counts.

Port of the four Pallas probes of ``scripts/micro_dma_probe.py``
(``csrc/dma_probe.cu``):

  ``probe_windows``        <- ``probe_windows`` (:28, pallas_call :46)
  ``probe_blocks``         <- ``probe_blocks`` (:60, pallas_call :75)
  ``probe_windows_jlead``  <- ``probe_windows_jlead`` (:165, :184)
  ``probe_wide_stream``    <- ``main2``'s one-wide-stream kernel (:242-260)

Each sums float32 slices of its input streams, left to right, and loads
the bytes the TPU's DMA loaded: every stream's whole window at every grid
step, overlapping rows included, staged in shared memory (the kernel
source says how the step is split over blocks).  Each wrapper runs its
plain version for CPU tensors only; for a CUDA tensor it checks type,
shape, alignment and contiguity, launches the kernel or raises (the
kernels' own limits, streams per launch and a block's outputs and shared
memory, are checked by the C entry points alone and reported through
``check_launch``).  ``LAUNCHES`` counts kernel launches.  The
``*_library`` functions compute the same sums in one PyTorch call on the
streams stacked in one tensor (the window probes' call reads only the
summed slice, not the window): a yardstick the probes never call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_launch, on_cpu, ptr

LAUNCHES = {"probe_windows": 0, "probe_blocks": 0,
            "probe_windows_jlead": 0, "probe_wide_stream": 0}

LANES = 128          # the output width (a TPU lane row)
OFF = 2              # row and column offset of the windows' summed slice


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Geom(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("nstreams", "nrows", "rowlen",
                                             "tj", "zc", "wide", "off",
                                             "ow")]
                + [(n, ctypes.c_longlong) for n in ("pitch", "zstride",
                                                    "out_jpitch",
                                                    "out_zpitch",
                                                    "out_zstride")])


# ------------------------------------------------------------------ plain

def _sum(slices):
    acc = slices[0].clone()
    for x in slices[1:]:
        acc = acc + x
    return acc


def probe_windows_plain(xs, tj, ws, H):
    """out[z, j, c] = sum_s xs[s][z, j + 2, c + 2], (nz, H, 128)."""
    return _sum([x[:, OFF:OFF + H, OFF:OFF + LANES] for x in xs])


def probe_blocks_plain(xs, tj):
    """out = sum_s xs[s], (nz, H, Wc)."""
    return _sum(list(xs))


def probe_windows_jlead_plain(xs, tj, ws, H):
    """out[j, z, c] = sum_s xs[s][j + 2, z, c + 2], (H, nz, 128)."""
    return _sum([x[OFF:OFF + H, :, OFF:OFF + LANES] for x in xs])


def probe_wide_stream_plain(x, tj):
    """out = sum_m x[:, :, 128 m : 128 (m + 1)], (nz, H, 128)."""
    ng = x.shape[2] // LANES
    return _sum([x[:, :, m * LANES:(m + 1) * LANES] for m in range(ng)])


# ---------------------------------------------------------------- library

def probe_windows_library(X, tj, ws, H):
    """:func:`probe_windows_plain` of the streams X[s] in one call."""
    return X[:, :, OFF:OFF + H, OFF:OFF + LANES].sum(0)


def probe_blocks_library(X, tj):
    return X.sum(0)


def probe_windows_jlead_library(X, tj, ws, H):
    return X[:, OFF:OFF + H, :, OFF:OFF + LANES].sum(0)


def probe_wide_stream_library(x, tj):
    nz, H, ww = x.shape
    return x.view(nz, H, ww // LANES, LANES).sum(2)


# ------------------------------------------------------------ byte counts

def _counts(jax_in, unique_in, slice_in, out) -> dict:
    """The probe's bytes, each with the output written once: ``jax`` the
    JAX script's count (every window at every step), ``unique`` each input
    byte once, ``slice`` each byte the sum reads once (the bound's
    count)."""
    return {"jax": jax_in + out, "unique": unique_in + out,
            "slice": slice_in + out}


def windows_bytes(n, nz, H, tj, ws, wide) -> dict:
    """probe_windows and probe_windows_jlead (micro_dma_probe.py:116,
    :215): n streams of (H/tj) windows of nz x ws x wide floats, of which
    the sum reads an H x 128 slice a plane."""
    return _counts(4 * n * (H // tj) * nz * ws * wide,
                   4 * n * nz * (H - tj + ws) * wide, 4 * n * nz * H * LANES,
                   4 * nz * H * LANES)


def blocks_bytes(n, nz, H, Wc) -> dict:
    """probe_blocks (:136, :234): n (nz, H, Wc) streams, read once."""
    nb = 4 * n * nz * H * Wc
    return _counts(nb, nb, nb, 4 * nz * H * Wc)


def wide_stream_bytes(nz, H, ng) -> dict:
    """main2's one wide stream (:269): (nz, H, 128 ng), read once."""
    nb = 4 * nz * H * ng * LANES
    return _counts(nb, nb, nb, 4 * nz * H * LANES)


# --------------------------------------------------------------- wrappers

def _check_streams(xs, shape, name):
    dev = xs[0].device
    for k, x in enumerate(xs):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name}: stream {k} is {x.dtype} on "
                             f"{x.device}, expected float32 on {dev}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: stream {k} has shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: stream {k} must be contiguous and "
                             "16-byte aligned")


def _check_steps(H, tj, ws, wide):
    if tj < 1 or H % tj:
        raise ValueError(f"H {H} is not a multiple of tj {tj}")
    if ws < tj + OFF or wide < LANES + OFF or wide % 4:
        raise ValueError(f"a window ({ws} rows, {wide} columns) must hold "
                         f"the summed slice ({tj} + {OFF} rows, {LANES} + "
                         f"{OFF} columns) and be a multiple of 4 wide")


def _launch_staged(name, xs, out, nsteps, nzb, **geom):
    g = _Geom(nstreams=len(xs), **geom)
    st = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    lib = _build.load()
    with torch.cuda.device(out.device):
        rc = lib.mg_probe_staged(ctypes.addressof(st), ctypes.addressof(g),
                                 ptr(out), nsteps, nzb,
                                 torch.cuda.current_stream().cuda_stream)
    check_launch(rc, name)
    LAUNCHES[name] += 1
    return out


def probe_windows(xs, tj, ws, H):
    """K11a: ``xs`` n (nz, H - tj + ws, wide) float32 streams; each grid
    step of tj rows stages every stream's (nz, ws, wide) window.  Returns
    (nz, H, 128)."""
    if on_cpu(xs[0]):
        return probe_windows_plain(xs, tj, ws, H)
    nz, hs, wide = xs[0].shape
    _check_steps(H, tj, ws, wide)
    _check_streams(xs, (nz, H - tj + ws, wide), "probe_windows")
    out = xs[0].new_empty((nz, H, LANES))
    return _launch_staged(
        "probe_windows", xs, out, H // tj, nz, nrows=ws, rowlen=wide, tj=tj,
        zc=1, wide=wide, off=OFF, ow=LANES, pitch=wide, zstride=hs * wide,
        out_jpitch=LANES, out_zpitch=0, out_zstride=H * LANES)


def probe_blocks(xs, tj):
    """K11b: ``xs`` n (nz, H, Wc) float32 streams; each grid step stages
    every stream's (nz, tj, Wc) block.  Returns their sum."""
    if on_cpu(xs[0]):
        return probe_blocks_plain(xs, tj)
    nz, H, Wc = xs[0].shape
    if tj < 1 or H % tj:
        raise ValueError(f"H {H} is not a multiple of tj {tj}")
    _check_streams(xs, (nz, H, Wc), "probe_blocks")
    out = xs[0].new_empty((nz, H, Wc))
    return _launch_staged(
        "probe_blocks", xs, out, H // tj, nz, nrows=tj, rowlen=Wc, tj=tj,
        zc=1, wide=Wc, off=0, ow=Wc, pitch=Wc, zstride=H * Wc,
        out_jpitch=Wc, out_zpitch=0, out_zstride=H * Wc)


def jlead_planes(nz) -> int:
    """Planes per block of the j-lead probe: the most of 4, 2, 1 that
    divides nz (at the JAX script's tj 16 a block then holds its 8192
    outputs, the kernel's most)."""
    return next(zc for zc in (4, 2, 1) if nz % zc == 0)


def probe_windows_jlead(xs, tj, ws, H):
    """K11c: ``xs`` n (H - tj + ws, nz, wide) float32 streams; each grid
    step stages every stream's (ws, nz, wide) window, one contiguous span,
    split over blocks of :func:`jlead_planes` planes.  Returns
    (H, nz, 128)."""
    if on_cpu(xs[0]):
        return probe_windows_jlead_plain(xs, tj, ws, H)
    hs, nz, wide = xs[0].shape
    _check_steps(H, tj, ws, wide)
    _check_streams(xs, (H - tj + ws, nz, wide), "probe_windows_jlead")
    zc = jlead_planes(nz)
    out = xs[0].new_empty((H, nz, LANES))
    return _launch_staged(
        "probe_windows_jlead", xs, out, H // tj, nz // zc, nrows=ws,
        rowlen=zc * wide, tj=tj, zc=zc, wide=wide, off=OFF, ow=LANES,
        pitch=nz * wide, zstride=zc * wide, out_jpitch=nz * LANES,
        out_zpitch=LANES, out_zstride=zc * LANES)


def wide_rows(tj, ww) -> int:
    """Rows per staged chunk of the wide-stream probe: the most rows of
    ``ww`` floats, dividing tj, in 48 KB."""
    return max(r for r in range(1, tj + 1)
               if tj % r == 0 and (r == 1 or 4 * r * ww <= 48 * 1024))


def probe_wide_stream(x, tj):
    """K11d: ``x`` (nz, H, 128 ng) float32; each grid step stages the
    (nz, tj, 128 ng) block, :func:`wide_rows` rows at a time.  Returns
    (nz, H, 128)."""
    if on_cpu(x):
        return probe_wide_stream_plain(x, tj)
    nz, H, ww = x.shape
    if tj < 1 or H % tj or ww % LANES:
        raise ValueError(f"(nz, H, W) = {tuple(x.shape)}: H must be a "
                         f"multiple of tj {tj}, W of {LANES}")
    _check_streams([x], (nz, H, ww), "probe_wide_stream")
    rc = wide_rows(tj, ww)
    out = x.new_empty((nz, H, LANES))
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc_ = lib.mg_probe_wide(ptr(x), ptr(out), nz, H, tj, ww // LANES,
                                LANES, rc,
                                torch.cuda.current_stream().cuda_stream)
    check_launch(rc_, "probe_wide_stream")
    LAUNCHES["probe_wide_stream"] += 1
    return out
