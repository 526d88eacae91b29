"""The colour-fused red-black sweep (K4): its hand-written CUDA kernel and
its plain torch version.

Port of ``mgroms_tpu/ops/pallas/sweep_fused.py``.  The kernel
(``csrc/sweep_fused.cu``) replaces ``_sweep_chunk`` (sweep_fused.py:509,
called by ``relax_fused_sweep``): one launch computes one whole RB sweep of a
quad-parity level, colour 0 then colour 1, bitwise what
relax_compact.relax_compact_quads computes with the same smoother operator.

The kernel reads the operator as the TPU kernel does, as the 24
halo-extended band quads of bands 3..8 (the stack of
relax_compact.band_quads, the pack's ``ebands``, or ``pack.lp.ebands`` in
bfloat16 beside the low-precision pivots): each gather term reads one
band quad at its band offset (:func:`band_term_table`), so the 48 gather
blocks, which hold the same values twice, are not read.  It reads ``ud`` and the smoother's
``bet`` and recomputes ``gam = ud * bet`` as K1 does (thomas_factor's
``gam`` is that same product, so the result is unchanged).  The TPU
kernel's VMEM machinery (band windows, lane chunks, ``_Plan``/
``_pick_plan``/``supports``, ``VMEM_LIMIT``) has no counterpart.  It takes
any ``nz >= 2`` (up to what a block's shared memory holds) and any quad
H, W.

:func:`relax_fused_sweep` runs its plain version for tensors on the CPU
only; for CUDA tensors it checks them, launches the kernel once per sweep
or raises.  The C entry is picked by the pair (state dtype, band dtype)
(:data:`ENTRIES`, one per instance of the kernel, read by
``_build.instance``); a pair without an instance raises before anything
launches.  ``LAUNCHES`` counts kernel
launches per instance: full-precision bands, bfloat16 bands with float32
state, bfloat16 bands with float64 state.  ``PLANS`` records, at the
first launch of each (quads shape, state dtype, band dtype), the launch
plan the kernel takes there (:func:`launch_plan`); the reset clears both.
The plan includes the depth of the kernel's staging ring
(``planes_ahead``), which the launcher sets from the shape: the deep ring
where it keeps the resident blocks of the shallow one, else the shallow
one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_launch, check_tensors, instance, on_cpu, ptr
from .relax_tiled import term_table
from ..relax_compact import (_BASE_TERMS, _REAL_TERMS, _TKEYS, NBANDS,
                             CompactPack, band_index, band_layout,
                             check_band_stack, relax_compact_quads,
                             smoother_operator)

LAUNCHES = {"relax_fused_sweep": 0, "relax_fused_sweep_bf16": 0,
            "relax_fused_sweep_bf16_f64": 0}
# ((nz, H, W), state dtype, band dtype) -> launch_plan's dict
PLANS = {}
# the kernel functions behind each count (ops/kernels/__init__.py):
# sweep_kernel<T, B>
GRAPH_NAMES = (
    (r"\bsweep_kernel<(float, float|double, double)>", "relax_fused_sweep"),
    (r"\bsweep_kernel<float, __nv_bfloat16>", "relax_fused_sweep_bf16"),
    (r"\bsweep_kernel<double, __nv_bfloat16>", "relax_fused_sweep_bf16_f64"),
)

# (state dtype, band dtype) -> (C entry, LAUNCHES key): the instances of
# csrc/sweep_fused.cu, in the order mg_sweep_fused_plan numbers them
ENTRIES = {
    (torch.float32, torch.float32): ("mg_sweep_fused_f32",
                                     "relax_fused_sweep"),
    (torch.float64, torch.float64): ("mg_sweep_fused_f64",
                                     "relax_fused_sweep"),
    (torch.float32, torch.bfloat16): ("mg_sweep_fused_bf16",
                                      "relax_fused_sweep_bf16"),
    (torch.float64, torch.bfloat16): ("mg_sweep_fused_f64_bf16",
                                      "relax_fused_sweep_bf16_f64"),
}

def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLANS.clear()


def relax_fused_sweep_plain(q0, bq, pack: CompactPack, nsweeps: int):
    """``nsweeps`` RB sweeps, each colour 0 then colour 1 through
    extend_quads, with the smoother operator (``pack.lp`` when present):
    relax_compact.relax_compact_quads."""
    return relax_compact_quads(q0, bq, pack, nsweeps, "RB", pack.real_matrix)


class _SweepArgs(ctypes.Structure):
    _fields_ = [("q", ctypes.c_void_p * 4), ("bq", ctypes.c_void_p * 4),
                ("band", ctypes.c_void_p), ("ud", ctypes.c_void_p * 4),
                ("bet", ctypes.c_void_p * 4), ("out", ctypes.c_void_p * 4)]


def band_term_table(target) -> list:
    """Per gather term of target quad ``target`` (the 12 of
    ``_BASE_TERMS``, then the 4 of ``_REAL_TERMS``):
    ``(band, bk, bj, bi, src, dk, oj, oi)`` — the operator value is band
    quad ``band`` (relax_compact.band_quads order) at plane k + ``bk``,
    extended row J + ``bj`` and column I + ``bi`` (plane k + bk + 1 of
    the stack, whose end planes are zero, as _kshift pads), the state
    value as relax_tiled.term_table gives it
    (quad ``src`` of ``_TKEYS`` at plane k + ``dk``, extended row
    J + ``oj``, column I + ``oi``).  The band read is the index algebra of
    the JAX kernel's ``band_read`` (sweep_fused.py:359-369)."""
    a, b = target
    rows = []
    for (n, (bk, bj, bi), _), state in zip(_BASE_TERMS + _REAL_TERMS,
                                           term_table(target, _TKEYS)):
        kb = ((a + bj) % 2, (b + bi) % 2)
        rows.append((band_index(n, kb), bk, 1 + (a + bj - kb[0]) // 2,
                     1 + (b + bi - kb[1]) // 2) + tuple(state[:4]))
    return rows


def sweep_bands(pack: CompactPack, dtype):
    """``(ebands, bet, band dtype)`` the kernel reads for state of type
    ``dtype``: the smoother operator of relax_compact.smoother_operator
    as the band stack (relax_compact.band_quads)."""
    _, _, bet, band = smoother_operator(pack, dtype)
    ebands = pack.ebands if pack.lp is None else pack.lp.ebands
    if ebands is None:
        raise ValueError("the pack carries no band quads for the sweep "
                         "kernel (relax_compact.attach_bands)")
    return ebands, bet, band


def launch_plan(shape, state, band, ahead: int = 0) -> dict:
    """The launch K4 takes at quads ``shape`` (nz, H, W) for the pair
    (``state``, ``band``): threads a block, resident blocks per SM, the
    cooperative grid, the dynamic shared memory of a block and the planes
    its staging ring keeps in flight ahead of the solved one (read from the
    launcher, ``mg_sweep_fused_plan``; needs a card).  ``ahead``: the ring
    depth :func:`relax_fused_sweep` is asked for, 0 for the plan's own."""
    instance(ENTRIES, state, band, "K4")
    inst = list(ENTRIES).index((state, band))
    out = (ctypes.c_int * 5)()
    check_launch(_build.load().mg_sweep_fused_plan(inst, *shape, ahead, out),
                 "mg_sweep_fused_plan")
    return dict(zip(("threads", "blocks_per_sm", "grid", "smem_bytes",
                     "planes_ahead"), out))


def compiled_term_table(target) -> list:
    """The kernel's own term recipe for ``target`` (compiled into
    csrc/sweep_fused.cu, read through ``mg_sweep_terms``), rows as
    :func:`band_term_table` gives them; needs the built kernels."""
    out = (ctypes.c_int * (16 * 8))()
    check_launch(_build.load().mg_sweep_terms(_TKEYS.index(target), out),
                 "mg_sweep_terms")
    return [tuple(out[8 * m:8 * m + 8]) for m in range(16)]


def _launch(q, bq, pack: CompactPack, ahead: int):
    """One K4 launch: the four new quads of one sweep of ``q``."""
    q0 = q[(0, 0)]
    nz, H, W = q0.shape
    if nz < 2:
        raise ValueError("the sweep kernel needs nz >= 2")
    ebands, bet, band = sweep_bands(pack, q0.dtype)
    name, key = instance(ENTRIES, q0.dtype, band, "K4")
    check_band_stack(ebands, (NBANDS, nz + 2, H + 2, W + 2), band, q0.device)
    named, shapes = {}, {}
    for m, t in enumerate(_TKEYS):
        for f, (x, shape) in {"q": (q[t], (nz, H, W)),
                              "bq": (bq[t], (nz, H, W)),
                              "ud": (pack.ud[m], (nz - 1, H, W)),
                              "bet": (bet[m], (nz, H, W))}.items():
            named[f"{f}{t}"] = x
            shapes[f"{f}{t}"] = shape
    check_tensors(named, shapes, q0.dtype, q0.device)
    out = {t: torch.empty_like(q0) for t in _TKEYS}
    arr = lambda xs: (ctypes.c_void_p * len(xs))(*(ptr(x) for x in xs))
    lpad, _ = band_layout(W, ebands.element_size())
    args = _SweepArgs(arr([q[t] for t in _TKEYS]),
                      arr([bq[t] for t in _TKEYS]),
                      ebands.data_ptr() - lpad * ebands.element_size(),
                      arr(pack.ud), arr(bet), arr([out[t] for t in _TKEYS]))
    fn = getattr(_build.load(), name)
    with torch.cuda.device(q0.device):
        plan_key = ((nz, H, W), q0.dtype, band)
        if not ahead and plan_key not in PLANS:
            PLANS[plan_key] = launch_plan(*plan_key)
        rc = fn(ctypes.byref(args), nz, H, W, int(pack.real_matrix), ahead,
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "relax_fused_sweep")
    return out, key


def relax_fused_sweep(q0, bq, pack: CompactPack, nsweeps: int,
                      ahead: int = 0):
    """``nsweeps`` colour-fused RB sweeps (K4), quad-parity state in and
    out (``_TKEYS``-keyed dicts); one kernel launch per sweep on the card,
    :func:`relax_fused_sweep_plain` for CPU tensors.  ``ahead`` forces the
    depth of the kernel's staging ring (tests and timings; the launcher
    refuses a depth it has no kernel of or whose ring does not fit), 0
    takes the launch plan's; the result is the same at every depth."""
    if on_cpu(q0[(0, 0)]):
        return relax_fused_sweep_plain(q0, bq, pack, nsweeps)
    q = dict(q0)
    for _ in range(nsweeps):
        q, key = _launch(q, bq, pack, ahead)
        LAUNCHES[key] += 1
    return q
