"""The colour-fused red-black sweep (K4): its hand-written CUDA kernel and
its plain torch version.

Port of ``mgroms_tpu/ops/pallas/sweep_fused.py``.  The kernel
(``csrc/sweep_fused.cu``) replaces ``_sweep_chunk`` (sweep_fused.py:509,
called by ``relax_fused_sweep``): one launch computes one whole RB sweep of a
quad-parity level, colour 0 then colour 1, bitwise what
relax_compact.relax_compact_quads computes with the same smoother operator.

The TPU kernel's VMEM machinery (``SweepOperator`` band windows, lane
chunks, ``_Plan``/``_pick_plan``/``supports``, ``VMEM_LIMIT``) has no
counterpart: the kernel reads the smoother operator of
relax_compact.smoother_operator — the pack's ``blocks``/``rblocks`` and
``bet``, or their low-precision copies ``pack.lp`` — and ``ud``, and
recomputes ``gam = ud * bet`` as K1 does (thomas_factor's ``gam`` is that
same product, so the result is unchanged).  It takes any ``nz >= 2`` and any
quad H, W.

:func:`relax_fused_sweep` runs its plain version for tensors on the CPU
only; for CUDA tensors it checks them, launches the kernel once per sweep
or raises.  ``LAUNCHES`` counts kernel launches, by the type of the blocks
the kernel read.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_launch, check_tensors, on_cpu, ptr
from .relax_tiled import term_table
from ..relax_compact import (_TKEYS, CompactPack, gather_keys,
                             relax_compact_quads, smoother_operator)

LAUNCHES = {"relax_fused_sweep": 0, "relax_fused_sweep_bf16": 0}

_NKEYS = len(gather_keys(False))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def relax_fused_sweep_plain(q0, bq, pack: CompactPack, nsweeps: int):
    """``nsweeps`` RB sweeps, each colour 0 then colour 1 through
    extend_quads, with the smoother operator (``pack.lp`` when present):
    relax_compact.relax_compact_quads."""
    return relax_compact_quads(q0, bq, pack, nsweeps, "RB", pack.real_matrix)


class _SweepArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p * 4)
                for name in ("q", "bq", "blocks", "rb", "ud", "bet", "out")]


@functools.cache
def _term_tables(device) -> torch.Tensor:
    """The four targets' term tables (relax_tiled.term_table over the four
    quads in ``_TKEYS`` order) as one int32 (4, 5, 16) tensor on
    ``device``, the layout of the kernel's ``Terms[4]``; made once per
    device (a copy to the card per launch would wait on the host)."""
    rows = [list(zip(*term_table(t, _TKEYS))) for t in _TKEYS]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _launch(q, bq, pack: CompactPack):
    """One K4 launch: the four new quads of one sweep of ``q``."""
    q0 = q[(0, 0)]
    nz, H, W = q0.shape
    if nz < 2:
        raise ValueError("the sweep kernel needs nz >= 2")
    real = pack.real_matrix
    if real != (pack.rblocks is not None):
        raise ValueError("rblocks are required exactly when real_matrix")
    blocks, rblocks, bet, band = smoother_operator(pack, q0.dtype)
    named, shapes, dtypes = {}, {}, {}
    for m, t in enumerate(_TKEYS):
        fields = {"q": (q[t], (nz, H, W)), "bq": (bq[t], (nz, H, W)),
                  "blocks": (blocks[m], (nz, H, _NKEYS * W)),
                  "ud": (pack.ud[m], (nz - 1, H, W)),
                  "bet": (bet[m], (nz, H, W))}
        if real:
            fields["rb"] = (rblocks[m], (1, H, 2 * W))
        for f, (x, shape) in fields.items():
            named[f"{f}{t}"] = x
            shapes[f"{f}{t}"] = shape
            if f in ("blocks", "rb"):
                dtypes[f"{f}{t}"] = band
    check_tensors(named, shapes, q0.dtype, q0.device, dtypes)
    out = {t: torch.empty_like(q0) for t in _TKEYS}
    four = lambda xs: (ctypes.c_void_p * 4)(*(ptr(x) for x in xs))
    args = _SweepArgs(four(q[t] for t in _TKEYS), four(bq[t] for t in _TKEYS),
                      four(blocks), four(rblocks if real else [None] * 4),
                      four(pack.ud), four(bet), four(out[t] for t in _TKEYS))
    lib = _build.load()
    fn = {torch.float64: lib.mg_sweep_fused_f64,
          torch.bfloat16: lib.mg_sweep_fused_bf16}.get(band,
                                                      lib.mg_sweep_fused_f32)
    with torch.cuda.device(q0.device):
        rc = fn(ctypes.byref(args), nz, H, W, int(real),
                ptr(_term_tables(q0.device)),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "relax_fused_sweep")
    return out, band


def relax_fused_sweep(q0, bq, pack: CompactPack, nsweeps: int):
    """``nsweeps`` colour-fused RB sweeps (K4), quad-parity state in and
    out (``_TKEYS``-keyed dicts); one kernel launch per sweep on the card,
    :func:`relax_fused_sweep_plain` for CPU tensors."""
    if on_cpu(q0[(0, 0)]):
        return relax_fused_sweep_plain(q0, bq, pack, nsweeps)
    q = dict(q0)
    for _ in range(nsweeps):
        q, band = _launch(q, bq, pack)
        LAUNCHES["relax_fused_sweep_bf16" if band == torch.bfloat16
                 else "relax_fused_sweep"] += 1
    return q
