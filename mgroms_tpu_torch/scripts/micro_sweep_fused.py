"""One RB sweep of the CUC level-0 smoother by every route, timed on the
card.  Port of ``scripts/micro_sweep_fused.py`` (synthetic operator data:
the timing depends only on the shapes).

    python -m mgroms_tpu_torch.scripts.micro_sweep_fused            # level 0
    python -m mgroms_tpu_torch.scripts.micro_sweep_fused --nz 32 --ny 512 \\
        --nx 512                                                    # level 1

Modes (``--modes``, comma-separated; all by default):

  tiled                   the K1 route (relax_tiled.relax_compact_tiled_quads,
                          on the band stack)
  fused_f32, fused_bf16   K4 (sweep_fused.relax_fused_sweep), f32 or
                          bfloat16 blocks
  packed_f32, packed_bf16 K8 + K9 (sweep_packed.relax_packed_sweep) at the
                          plan ``--tj``/``--nchunks``
  check                   the packed sweep and K4 against the plain sweep
                          (relax_compact_quads), and against each other
                          after 2 sweeps

The routes are timed in turns (forward, then reverse order), each a median
of CUDA-event timings; the card's 80 GB holds every operator at once.
:func:`check` runs on any device; :func:`timed` needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops import relax_compact as rc
from ..ops.kernels import relax_tiled as kt
from ..ops.kernels import sweep_fused as ksf
from ..ops.kernels import sweep_packed as sp
from ._timing import card, card_line, emit, median_ms

MODES = ("tiled", "fused_f32", "fused_bf16", "packed_f32", "packed_bf16",
         "check")
ROWS = {"tiled": "tiled_sweep", "fused_f32": "fused_sweep_f32",
        "fused_bf16": "fused_sweep_bf16", "packed_f32": "packed_sweep_f32",
        "packed_bf16": "packed_sweep_bf16"}
# the packed sweep against K4 after 2 sweeps, float32: both round as the
# plain sweep does (0 ulp each on the card), so any difference is a fault;
# the limit leaves room for an ulp of the f32 iterates
CHECK_RTOL = 1e-6


def setup(dev, nz, ny, nx, seed=0):
    """Band stack, pack, state and RHS quads of the CUC-shaped level:
    uniform [0.5, 1.5) values, bands scaled by 0.1 with the diagonal
    lowered by 4, as the JAX script makes them (real_matrix)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    arr = lambda *s: torch.rand(s, generator=g, device=dev) + 0.5
    cA = arr(8, nz, ny + 2, nx + 2) * 0.1
    cA[0] -= 4.0
    pack = rc.build_compact_pack(cA, True)
    return cA, pack, rc.split_quads(arr(nz, ny, nx)), \
        rc.split_quads(arr(nz, ny, nx))


def routes(cA, pack, modes, tj, nchunks):
    """mode -> (one-sweep function of (q, bq), the pack its plain sweep
    uses) for the routes of ``modes``."""
    nz, H, W = cA.shape[1], (cA.shape[2] - 2) // 2, (cA.shape[3] - 2) // 2
    lp = rc.attach_lp(pack) if any(m.endswith("bf16") for m in modes) \
        else None
    out = {}
    if "tiled" in modes:
        # K1 reads the band stack, as the card's K1 levels hold it
        bpk = rc.attach_bands(pack, cA)
        out["tiled"] = (lambda q, bq, n=1: kt.relax_compact_tiled_quads(
            q, bq, bpk, n), pack)
    for name, pk in (("fused_f32", pack), ("fused_bf16", lp)):
        if name in modes:
            # K4 reads the operator as the band stack
            pk = rc.attach_bands(pk, cA)
            out[name] = (lambda q, bq, n=1, pk=pk: ksf.relax_fused_sweep(
                q, bq, pk, n), pk)
    for name, bd, pk in (("packed_f32", None, pack),
                         ("packed_bf16", torch.bfloat16, lp)):
        if name in modes:
            sop = sp.build_sweep_operator(cA, pack, nz, H, W, tj=tj,
                                          nchunks=nchunks, band_dtype=bd)
            out[name] = (lambda q, bq, n=1, sop=sop: sp.relax_packed_sweep(
                q, bq, pack, sop, n), pk)
    return out


def _rel(got, want) -> float:
    return max(float((got[t] - want[t]).abs().max())
               / float(want[t].abs().max()) for t in rc._TKEYS)


def check(dev, nz=4, ny=16, nx=24, tj=2, nchunks=3) -> dict:
    """Every route's one sweep against the plain sweep (relax_compact_
    quads with the route's operator): max |route - plain| / max|plain|
    per mode.  On the CPU the routes run their plain versions."""
    cA, pack, q, bq = setup(torch.device(dev), nz, ny, nx)
    rows = {}
    for mode, (fn, pk) in routes(cA, pack, MODES, tj, nchunks).items():
        rows[mode] = _rel(fn(q, bq),
                          rc.relax_compact_quads(q, bq, pk, 1, "RB", True))
    return rows


def _all_launches() -> dict:
    return {**kt.LAUNCHES, **ksf.LAUNCHES, **sp.LAUNCHES}


def timed(dev=None, nz=64, ny=1024, nx=1024, modes=MODES,
          tj=sp.DEFAULT_TJ, nchunks=sp.DEFAULT_NCHUNKS, reps=20):
    """Time one sweep of each route of ``modes`` on the card.  Returns
    ``(rows, launches)``: the JSON rows (ms, the plan's bytes and, with
    ``check``, the errors) and, per route, the kernels one sweep
    launched (the counters' growth over that sweep; they are never
    reset here)."""
    dev = card(dev)
    print(card_line(), flush=True)
    rows = {}
    cA, pack, q, bq = setup(dev, nz, ny, nx)
    rts = routes(cA, pack, modes, tj, nchunks)
    H, W = ny // 2, nx // 2
    if any(m.startswith("packed") for m in rts):
        emit(rows, "packed_plan", {"tj": tj, "nchunks": nchunks})
        for name, bsz in (("f32", 4), ("bf16", 2)):
            emit(rows, f"packed_needed_gb_{name}", sum(sp.needed_bytes(
                nz, H, W, tj, nchunks, 4, bsz, True).values()) / 1e9)
            emit(rows, f"packed_unique_gb_{name}", sum(sp.unique_bytes(
                nz, H, W, 4, bsz).values()) / 1e9)
            emit(rows, f"packed_design_gb_{name}", sum(sp.design_bytes(
                nz, H, W, tj, nchunks, 4, bsz).values()) / 1e9)
    launches = {}
    for mode, (fn, _) in rts.items():
        before = _all_launches()
        fn(q, bq)
        torch.cuda.synchronize()
        launches[mode] = {k: v - before[k] for k, v in _all_launches().items()
                          if v > before[k]}
    if "check" in modes:
        for mode, (fn, pk) in rts.items():
            if mode != "tiled":
                emit(rows, f"check_{mode}_max_rel", _rel(
                    fn(q, bq), rc.relax_compact_quads(q, bq, pk, 1, "RB",
                                                      True)))
        for b in ("f32", "bf16"):
            if f"packed_{b}" in rts and f"fused_{b}" in rts:
                emit(rows, f"check_packed_vs_fused_{b}_2sweeps_max_rel",
                     _rel(rts[f"packed_{b}"][0](q, bq, 2),
                          rts[f"fused_{b}"][0](q, bq, 2)))
    samples = {m: [] for m in rts}
    order = list(rts)
    for r in range(2):
        for mode in (order if r == 0 else order[::-1]):
            fn = rts[mode][0]
            samples[mode].append(median_ms(lambda: fn(q, bq), reps=reps))
    for mode, ts in samples.items():
        emit(rows, ROWS[mode], statistics.median(ts))
        emit(rows, ROWS[mode] + "_turns", ts)
    return rows, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--tj", type=int, default=sp.DEFAULT_TJ)
    ap.add_argument("--nchunks", type=int, default=sp.DEFAULT_NCHUNKS)
    args = ap.parse_args(argv)
    modes = tuple(args.modes.split(","))
    bad = set(modes) - set(MODES)
    if bad:
        raise SystemExit(f"unknown modes {sorted(bad)}; choose from {MODES}")
    rows, launches = timed(None, args.nz, args.ny, args.nx, modes, args.tj,
                           args.nchunks)
    print(json.dumps({"launches": launches}))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
