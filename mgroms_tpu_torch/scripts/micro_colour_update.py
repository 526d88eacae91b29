"""K1 and K2 (csrc/relax_tiled.cu, a colour a launch) at the CUC level-0
quads (64, 512, 512), timed on the card beside their bounds, on the band
stack and on the gather blocks:

  k1_rb_{layout}_ms                  K1 on one RB colour (both targets;
                                     the Thomas multipliers recomputed)
  k1_rb_{layout}_two_launches_ms     the same two targets as two
                                     one-target launches (the FC form)
  k1_fc_{layout}_ms                  K1 on one FC colour (one target; the
                                     multipliers in shared memory)
  k1_rb_bf16_{layout}_ms             K1 on the bfloat16 operator
  k2_rb_{layout}_ms                  K2 on one RB colour
  *_bound_ms, *_gb                   what cost() counts: every input read
                                     once, every output written once

    python -m mgroms_tpu_torch.scripts.micro_colour_update [--nz --H --W]

:func:`check` runs on any device (the kernels against their plain
versions on the card, the plain versions alone elsewhere); :func:`timed`
needs a card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import relax_compact as rc
from ..ops.kernels import relax_tiled as kt
from ..ops.kernels import sweep_fused as ksf
from ._timing import card, card_line, emit, median_ms

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak
F32_FLOPS = 67e12                # float32 outside the tensor cores
RB0, RB1 = rc.colour_targets("RB")
FC0 = rc.colour_targets("FC")[1]


def inputs(dev, nz, H, W, dtype=torch.float32, layout="bands", lp=False,
           real=True, seed=0):
    """A random diagonally dominant level (pack in ``layout``, with the
    low-precision operator when ``lp``), its four extended state quads
    and the RHS quads, made on ``dev`` from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=dev, dtype=dtype)
    cA = 0.2 * u(8, nz, 2 * H + 2, 2 * W + 2) - 0.1
    cA[0] -= 4.0
    build = rc.build_band_pack if layout == "bands" else rc.build_compact_pack
    pack = build(cA, real)
    if lp:
        pack = rc.attach_lp(pack)
    del cA
    e = rc.extend_quads(rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1))
    bq = rc.split_quads(2 * u(nz, 2 * H, 2 * W) - 1)
    return pack, e, bq


def cost(pack, targets, emit_=False, dtype=torch.float32):
    """``(bytes, flops)`` of one colour update: every input read once,
    every output written once — the operator as the launch reads it (the
    band quads the targets' terms touch, planes 1..nz of each, and the
    'real' terms' extra quads at one plane; or the targets' gather blocks
    and 'real' pairs), the two sibling quads the base terms read, the
    diagonal siblings' plane 0 ('real'), bq, ud, bet (K2: d) and the new
    quads (K2: the residuals).  Flops per point and target: the 12-term
    gather (23), the RHS (1), the Thomas substitution (6); 8 per column
    for the 'real' terms; K2 7 more per point."""
    layout, holder, _, band = kt.colour_operator(pack, dtype, emit_)
    nz, H, W = pack.d[0].shape
    vb = torch.empty((), dtype=band).element_size()
    vs = torch.empty((), dtype=dtype).element_size()
    ep = (H + 2) * (W + 2)
    real = pack.real_matrix
    tabs = [ksf.band_term_table(t) for t in targets]
    if layout == "bands":
        base = {r[0] for tt in tabs for r in tt[:12]}
        extra = {r[0] for tt in tabs for r in tt[12:]} - base if real \
            else set()
        op = (len(base) * nz + len(extra)) * ep * vb
    else:
        op = len(targets) * (12 * nz + (2 if real else 0)) * H * W * vb
    state = 2 * nz * ep * vs + (len(targets) * ep * vs if real else 0)
    per = (4 + 2 * emit_) * nz - 1
    n = nz * H * W
    flops = len(targets) * ((30 + 7 * emit_) * n + (8 * H * W if real
                                                     else 0))
    return op + state + len(targets) * per * H * W * vs, flops


def bound_ms(nbytes, flops) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def check(dev, nz=4, H=5, W=70) -> dict:
    """Every colour of both orderings (K1) and the RB colours (K2), on both
    layouts, f32 and (K1) bfloat16: max |kernel - plain|."""
    dev = torch.device(dev)
    rows = {}
    for layout in ("bands", "blocks"):
        for lp in (False, True):
            pack, e, bq = inputs(dev, nz, H, W, layout=layout, lp=lp)
            for colour in rc.colour_targets("RB") + rc.colour_targets("FC"):
                got = kt.color_update(e, bq, pack, colour)
                want = kt.color_update_plain(e, bq, pack, colour)
                key = f"k1_{layout}{'_bf16' if lp else ''}_{colour}"
                rows[key] = max(float((got[t] - want[t]).abs().max())
                                for t in colour)
                if len(colour) == 2 and not lp:
                    gs, gr = kt.color_update_emit(e, bq, pack, colour)
                    ws, wr = kt.color_update_emit_plain(e, bq, pack, colour)
                    rows[f"k2_{layout}_{colour}"] = max(
                        float((x[t] - y[t]).abs().max())
                        for x, y in ((gs, ws), (gr, wr)) for t in colour)
    return rows


def _timed_row(rows, name, fn, pack, targets, emit_=False,
               dtype=torch.float32, reps=20):
    ms = median_ms(fn, reps=reps)
    nb, fl = cost(pack, targets, emit_, dtype)
    emit(rows, f"{name}_ms", ms)
    emit(rows, f"{name}_bound_ms", bound_ms(nb, fl))
    emit(rows, f"{name}_gb", nb / 1e9)
    return ms


def timed(dev=None, nz=64, H=512, W=512, reps=20) -> dict:
    """The rows of the module docstring at quad shape (nz, H, W)."""
    dev = card(dev)
    print(card_line(), flush=True)
    rows = {}
    for layout in ("bands", "blocks"):
        pack, e, bq = inputs(dev, nz, H, W, layout=layout)
        _timed_row(rows, f"k1_rb_{layout}",
                   lambda: kt.color_update(e, bq, pack, RB0), pack, RB0,
                   reps=reps)
        _timed_row(rows, f"k2_rb_{layout}",
                   lambda: kt.color_update_emit(e, bq, pack, RB1), pack,
                   RB1, True, reps=reps)
        _timed_row(rows, f"k1_fc_{layout}",
                   lambda: kt.color_update(e, bq, pack, FC0), pack, FC0,
                   reps=reps)
        _timed_row(rows, f"k1_rb_{layout}_two_launches",
                   lambda: [kt.color_update(e, bq, pack, (t,))
                            for t in RB0], pack, RB0, reps=reps)
        del pack
        pack, e, bq = inputs(dev, nz, H, W, layout=layout, lp=True)
        _timed_row(rows, f"k1_rb_bf16_{layout}",
                   lambda: kt.color_update(e, bq, pack, RB0), pack, RB0,
                   reps=reps)
        del pack, e, bq
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--H", type=int, default=512)
    ap.add_argument("--W", type=int, default=512)
    args = ap.parse_args(argv)
    print(json.dumps({"check": check("cuda")}))
    print(json.dumps(timed(None, args.nz, args.H, args.W)))


if __name__ == "__main__":
    main()
