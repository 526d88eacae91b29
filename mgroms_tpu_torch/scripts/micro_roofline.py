"""Roofline decomposition of the CUC level-0 colour update (quads (64, 512,
512), float32), timed on the card.  Port of ``scripts/micro_roofline.py``;
rows under the JAX script's names:

  update_real_ms                 K1 (relax_tiled.color_update) on one
                                 target quad, 'real', gather blocks: the
                                 one-target launch (an FC colour's form),
                                 as the JAX script times K1; the card's
                                 RB route launches K1 a colour at a time
                                 on the band stack (the update_rb rows)
  dma_only_{all,windows,blocks}_ms  K10 dma_only: those loads alone
  update_real_bf16_ms,           the same two on bfloat16 blocks (K1 in
  dma_only_{all,blocks}_bf16_ms  perf mode; rows the JAX script lacks)
  bytes_{windows,blocks,pivots}_mb  what those loads move
  update_rb_bands{,_bf16}_ms     K1 on one RB colour (both targets, one
                                 launch) on the float32 / bfloat16 band
                                 stack, as the card's RB route runs it
  dma_only_bands{,_bf16}_ms      K10 dma_only_bands: its loads alone, in
                                 its launch shape (rows the JAX script
                                 lacks)
  bytes_bands{,_bf16}_mb         what those loads move
  update_emit_ms                 K2 (color_update_emit) on one RB colour,
                                 two target quads (no one-target form)
  patch_zsum_epilogue_ms,        the emitted residual's patch and z-pair
  patch_zsum_zfirst_ms           sum (relax_compact, plain torch)
  fresh_residual_one_target_ms   extend_quads + one fresh target residual
  rr_four_targets_ms             extend_quads + K3 (residual_restrict: the
                                 coarse RHS of all four targets, one
                                 launch, on the gather blocks)
  fma_gflops                     K10 fma_run: the measured float32 FMA rate
  gather_flops_per_update_gflop, the colour update's flops, and their time
  implied_pure_flop_ms           at the measured rate
  mxu_dot16_ms, ew_sum16_ms      the gather as (points x 16) . (16)
                                 contractions: torch.bmm against an
                                 elementwise multiply and sum
  step_floor_{nz}x{ny}x{nx}_{steps}[_cluster]_ms
                                 K10 step_floor at K6's one-launch shapes
                                 (roofline.STEP_FLOOR_CASES), one block
                                 or a cluster (rows the JAX script lacks)

    python -m mgroms_tpu_torch.scripts.micro_roofline

:func:`check` runs on any device; :func:`timed` needs a card.
"""

from __future__ import annotations

import json

import torch

from ..ops import relax_compact as rc
from ..ops.kernels import relax_tiled as kt
from ..ops.kernels import roofline as rl
from . import micro_colour_update as mcu
from ._timing import card, card_line, emit, median_ms


def operands(dev, nz, H, W, seed=0):
    """K1's float32 operands at quad shape (nz, H, W), uniform [0.5, 1.5)
    as the JAX script makes them: e3, bq, blocks, ud, bet, gam, rb, d."""
    g = torch.Generator(device=dev).manual_seed(seed)
    arr = lambda *s: torch.rand(s, generator=g, device=dev) + 0.5
    return dict(blocks=arr(nz, H, 12 * W), rb=arr(1, H, 2 * W),
                ud=arr(nz - 1, H, W), bet=arr(nz, H, W),
                gam=arr(nz - 1, H, W), bq=arr(nz, H, W),
                e3=tuple(arr(nz, H + 2, W + 2) for _ in range(3)),
                d=arr(nz, H, W))


def check(dev, nz=4, H=6, W=40) -> dict:
    """``dma_only`` in its three variants (with gam and the 'real' pair)
    and ``fma_run`` against their plain versions: max |difference|
    (dma_only) and max |difference| / max|plain| (fma_run)."""
    dev = torch.device(dev)
    o = operands(dev, nz, H, W)
    rows = {}
    for which in rl.WHICH:
        args = (o["e3"], o["bq"], o["blocks"], o["ud"], o["bet"], o["gam"],
                which, o["rb"])
        rows[f"dma_only_{which}"] = float(
            (rl.dma_only(*args) - rl.dma_only_plain(*args)).abs().max())
    x = torch.rand(rl.FMA_BLOCK, device=dev) + 0.5
    want = rl.fma_run_plain(x)
    rows["fma_run"] = float((rl.fma_run(x) - want).abs().max()
                            / want.abs().max())
    colour = rc.colour_targets("RB")[0]
    for lp in (False, True):
        pack, e, bq4 = mcu.inputs(dev, nz, H, W, lp=lp)
        got = rl.dma_only_bands(e, bq4, pack, colour)
        want = rl.dma_only_bands_plain(e, bq4, pack, colour)
        rows["dma_only_bands" + ("_bf16" if lp else "")] = max(
            float((got[t] - want[t]).abs().max()) for t in colour)
    return rows


def step_floor_key(shape, nsteps: int, cluster: bool) -> str:
    """The row of step_floor at ``shape`` and ``nsteps``."""
    return ("step_floor_" + "x".join(map(str, shape)) + f"_{nsteps}"
            + ("_cluster" if cluster else "") + "_ms")


def timed(dev=None, nz=64, H=512, W=512, reps=20) -> dict:
    """The rows of the module docstring at quad shape (nz, H, W)."""
    dev = card(dev)
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 bmm
    rows = {}
    o = operands(dev, nz, H, W)
    e3, bq, blocks, ud, bet, gam, rb, d = (
        o[k] for k in ("e3", "bq", "blocks", "ud", "bet", "gam", "rb", "d"))
    t = rl.TARGET
    ms = lambda fn: median_ms(fn, reps=reps)
    # K1 on target t alone reads its three siblings (the fourth quad of
    # the launch's extended state is not read); every target of the pack
    # holds the same operator
    e = dict(zip(kt.gather_quads(t), e3))
    e[t] = e3[0]
    bqs = {k: bq for k in rc._TKEYS}
    pack1 = rc.CompactPack(blocks=(blocks,) * 4, d=(d,) * 4, ud=(ud,) * 4,
                           bet=(bet,) * 4, real_matrix=True,
                           rblocks=(rb,) * 4)
    emit(rows, "update_real_ms", ms(
        lambda: kt.color_update(e, bqs, pack1, (t,))))
    for which in rl.WHICH:
        emit(rows, f"dma_only_{which}_ms", ms(
            lambda: rl.dma_only(e3, bq, blocks, ud, bet, None, which, rb)))
    b16, rb16 = blocks.to(torch.bfloat16), rb.to(torch.bfloat16)
    pack16 = pack1._replace(lp=rc.LowPrecision(
        blocks=(b16,) * 4, rblocks=(rb16,) * 4, bet=(bet,) * 4))
    emit(rows, "update_real_bf16_ms", ms(
        lambda: kt.color_update(e, bqs, pack16, (t,))))
    for which in ("all", "blocks"):
        emit(rows, f"dma_only_{which}_bf16_ms", ms(
            lambda: rl.dma_only(e3, bq, b16, ud, bet, None, which, rb16)))
    del b16, rb16, pack16
    colour = rc.colour_targets("RB")[0]
    for lp in (False, True):
        sfx = "_bf16" if lp else ""
        pack, eb, bqb = mcu.inputs(dev, nz, H, W, lp=lp)
        emit(rows, f"update_rb_bands{sfx}_ms", ms(
            lambda: kt.color_update(eb, bqb, pack, colour)))
        emit(rows, f"dma_only_bands{sfx}_ms", ms(
            lambda: rl.dma_only_bands(eb, bqb, pack, colour)))
        emit(rows, f"bytes_bands{sfx}_mb",
             rl.dma_only_bands_bytes(nz, H, W, colour, lp) / 1e6)
        del pack, eb, bqb
        torch.cuda.empty_cache()
    emit(rows, "bytes_windows_mb", 3 * nz * (H + 2) * (W + 2) * 4 / 1e6)
    emit(rows, "bytes_blocks_mb", (nz * H * 12 * W + 2 * H * W) * 4 / 1e6)
    # ud + bet + bq, as K1 loads them (the JAX row also counted gam)
    emit(rows, "bytes_pivots_mb", ((nz - 1) + 2 * nz) * H * W * 4 / 1e6)
    emit(rows, "update_emit_ms", ms(
        lambda: kt.color_update_emit(e, bqs, pack1, (t, (1 - t[0],
                                                         1 - t[1])))))
    q4 = {k: torch.rand((nz, H, W), device=dev) + 0.5 for k in rc._TKEYS}
    r_raw = torch.rand((nz, H, W), device=dev) + 0.5

    def epilogue():
        e2 = rc.extend_quads(q4)
        r = rc._patch_emitted_residual(e2, bq, pack1, 1, (0, 1), True, r_raw)
        return r[0::2] + r[1::2]

    emit(rows, "patch_zsum_epilogue_ms", ms(epilogue))
    emit(rows, "patch_zsum_zfirst_ms", ms(lambda: rc._patched_zsum(
        rc.extend_quads(q4), bq, pack1, 1, (0, 1), True, r_raw)))
    emit(rows, "fresh_residual_one_target_ms", ms(lambda: rc._residual_one(
        rc.extend_quads(q4), bq, pack1, 0, (0, 0), True)))

    def rr_four():
        e2 = rc.extend_quads(q4)
        return kt.residual_restrict(tuple(e2[k] for k in rc._TKEYS), q4,
                                    pack1)

    emit(rows, "rr_four_targets_ms", ms(rr_four))
    # the JAX script's vpu_fma_gflops: here the card's float32 FMA rate
    x = torch.rand(rl.FMA_BLOCK, device=dev) + 0.5
    emit(rows, "fma_gflops",
         rl.fma_flops() / (ms(lambda: rl.fma_run(x)) * 1e-3) / 1e9)
    # base gather 12 mul + 11 add, rhs 1, 'real' plane-0 terms ~9/nz,
    # Thomas substitution ~5 (micro_roofline.py:287-291)
    total = (12 + 11 + 1 + 5 + 9.0 / nz) * nz * H * W
    emit(rows, "gather_flops_per_update_gflop", total / 1e9)
    emit(rows, "implied_pure_flop_ms", total / (rows["fma_gflops"] * 1e6))
    P = nz * H * W // 64
    b16 = torch.rand((P, 16), device=dev) + 0.5
    s16 = torch.rand((P, 16), device=dev) + 0.5
    emit(rows, "mxu_dot16_ms", ms(
        lambda: torch.bmm(b16[:, None, :], s16[:, :, None])[:, 0, 0]))
    emit(rows, "ew_sum16_ms", ms(lambda: (b16 * s16).sum(dim=1)))
    for shape, nsteps, cluster in rl.STEP_FLOOR_CASES:
        xs = torch.rand(shape, device=dev) + 0.5
        emit(rows, step_floor_key(shape, nsteps, cluster), ms(
            lambda: rl.step_floor(xs, nsteps, cluster)))
    return rows


def main(argv=None):
    print(json.dumps(timed()))


if __name__ == "__main__":
    main()
