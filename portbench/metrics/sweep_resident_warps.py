"""sweep_resident_warps: the warps K4 keeps resident on an SM at the
largest level it sweeps, threads a block / 32 x blocks an SM of the
launch plan the program recorded at that level's first launch
(``ops/kernels/sweep_fused.PLANS``); none where the program records no
plan (a run off the card, or a program without the record).

The record is the process's since the program's last
``kernels.reset_launches()``, and the harness resets nothing: the
reading is the run's own because ``python3 -m portbench.run`` runs one
cell a process, whose level 0 is the largest shape recorded.  ``ctx``
holds no level shapes to pick the run's level 0 by."""


def read(ctx):
    from mgroms_tpu_torch.ops.kernels import sweep_fused
    plans = getattr(sweep_fused, "PLANS", None)
    if not plans:
        return None
    plan = plans[max(plans, key=lambda k: k[0][0] * k[0][1] * k[0][2])]
    return plan["threads"] // 32 * plan["blocks_per_sm"]
