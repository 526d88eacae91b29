"""sweep_planes_in_flight: the planes K4's staging keeps in flight on an SM
at the largest level it sweeps, blocks an SM x the ring's depth (planes
staged ahead of the solved one) of the launch plan the program recorded at
that level's first launch (``ops/kernels/sweep_fused.PLANS``); none where
the program records no plan (a run off the card) or no depth in it (a
program whose ring has a fixed depth).

Read as sweep_resident_warps reads its plan: the record is the process's,
and ``python3 -m portbench.run`` runs one cell a process, whose level 0 is
the largest shape recorded."""


def read(ctx):
    from mgroms_tpu_torch.ops.kernels import sweep_fused
    plans = getattr(sweep_fused, "PLANS", None)
    if not plans:
        return None
    plan = plans[max(plans, key=lambda k: k[0][0] * k[0][1] * k[0][2])]
    ahead = plan.get("planes_ahead")
    return None if ahead is None else plan["blocks_per_sm"] * ahead
