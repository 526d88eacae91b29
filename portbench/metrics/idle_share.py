"""idle_share: the share of the traced segment's wall time in which no
operation ran on the device, 1 - busy / wall, in % (``torch.profiler``;
the profiler's own cost is in the wall, so this is an upper bound)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
