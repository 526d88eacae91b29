"""solve_ms: device ms a step in the outer loop (``solver.solve_p`` and the
replayed graph under it): CUDA events around ``NHModel.pressure_solve``,
the mean over the window's steps.  The span covers the host's reads of the
residual norm, during which the stream waits."""


def read(ctx):
    if not ctx.solve_ms:
        return None
    return sum(ctx.solve_ms) / len(ctx.solve_ms)
