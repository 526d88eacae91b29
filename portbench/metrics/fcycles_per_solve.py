"""fcycles_per_solve: F-cycles a solve ran to the tolerance
(``SolveInfo.niter``), the mean over the window's steps."""


def read(ctx):
    if not ctx.niters:
        return None
    return sum(ctx.niters) / len(ctx.niters)
