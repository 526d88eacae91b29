"""graph_nodes: the nodes of the CUDA graph a solve replays, one
convergence step (``capture.CapturedStep.nodes``); none where the solve
replays no graph."""


def read(ctx):
    return None if ctx.census is None else ctx.census["nodes"]
