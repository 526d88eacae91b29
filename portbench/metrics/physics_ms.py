"""physics_ms: device ms a step in the physics layer (ops/rhs.py and
ops/projection.py): CUDA events around ``NHModel.rhs`` and
``NHModel.project``, the mean over the window's steps."""


def read(ctx):
    if not ctx.physics_ms:
        return None
    return sum(ctx.physics_ms) / len(ctx.physics_ms)
