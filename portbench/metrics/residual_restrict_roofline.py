"""residual_restrict_roofline: the fused residual-and-restriction's least
time (the bytes it needs in the reference's storage over the card's
published bandwidth) over the device time of the kernels that did it, in
the traced solves, in % (``work.py``)."""

from portbench import work


def read(ctx):
    return work.roofline_share(ctx, "residual_restrict")
