"""smooth_roofline: the smoothing sweeps' least time (the bytes they need
in the reference's storage over the card's published bandwidth) over the
device time of the kernels that did them, in the traced solves, in %
(``work.py``)."""

from portbench import work


def read(ctx):
    return work.roofline_share(ctx, "smooth")
