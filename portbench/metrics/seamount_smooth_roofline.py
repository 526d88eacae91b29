"""seamount_smooth_roofline: the smoothing sweeps' least time over the
device time of the kernels that did them, in the traced solves, in %, in
the seamount cell, whose level-0 K4 sweeps 128-plane columns under a
launch plan of its own (the reader of smooth_roofline)."""

from portbench import harness

read = harness.metric_reader("smooth_roofline")
