"""seamount_residual_restrict_roofline: the fused residual-and-restriction's
least time over the device time of the kernels that did it, in the traced
solves, in %, in the seamount cell, whose K3 reads 128-plane columns (the
reader of residual_restrict_roofline)."""

from portbench import harness

read = harness.metric_reader("residual_restrict_roofline")
