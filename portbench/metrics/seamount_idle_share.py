"""seamount_idle_share: the share of the traced segment's wall time in
which no operation ran on the device, in %, in the seamount cell (the
reader of idle_share)."""

from portbench import harness

read = harness.metric_reader("idle_share")
