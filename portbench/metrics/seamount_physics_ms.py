"""seamount_physics_ms: device ms a step in the physics layer, CUDA events
around ``NHModel.rhs`` and ``NHModel.project``, the mean over the window's
steps, in the seamount cell, whose fields are twice CUC's (the reader of
physics_ms)."""

from portbench import harness

read = harness.metric_reader("physics_ms")
