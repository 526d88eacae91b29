"""seamount_solve_ms: device ms a step in the outer loop, CUDA events
around ``NHModel.pressure_solve``, the mean over the window's steps, in
the seamount cell (the reader of solve_ms)."""

from portbench import harness

read = harness.metric_reader("solve_ms")
