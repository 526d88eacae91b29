"""seamount_fcycles_per_solve: F-cycles a solve ran to the tolerance
(``SolveInfo.niter``), the mean over the window's steps, in the seamount
cell, whose cells, wider in z than in x, are the z-line smoother's weak
regime (the reader of fcycles_per_solve)."""

from portbench import harness

read = harness.metric_reader("fcycles_per_solve")
