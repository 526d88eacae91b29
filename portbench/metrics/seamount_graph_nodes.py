"""seamount_graph_nodes: the nodes of the CUDA graph a solve replays, one
convergence step (``capture.CapturedStep.nodes``), in the seamount cell,
whose F-cycle visits 7 levels (the reader of graph_nodes)."""

from portbench import harness

read = harness.metric_reader("graph_nodes")
