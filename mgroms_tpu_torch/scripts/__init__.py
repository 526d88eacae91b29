"""The level-0 smoother micro-benchmarks (``python -m
mgroms_tpu_torch.scripts.<name>``): micro_sweep_fused, micro_packed_parts,
micro_roofline."""
