"""Benchmark drivers as runnable modules — the reference's three built
programs (``testseamount``, ``testrndtopo``, ``testcuc``;
src/Makefile.am:30-33):

    python -m mgroms_tpu_torch.drivers.seamount [--nx 64 ...]
    python -m mgroms_tpu_torch.drivers.rndtopo [--seed 0]
    python -m mgroms_tpu_torch.drivers.cuc [--data cuc_nhgrd.nc]

Each takes ``--device cpu`` (the plain versions), ``--npx/--npy/--comm``
(a mesh) and ``--profile`` (the per-level tictoc table).
"""
