"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

Each kernel module counts, in its ``LAUNCHES``, the launches its wrappers
enqueue on the card, and names in ``GRAPH_NAMES`` (pattern, key) the
kernel functions behind each count, as a CUDA graph's kernel nodes show
them (demangled; the first pattern that matches counts): capture.py
counts a replayed graph's launches from its nodes.  ``MODULES`` lists
every such module.
"""

import re
from typing import Optional

from . import (device_loop, dma_probe, rdma_halo, relax_fused,  # noqa: F401
               relax_tiled, rhs_fused, roofline, stencil_tiled, sweep_fused,
               sweep_packed)
from .relax_fused import fused_relax                      # noqa: F401
from .stencil_tiled import residual_tiled                 # noqa: F401
from .relax_tiled import relax_compact_tiled_quads        # noqa: F401
from .sweep_fused import relax_fused_sweep                 # noqa: F401

MODULES = (relax_tiled, stencil_tiled, relax_fused, sweep_fused,
           sweep_packed, roofline, rdma_halo, dma_probe, device_loop,
           rhs_fused)


def launches() -> dict:
    """Every kernel's launch count, by its ``LAUNCHES`` key."""
    return {k: v for mod in MODULES for k, v in mod.LAUNCHES.items()}


def reset_launches() -> None:
    for mod in MODULES:
        mod.reset_launches()


def set_launches(counts: dict) -> None:
    """Every count as in ``counts`` (a :func:`launches` result)."""
    for mod in MODULES:
        mod.LAUNCHES.update({k: counts[k] for k in mod.LAUNCHES})


def add_launches(counts: dict, times: int = 1) -> None:
    """``times`` x ``counts`` (key -> launches) onto the counters."""
    for mod in MODULES:
        for k in mod.LAUNCHES.keys() & counts.keys():
            mod.LAUNCHES[k] += counts[k] * times


_KEYS = [(re.compile(pat), key) for mod in MODULES
         for pat, key in getattr(mod, "GRAPH_NAMES", ())]


def kernel_key(name: str) -> Optional[str]:
    """The ``LAUNCHES`` key of the kernel function ``name`` (a graph
    node's demangled name), None for a kernel of no module here (a
    PyTorch operation's)."""
    for pat, key in _KEYS:
        if pat.search(name):
            return key
    return None
