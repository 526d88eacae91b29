"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""

from .relax_fused import fused_relax                      # noqa: F401
from .stencil_tiled import residual_tiled                 # noqa: F401
from .relax_tiled import relax_compact_tiled_quads        # noqa: F401
from .sweep_fused import relax_fused_sweep                 # noqa: F401
