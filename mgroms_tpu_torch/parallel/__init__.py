"""The multi-device layer: a single-controller port of
``mgroms_tpu/parallel`` (mesh plan, halo exchange, the GSPMD and
shard_map backends, distributed physics).  One process drives every tile of the
mesh."""

from .mesh import (MeshPlan, Replicated, Tiles, make_mesh,  # noqa: F401
                   shard_map)
from .backend import DistributedBackend, shard_operators     # noqa: F401
from .exchange import block_extended, halo_extend            # noqa: F401
from .shardmap_backend import (                              # noqa: F401
    ShardMapBackend, shard_operators_blocked)
from .physics import DistributedPhysics                      # noqa: F401
