"""The multi-device layer: a single-controller port of
``mgroms_tpu/parallel`` (mesh plan, halo exchange, shard_map backend,
distributed physics).  One process drives every tile of the mesh."""

from .mesh import MeshPlan, Tiles, make_mesh, shard_map     # noqa: F401
from .backend import DistributedBackend                      # noqa: F401
from .exchange import block_extended, halo_extend            # noqa: F401
from .shardmap_backend import (                              # noqa: F401
    ShardMapBackend, shard_operators_blocked)
from .physics import DistributedPhysics                      # noqa: F401
