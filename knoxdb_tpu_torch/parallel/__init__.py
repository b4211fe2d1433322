"""Multi-shard scans and the shuffle join over a device Mesh (the port of
knoxdb_tpu.parallel)."""

from .engine_spmd import ShardedScanner, is_uniform_segment
from .mesh import Mesh
from .multihost import attach, hybrid_mesh, initialize_from_env
from .shard import make_mesh, shard_packs, sharded_range_scan
from .shuffle import shuffle_join, shuffle_join_rows

__all__ = ["Mesh", "make_mesh", "shard_packs", "sharded_range_scan",
           "ShardedScanner", "is_uniform_segment", "shuffle_join_rows",
           "shuffle_join", "initialize_from_env", "hybrid_mesh", "attach"]
