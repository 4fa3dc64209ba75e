"""Distributed execution over a mesh of shards (`parallel/mesh.py`).

Counterpart of `datafusion_tpu/parallel/__init__.py`: partitions are the
mesh's shards (of one card, or the ranks of a process group), the hash
exchange is the mesh's collectives around the port's kernels K1 and K2
(`device/exchange.py`), and aggregation is two-phase: a partial table a
shard, then each shard's owned groups (`hash(key) % n_shards`).
"""
from .distributed import (  # noqa: F401
    distributed_group_aggregate, distributed_join_aggregate,
    distributed_join_group_aggregate,
)
from .exchange import (  # noqa: F401
    distributed_partitioned_join_aggregate,
    distributed_shuffle_group_aggregate,
)
from .mesh import LocalMesh, ProcessGroupMesh, make_mesh  # noqa: F401
