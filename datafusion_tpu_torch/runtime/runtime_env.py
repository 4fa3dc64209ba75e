"""RuntimeEnv + TaskContext.

Reference parity: `datafusion/execution/src/runtime_env.rs:46` and
`task.rs:41`. RuntimeEnv owns cross-query resources (memory pool, device
mesh); TaskContext is the per-query view handed to every operator's
execute().
"""
from __future__ import annotations

from typing import Optional

from .memory import MemoryPool, UnboundedMemoryPool


class RuntimeEnv:
    def __init__(self, memory_pool: Optional[MemoryPool] = None, mesh=None,
                 disk_manager=None, object_store_registry=None,
                 cache_manager=None):
        self.memory_pool = memory_pool or UnboundedMemoryPool()
        # jax.sharding.Mesh for distributed execution (None = single chip)
        self.mesh = mesh
        # DiskManager enables operator spilling; None = spilling disabled
        # (queries fail with ResourcesExhausted instead)
        self.disk_manager = disk_manager
        if object_store_registry is None:
            from ..datasource.object_store import ObjectStoreRegistry
            object_store_registry = ObjectStoreRegistry()
        self.object_store_registry = object_store_registry
        if cache_manager is None:
            from .cache_manager import CacheManager
            cache_manager = CacheManager()
        self.cache_manager = cache_manager


class TaskContext:
    def __init__(self, config=None, runtime: Optional[RuntimeEnv] = None,
                 session_id: str = "", task_id: str = ""):
        from ..common.config import ConfigOptions
        self.config = config or ConfigOptions()
        self.runtime = runtime or RuntimeEnv()
        self.session_id = session_id
        self.task_id = task_id
        # per-query common-subtree result cache (CTE re-execution dedup):
        # identical device-aggregate subtrees over the same source tables
        # run once per query (the reference inlines non-recursive CTEs and
        # re-executes them; we keep the inlining but share the result)
        self.subtree_cache = {}

    @property
    def memory_pool(self) -> MemoryPool:
        return self.runtime.memory_pool
