"""String-keyed, introspectable config registry.

Reference parity: `ConfigOptions` + `config_namespace!`
(`datafusion/common/src/config.rs:106,638`). Keys mirror the reference's
names (``datafusion.execution.batch_size`` etc.) so SET / SHOW ALL behave the
same; the port's own knobs under ``datafusion.tpu.*`` (``mesh_devices``,
``auto_mesh_min_bytes``, ``device_aggregate``,
``device_join_rows_min_spine``, ``device_sort_min_rows``,
``device_window_min_rows``) keep the JAX
package's names so that one SET script drives both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from .errors import PlanError

# (key, default, type, description)
_OPTIONS: List[Tuple[str, Any, type, str]] = [
    # --- execution ---
    ("datafusion.execution.use_symmetric_hash_join", False, bool,
     "execute equi-joins with SymmetricHashJoinExec (incremental two-way "
     "probe with interval state pruning) instead of build/probe hash join"),
    ("datafusion.catalog.has_header", False, bool,
     "default CSV header inference for CREATE EXTERNAL TABLE"),
    ("datafusion.catalog.default_catalog", "datafusion", str,
     "catalog unqualified table names resolve into (reference: "
     "config.rs CatalogOptions.default_catalog)"),
    ("datafusion.catalog.default_schema", "public", str,
     "schema unqualified table names resolve into (reference: "
     "config.rs CatalogOptions.default_schema)"),
    ("datafusion.catalog.information_schema", False, bool,
     "expose information_schema virtual tables and SHOW statements "
     "(reference: config.rs CatalogOptions.information_schema, default "
     "false; the CLI enables it at startup like datafusion-cli)"),
    ("datafusion.execution.batch_size", 131072, int,
     "Target rows per device batch (tile capacity). Larger than the "
     "reference's 8192 because TPU kernels amortize launch overhead over "
     "big tiles."),
    ("datafusion.execution.target_partitions", 0, int,
     "Number of partitions (0 = number of local devices)."),
    ("datafusion.execution.time_zone", "+00:00", str,
     "Session time zone: TIMESTAMPTZ literals/casts interpret naive wall "
     "times in this zone and render with its offset (reference: "
     "config.rs execution.time_zone)."),
    ("datafusion.sql_parser.support_varchar_with_length", True, bool,
     "Accept VARCHAR(n)/CHAR(n) (the length is ignored, like the "
     "reference); when false such types are rejected."),
    ("datafusion.sql_parser.parse_float_as_decimal", False, bool,
     "Type float literals (2.5) as exact Decimal128 instead of Float64 "
     "(reference: config.rs:198, default false)."),
    ("datafusion.execution.enable_recursive_ctes", True, bool,
     "Allow WITH RECURSIVE queries (reference: config.rs)."),
    ("datafusion.execution.parallel_host_streams", True, bool,
     "Pull independent partitions on concurrent threads (numpy releases "
     "the GIL, so host-path operators overlap across cores like the "
     "reference's one-task-per-partition tokio runtime)."),
    ("datafusion.execution.collect_statistics", True, bool,
     "Collect table statistics at registration."),
    ("datafusion.execution.memory_limit_bytes", 0, int,
     "Per-query HBM budget in bytes (0 = unlimited)."),
    ("datafusion.execution.parquet.pushdown_filters", True, bool,
     "Prune parquet row groups with predicate min/max stats."),
    ("datafusion.execution.parquet.enable_page_index", True, bool,
     "Use page-level pruning when available."),
    ("datafusion.execution.parquet.bloom_filter_on_read", True, bool,
     "Prune parquet row groups with bloom filters on equality predicates."),
    ("datafusion.execution.parquet.bloom_filter_on_write", False, bool,
     "Write split-block bloom filters for every column on COPY/write."),
    # --- optimizer ---
    ("datafusion.optimizer.max_passes", 3, int,
     "Max passes over the logical optimizer rule list."),
    ("datafusion.optimizer.prefer_hash_join", True, bool,
     "Prefer hash join over sort-merge join."),
    ("datafusion.optimizer.hash_join_single_partition_threshold", 1048576, int,
     "Broadcast (CollectLeft) a build side smaller than this many bytes."),
    ("datafusion.optimizer.hash_join_single_partition_threshold_rows", 131072, int,
     "Broadcast a build side smaller than this many rows."),
    ("datafusion.optimizer.repartition_joins", True, bool,
     "Allow shuffling both join sides."),
    ("datafusion.optimizer.repartition_aggregations", True, bool,
     "Allow two-phase partial/final aggregation."),
    ("datafusion.optimizer.repartition_sorts", True, bool,
     "Sort per partition, then k-way merge."),
    ("datafusion.optimizer.default_filter_selectivity", 20, int,
     "Assumed filter selectivity percent when stats are absent."),
    ("datafusion.optimizer.skip_failed_rules", False, bool,
     "Continue when an optimizer rule errors."),
    # --- sql ---
    ("datafusion.sql_parser.enable_ident_normalization", True, bool,
     "Lowercase unquoted identifiers."),
    ("datafusion.sql_parser.dialect", "generic", str, "SQL dialect."),
    # --- explain ---
    ("datafusion.explain.logical_plan_only", False, bool, ""),
    ("datafusion.explain.physical_plan_only", False, bool, ""),
    ("datafusion.explain.show_statistics", False, bool, ""),
    # --- device ---
    ("datafusion.tpu.mesh_devices", 0, int,
     "Shard Single-mode aggregates and join-aggregates over a mesh of N "
     "shards (0 = off): a LocalMesh of N shards on the session's device, "
     "or the session's own mesh when it has N (parallel/mesh.py)."),
    ("datafusion.tpu.auto_mesh_min_bytes", 4 << 30, int,
     "Stats-driven mesh participation: when a query's resident source "
     "bytes reach this and the session spans more than one device (CUDA "
     "cards, or a CPU session's given mesh), shard over all of them "
     "without SET datafusion.tpu.mesh_devices (0 disables it)."),
    ("datafusion.tpu.device_aggregate", True, bool,
     "Run filter/project/group-aggregate pipelines and fanout-1 join "
     "chains under them as CUDA kernels on the card (falls back to the "
     "host path per query when unsupported)."),
    ("datafusion.tpu.device_join_rows", True, bool,
     "Fuse row-returning join trees (no aggregate above) into device "
     "chain programs that emit the surviving rows with device-resident "
     "columns (DeviceJoinChainRowsExec)."),
    ("datafusion.tpu.device_join_rows_min_spine", 200000, int,
     "Minimum estimated spine rows before a row-returning join tree "
     "(no aggregate above) runs as one chain kernel on the card that "
     "emits the surviving rows as device-born columns "
     "(TorchJoinChainRowsExec): small joins stay on the host."),
    ("datafusion.tpu.device_sort_min_rows", 1 << 17, int,
     "Row-count threshold at or above which ORDER BY, top-k and window "
     "ordering sorts run as the stable radix sort kernel on the session's "
     "device instead of host np.lexsort (physical/plan/device_sort.py)."),
    ("datafusion.tpu.device_window_min_rows", 1 << 17, int,
     "Row-count threshold at or above which window functions of the "
     "supported family (ranks, ntile, lag/lead, sum/count/avg frames) "
     "evaluate on the session's device: radix sort, lane gather and the "
     "window-scan kernel (device/window.py)."),
]

# Reference config surface (config.rs config_namespace! blocks): every key
# the reference's SHOW ALL lists, with the reference's defaults. Settable
# and introspectable; keys whose behavior this engine decides differently
# (fusion instead of coalescing, device tiles instead of batch plumbing)
# are accepted no-ops, like the reference accepts-but-ignores some knobs
# on non-applicable plans.
import os as _os

_OPTIONS += [
    ("datafusion.catalog.create_default_catalog_and_schema", True, bool,
     "create the default datafusion/public catalog+schema at startup"),
    ("datafusion.catalog.format", None, str,
     "default table format for CREATE EXTERNAL TABLE (NULL = infer)"),
    ("datafusion.catalog.location", None, str,
     "default table location for CREATE EXTERNAL TABLE"),
    ("datafusion.execution.aggregate.scalar_update_factor", 10, int, ""),
    ("datafusion.execution.coalesce_batches", True, bool,
     "re-bucket tiny batches (device tiles re-bucket at staging here)"),
    ("datafusion.execution.keep_partition_by_columns", False, bool, ""),
    ("datafusion.execution.listing_table_ignore_subdirectory", True, bool,
     ""),
    ("datafusion.execution.max_buffered_batches_per_output_file", 2, int,
     ""),
    ("datafusion.execution.meta_fetch_concurrency", 32, int, ""),
    ("datafusion.execution.minimum_parallel_output_files", 4, int, ""),
    ("datafusion.execution.planning_concurrency", _os.cpu_count() or 1, int,
     "parallelism for planning file scans (defaults to num_cores)"),
    ("datafusion.execution.soft_max_rows_per_output_file", 50000000, int,
     ""),
    ("datafusion.execution.sort_in_place_threshold_bytes", 1048576, int,
     ""),
    ("datafusion.execution.sort_spill_reservation_bytes", 10485760, int,
     ""),
    ("datafusion.execution.split_file_groups_by_statistics", False, bool,
     ""),
    ("datafusion.execution.parquet.allow_single_file_parallelism", True,
     bool, ""),
    ("datafusion.execution.parquet.bloom_filter_fpp", None, float, ""),
    ("datafusion.execution.parquet.bloom_filter_ndv", None, int, ""),
    ("datafusion.execution.parquet.column_index_truncate_length", None, int,
     ""),
    ("datafusion.execution.parquet.compression", "zstd(3)", str,
     "default parquet write compression"),
    ("datafusion.execution.parquet.created_by", "datafusion", str, ""),
    ("datafusion.execution.parquet.data_page_row_count_limit",
     18446744073709551615, int, ""),
    ("datafusion.execution.parquet.data_pagesize_limit", 1048576, int, ""),
    ("datafusion.execution.parquet.dictionary_enabled", None, bool, ""),
    ("datafusion.execution.parquet.dictionary_page_size_limit", 1048576,
     int, ""),
    ("datafusion.execution.parquet.encoding", None, str, ""),
    ("datafusion.execution.parquet.max_row_group_size", 1048576, int,
     "rows per row group on parquet writes"),
    ("datafusion.execution.parquet.max_statistics_size", None, int, ""),
    ("datafusion.execution.parquet."
     "maximum_buffered_record_batches_per_stream", 2, int, ""),
    ("datafusion.execution.parquet.maximum_parallel_row_group_writers", 1,
     int, ""),
    ("datafusion.execution.parquet.metadata_size_hint", None, int, ""),
    ("datafusion.execution.parquet.pruning", True, bool,
     "row-group pruning from parquet statistics"),
    ("datafusion.execution.parquet.reorder_filters", False, bool, ""),
    ("datafusion.execution.parquet.skip_metadata", True, bool, ""),
    ("datafusion.execution.parquet.statistics_enabled", None, str, ""),
    ("datafusion.execution.parquet.write_batch_size", 1024, int, ""),
    ("datafusion.execution.parquet.writer_version", "1.0", str, ""),
    ("datafusion.explain.show_schema", False, bool,
     "include schemas in EXPLAIN physical plan lines"),
    ("datafusion.explain.show_sizes", True, bool,
     "include sizes in EXPLAIN memory-scan lines"),
    ("datafusion.optimizer.allow_symmetric_joins_without_pruning", True,
     bool, ""),
    ("datafusion.optimizer.enable_distinct_aggregation_soft_limit", True,
     bool, ""),
    ("datafusion.optimizer.enable_round_robin_repartition", True, bool, ""),
    ("datafusion.optimizer.enable_topk_aggregation", True, bool,
     "fuse ORDER BY agg LIMIT k into the aggregate (device top-k here)"),
    ("datafusion.optimizer.filter_null_join_keys", False, bool, ""),
    ("datafusion.optimizer.prefer_existing_sort", False, bool, ""),
    ("datafusion.optimizer.prefer_existing_union", False, bool, ""),
    ("datafusion.optimizer.repartition_file_min_size", 10485760, int, ""),
    ("datafusion.optimizer.repartition_file_scans", True, bool, ""),
    ("datafusion.optimizer.repartition_windows", True, bool, ""),
    ("datafusion.optimizer.top_down_join_key_reordering", True, bool, ""),
]


class ConfigOptions:
    def __init__(self):
        self._vals: Dict[str, Any] = {k: d for k, d, _, _ in _OPTIONS}
        self._types: Dict[str, type] = {k: t for k, _, t, _ in _OPTIONS}
        self._descr: Dict[str, str] = {k: s for k, _, _, s in _OPTIONS}

    def get(self, key: str) -> Any:
        if key not in self._vals:
            raise PlanError(f"Unknown configuration option: {key}")
        return self._vals[key]

    def set(self, key: str, value: Any) -> None:
        if key not in self._vals:
            # allow user extension namespaces, mirroring ConfigExtension
            self._vals[key] = value
            self._types[key] = type(value)
            self._descr.setdefault(key, "(user extension)")
            return
        t = self._types[key]
        if isinstance(value, str) and t is not str:
            if t is bool:
                value = value.strip().lower() in ("1", "true", "t", "yes", "on")
            else:
                value = t(value)
        self._vals[key] = value

    def entries(self) -> List[Tuple[str, Any, str]]:
        return [(k, self._vals[k], self._descr.get(k, "")) for k in sorted(self._vals)]

    def copy(self) -> "ConfigOptions":
        c = ConfigOptions()
        c._vals = dict(self._vals)
        c._types = dict(self._types)
        c._descr = dict(self._descr)
        return c

    # convenience accessors
    @property
    def batch_size(self) -> int:
        return self._vals["datafusion.execution.batch_size"]

    @property
    def target_partitions(self) -> int:
        return self._vals["datafusion.execution.target_partitions"]
