"""CacheManager: per-session caches for file listings and file statistics.

Reference parity: `execution/src/cache/cache_manager.rs` +
`cache_unit.rs` (DefaultFileStatisticsCache / DefaultListFilesCache) —
listing tables and parquet scans consult these before touching the store;
entries invalidate when the object's size/mtime changes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional, Tuple


class LruCache:
    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self):
        return len(self._d)


class CacheManager:
    """Validity-checked caches keyed by (path, size, mtime) so stale
    entries drop out when the underlying object changes."""

    def __init__(self, statistics_capacity: int = 1024,
                 listing_capacity: int = 256):
        self.file_statistics_cache = LruCache(statistics_capacity)
        self.list_files_cache = LruCache(listing_capacity)

    @staticmethod
    def _version(meta) -> Tuple:
        return (meta.location, meta.size, round(meta.last_modified, 6))

    def get_file_statistics(self, meta) -> Optional[Any]:
        return self.file_statistics_cache.get(self._version(meta))

    def put_file_statistics(self, meta, stats: Any) -> None:
        self.file_statistics_cache.put(self._version(meta), stats)

    def get_listing(self, url: str) -> Optional[Any]:
        return self.list_files_cache.get(url)

    def put_listing(self, url: str, listing: Any) -> None:
        self.list_files_cache.put(url, listing)
