"""Object stores + scheme registry.

Reference parity: `object_store::ObjectStore` + `ObjectStoreRegistry`
(datafusion/execution/src/object_store.rs) — file paths and URLs resolve
to a store by scheme; tables list/read through the store, never the raw
filesystem, so custom backends (in-memory, test fixtures, future remote
stores) plug in per session with `register_object_store`.
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import os
import time
from typing import Dict, List, Optional, Tuple

from ..common.errors import PlanError


@dataclasses.dataclass
class ObjectMeta:
    location: str
    size: int
    last_modified: float


class ObjectStore:
    """Minimal store protocol (get/put/head/list)."""

    def get(self, path: str) -> bytes:
        raise NotImplementedError

    def put(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def head(self, path: str) -> ObjectMeta:
        raise NotImplementedError

    def list(self, prefix: str) -> List[ObjectMeta]:
        raise NotImplementedError

    # local-path passthrough for readers that want a filesystem path
    # (pyarrow parquet/csv); stores without one materialize a temp file
    def local_path(self, path: str) -> Optional[str]:
        return None


class LocalFileSystem(ObjectStore):
    """The default file:// store; glob patterns and directories list like
    the reference's ListingTable."""

    def get(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def put(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def head(self, path: str) -> ObjectMeta:
        st = os.stat(path)
        return ObjectMeta(path, st.st_size, st.st_mtime)

    def list(self, prefix: str) -> List[ObjectMeta]:
        if os.path.isdir(prefix):
            paths = []
            for ext in ("parquet", "csv", "json", "orc"):
                paths.extend(sorted(
                    _glob.glob(os.path.join(prefix, f"*.{ext}"))))
        elif any(ch in prefix for ch in "*?["):
            paths = sorted(_glob.glob(prefix))
        elif os.path.exists(prefix):
            paths = [prefix]
        else:
            paths = []
        return [self.head(p) for p in paths]

    def local_path(self, path: str) -> Optional[str]:
        return path


class InMemoryStore(ObjectStore):
    """memory:// store (reference: object_store::memory::InMemory)."""

    def __init__(self):
        self._objects: Dict[str, Tuple[bytes, float]] = {}

    def get(self, path: str) -> bytes:
        if path not in self._objects:
            raise PlanError(f"object '{path}' not found in memory store")
        return self._objects[path][0]

    def put(self, path: str, data: bytes) -> None:
        self._objects[path] = (bytes(data), time.time())

    def head(self, path: str) -> ObjectMeta:
        data, ts = self._objects[path]
        return ObjectMeta(path, len(data), ts)

    def list(self, prefix: str) -> List[ObjectMeta]:
        return [self.head(p) for p in sorted(self._objects)
                if p.startswith(prefix)]

    def local_path(self, path: str) -> Optional[str]:
        import tempfile
        data = self.get(path)
        suffix = os.path.splitext(path)[1]
        f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
        f.write(data)
        f.close()
        return f.name


def split_url(url: str) -> Tuple[str, str]:
    """'scheme://path' -> (scheme, path); bare paths are file://."""
    if "://" in url:
        scheme, rest = url.split("://", 1)
        return scheme.lower(), rest
    return "file", url


class ObjectStoreRegistry:
    """scheme -> store (reference: DefaultObjectStoreRegistry)."""

    def __init__(self):
        self._stores: Dict[str, ObjectStore] = {"file": LocalFileSystem()}

    def register_store(self, scheme: str, store: ObjectStore) -> None:
        self._stores[scheme.lower().rstrip(":/")] = store

    def store_for_url(self, url: str) -> Tuple[ObjectStore, str]:
        scheme, path = split_url(url)
        store = self._stores.get(scheme)
        if store is None:
            raise PlanError(f"no object store registered for scheme "
                            f"'{scheme}://'")
        return store, path
