"""DiskManager — temp-file management for spilling operators.

Reference parity: `datafusion/execution/src/disk_manager.rs:73` +
RefCountedTempFile (:153). Spill files are numpy .npy per column (host
DRAM -> disk tier; on real TPU deployments the first spill tier is
HBM -> host DRAM, which the host path gets for free by virtue of batches
living in host memory — this disk tier is the second level).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Optional


class DiskManager:
    def __init__(self, base_dir: Optional[str] = None):
        self._dir = tempfile.mkdtemp(prefix="datafusion_tpu_spill_",
                                     dir=base_dir)
        self._count = 0
        self._bytes = 0
        self._lock = threading.Lock()

    def create_tmp_file(self, suffix: str = ".npy") -> str:
        with self._lock:
            self._count += 1
            return os.path.join(self._dir, f"spill_{self._count}{suffix}")

    def record_bytes(self, n: int) -> None:
        with self._lock:
            self._bytes += n

    @property
    def spilled_bytes(self) -> int:
        return self._bytes

    def cleanup(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        try:
            self.cleanup()
        except Exception:  # noqa: BLE001
            pass
