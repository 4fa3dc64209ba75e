"""Batch spill files.

Reference parity: the sort/agg spill mechanism (`sorts/sort.rs:385-434`
writes Arrow IPC via DiskManager; here: one .npy per column + pickled
dictionaries, read back as memory-mapped arrays so final assembly gathers
only the pages it touches).
"""
from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from ...common.batch import Batch
from ...common.column import Column, Dictionary
from ...common.schema import Schema


class SpilledBatch:
    def __init__(self, disk, batch: Batch):
        self.schema = batch.schema
        self.num_rows = batch.num_rows
        self.paths: List[str] = []
        self.validity_paths: List[Optional[str]] = []
        self.dictionaries: List[Optional[Dictionary]] = []
        nbytes = 0
        for c in batch.columns:
            p = disk.create_tmp_file()
            data = c.data_host()[: batch.num_rows]
            np.save(p, data, allow_pickle=False)
            nbytes += data.nbytes
            self.paths.append(p)
            if c.has_nulls:
                vp = disk.create_tmp_file()
                np.save(vp, c.validity_host()[: batch.num_rows])
                nbytes += batch.num_rows
                self.validity_paths.append(vp)
            else:
                self.validity_paths.append(None)
            # dictionaries are tiny; keep them in memory
            self.dictionaries.append(c.dictionary)
        disk.record_bytes(nbytes)

    def load(self, mmap: bool = True) -> Batch:
        mode = "r" if mmap else None
        cols = []
        for f, p, vp, dic in zip(self.schema, self.paths,
                                 self.validity_paths, self.dictionaries):
            data = np.load(p, mmap_mode=mode)
            v = np.load(vp, mmap_mode=mode) if vp else None
            cols.append(Column(f.dtype, data, v, dic))
        return Batch(self.schema, cols, self.num_rows)

    def take(self, indices: np.ndarray) -> Batch:
        """Gather rows by index (memmap-backed: touches only needed pages)."""
        b = self.load(mmap=True)
        return b.take_host(indices)
