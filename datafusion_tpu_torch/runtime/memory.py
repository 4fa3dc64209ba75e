"""Memory pools and reservations.

Reference parity: `datafusion/execution/src/memory_pool/` — the MemoryPool
trait (`mod.rs:85`), MemoryConsumer/MemoryReservation (`mod.rs:121,186`) and
the Unbounded/Greedy/FairSpill pools (`pool.rs:26,55,124`).

On TPU the tracked resource is the HBM working-set budget for operator
state (hash tables, sort buffers, build sides); when `try_grow` fails a
spillable operator externalizes state to host DRAM (the HBM→host analog of
the reference's disk spill).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..common.errors import ResourcesExhausted


class MemoryPool:
    def register(self, consumer: "MemoryReservation") -> None:
        pass

    def unregister(self, consumer: "MemoryReservation") -> None:
        pass

    def grow(self, reservation: "MemoryReservation", additional: int) -> None:
        raise NotImplementedError

    def shrink(self, reservation: "MemoryReservation", shrink: int) -> None:
        raise NotImplementedError

    def try_grow(self, reservation: "MemoryReservation", additional: int) -> None:
        raise NotImplementedError

    def reserved(self) -> int:
        raise NotImplementedError


class UnboundedMemoryPool(MemoryPool):
    """No limit; tracks usage (reference: pool.rs:26)."""

    def __init__(self):
        self._reserved = 0
        self._lock = threading.Lock()

    def grow(self, reservation, additional):
        with self._lock:
            self._reserved += additional

    def shrink(self, reservation, shrink):
        with self._lock:
            self._reserved -= shrink

    def try_grow(self, reservation, additional):
        self.grow(reservation, additional)

    def reserved(self):
        return self._reserved


class GreedyMemoryPool(MemoryPool):
    """First-come-first-served up to a fixed limit (reference: pool.rs:55)."""

    def __init__(self, pool_size: int):
        self.pool_size = pool_size
        self._reserved = 0
        self._lock = threading.Lock()

    def grow(self, reservation, additional):
        with self._lock:
            self._reserved += additional

    def shrink(self, reservation, shrink):
        with self._lock:
            self._reserved -= shrink

    def try_grow(self, reservation, additional):
        with self._lock:
            if self._reserved + additional > self.pool_size:
                raise ResourcesExhausted(
                    f"Failed to allocate additional {additional} bytes for "
                    f"{reservation.name} with {reservation.size} bytes already "
                    f"allocated - maximum available is "
                    f"{self.pool_size - self._reserved}")
            self._reserved += additional

    def reserved(self):
        return self._reserved


class FairSpillPool(MemoryPool):
    """Divides the pool fairly among spillable consumers
    (reference: pool.rs:124). Unspillable consumers take what they need;
    spillable ones are capped at (size - unspillable) / num_spillable."""

    def __init__(self, pool_size: int):
        self.pool_size = pool_size
        self._unspillable = 0
        self._spillable: Dict[int, int] = {}
        self._num_spillable = 0
        self._lock = threading.Lock()

    def register(self, consumer):
        if consumer.can_spill:
            with self._lock:
                self._num_spillable += 1
                self._spillable[id(consumer)] = 0

    def unregister(self, consumer):
        if consumer.can_spill:
            with self._lock:
                self._num_spillable -= 1
                self._unspillable_adjust = self._spillable.pop(id(consumer), 0)

    def grow(self, reservation, additional):
        with self._lock:
            self._account(reservation, additional)

    def shrink(self, reservation, shrink):
        with self._lock:
            self._account(reservation, -shrink)

    def _account(self, reservation, delta):
        if reservation.can_spill:
            self._spillable[id(reservation)] = \
                self._spillable.get(id(reservation), 0) + delta
        else:
            self._unspillable += delta

    def try_grow(self, reservation, additional):
        with self._lock:
            if reservation.can_spill:
                spill_budget = max(0, self.pool_size - self._unspillable)
                per = spill_budget // max(1, self._num_spillable)
                cur = self._spillable.get(id(reservation), 0)
                if cur + additional > per:
                    raise ResourcesExhausted(
                        f"Failed to allocate additional {additional} bytes for "
                        f"{reservation.name} - fair share is {per} bytes")
            else:
                if self.reserved() + additional > self.pool_size:
                    raise ResourcesExhausted(
                        f"Failed to allocate additional {additional} bytes for "
                        f"{reservation.name}")
            self._account(reservation, additional)

    def reserved(self):
        return self._unspillable + sum(self._spillable.values())


class MemoryReservation:
    """Tracked allocation owned by one operator instance
    (reference: memory_pool/mod.rs:186)."""

    def __init__(self, name: str, pool: MemoryPool, can_spill: bool = False):
        self.name = name
        self.pool = pool
        self.can_spill = can_spill
        self.size = 0
        pool.register(self)

    def try_grow(self, additional: int) -> None:
        self.pool.try_grow(self, additional)
        self.size += additional

    def grow(self, additional: int) -> None:
        self.pool.grow(self, additional)
        self.size += additional

    def shrink(self, amount: int) -> None:
        amount = min(amount, self.size)
        self.pool.shrink(self, amount)
        self.size -= amount

    def resize(self, new_size: int) -> None:
        if new_size > self.size:
            self.try_grow(new_size - self.size)
        else:
            self.shrink(self.size - new_size)

    def free(self) -> None:
        self.shrink(self.size)
        self.pool.unregister(self)

    def __del__(self):
        try:
            if self.size:
                self.pool.shrink(self, self.size)
        except Exception:  # noqa: BLE001
            pass
