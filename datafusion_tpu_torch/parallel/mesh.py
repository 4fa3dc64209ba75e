"""The shards a distributed aggregate runs over, and their collectives.

Counterpart of `datafusion_tpu/parallel/distributed.py:32-57`
(`make_mesh`, `default_mesh`) and of the `jax.lax` collectives that its
`shard_map` programs call. Two kinds of mesh, one interface; a mesh holds
`n` shards, of which this process runs `local`, on `device`:

- `LocalMesh(n, device)`: every shard in this process on one device, the
  counterpart of the reference's forced-device mesh
  (`xla_force_host_platform_device_count`). Shards that share a card
  exchange by device copies: all_gather is a concatenation, all_to_all
  hands each destination the blocks every source cut for it.
- `ProcessGroupMesh(group, device)`: one shard a rank of a
  `torch.distributed` process group (NCCL on CUDA, gloo on the CPU):
  `all_gather` of the sizes, then of the padded blocks; `all_to_all_single`
  of the split sizes, then of each lane with exact splits; `all_reduce`
  (MAX) of a flag. Every rank runs the same SQL over the same registered
  tables, takes its own row range and returns the replicated result, as
  the reference's `out_specs=P()` do.

The shard step of `parallel/distributed.py` and `parallel/exchange.py`
is written once, over the list of shards this process holds: a LocalMesh
holds all n, a rank holds 1. Collectives take one argument a local shard,
in `local` order. There is no fallback: a mesh on a CUDA device runs there
or raises, and a failed collective raises.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class LocalMesh:
    """`n` shards in this process, all on `device`."""

    def __init__(self, n_shards: int, device):
        if n_shards < 1:
            raise ValueError("a mesh needs at least one shard")
        self.n = int(n_shards)
        self.device = torch.device(device)
        self.local = list(range(self.n))

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's [rows, m_s] table side by side: [rows, sum m_s]."""
        return torch.cat(list(parts), dim=-1)

    def all_to_all(self, sends: Sequence[Sequence[torch.Tensor]],
                   splits: Sequence[Sequence[int]]
                   ) -> List[List[torch.Tensor]]:
        """sends[i]: the lanes local shard i sends, each [sum_d
        splits[i][d]] in destination order; returns, a local shard, its
        received lanes, each the sources' blocks in source order."""
        offs = [np.concatenate([[0], np.cumsum(s)]) for s in splits]
        out = []
        for d in range(self.n):
            out.append([torch.cat([sends[s][j][offs[s][d]:offs[s][d + 1]]
                                   for s in range(self.n)])
                        for j in range(len(sends[0]))])
        return out

    def any(self, flags: Sequence[bool]) -> bool:
        return any(bool(f) for f in flags)

    def describe(self) -> str:
        return f"LocalMesh({self.n} shards on {self.device})"


class ProcessGroupMesh:
    """One shard a rank of the process group `group` (the default group
    when None), on `device` (the rank's current CUDA device under NCCL, the
    CPU under gloo, when None)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised")
        self.dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        self.local = [self.rank]
        if device is None:
            nccl = dist.get_backend(group) == "nccl"
            device = torch.device("cuda", torch.cuda.current_device()) \
                if nccl else torch.device("cpu")
        self.device = torch.device(device)

    def _sizes(self, k: int) -> List[int]:
        mine = torch.tensor([k], dtype=torch.int64, device=self.device)
        every = [torch.empty_like(mine) for _ in range(self.n)]
        self.dist.all_gather(every, mine, group=self.group)
        return [int(x.item()) for x in every]

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        (part,) = parts
        rows, m = part.shape
        sizes = self._sizes(m)
        width = max(max(sizes), 1)
        block = torch.zeros((width, rows), dtype=part.dtype,
                            device=self.device)
        block[:m] = part.t()
        every = [torch.empty_like(block) for _ in range(self.n)]
        self.dist.all_gather(every, block, group=self.group)
        return torch.cat([b[:k] for b, k in zip(every, sizes)]).t() \
            .contiguous()

    def all_to_all(self, sends: Sequence[Sequence[torch.Tensor]],
                   splits: Sequence[Sequence[int]]
                   ) -> List[List[torch.Tensor]]:
        (lanes,), (split,) = sends, splits
        counts = torch.tensor(list(split), dtype=torch.int64,
                              device=self.device)
        recv_counts = torch.empty_like(counts)
        self.dist.all_to_all_single(recv_counts, counts, group=self.group)
        recv = [int(x) for x in recv_counts.tolist()]
        out = []
        for lane in lanes:
            wire = lane.view(torch.uint8) if lane.dtype == torch.bool \
                else lane
            got = torch.empty(sum(recv), dtype=wire.dtype,
                              device=self.device)
            self.dist.all_to_all_single(got, wire.contiguous(), recv,
                                        list(split), group=self.group)
            out.append(got.view(torch.bool) if lane.dtype == torch.bool
                       else got)
        return [out]

    def any(self, flags: Sequence[bool]) -> bool:
        t = torch.tensor([int(any(bool(f) for f in flags))],
                         dtype=torch.int64, device=self.device)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def describe(self) -> str:
        return (f"ProcessGroupMesh(rank {self.rank} of {self.n}, "
                f"{self.dist.get_backend(self.group)}, {self.device})")


def make_mesh(n_shards: int, device) -> LocalMesh:
    """A mesh of `n_shards` shards on the session's device (`make_mesh`,
    `distributed.py:32`): on a host with fewer cards than shards, the
    shards share the card, as the reference falls back to forced CPU
    devices on a one-chip host."""
    return LocalMesh(n_shards, device)


def device_count(device, mesh=None) -> int:
    """The devices a session's automatic mesh spans (`_auto_mesh_devices`'
    `jax.local_device_count()`): the CUDA cards for a CUDA session; for a
    CPU session the size of the mesh it was given, else 1."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return mesh.n if mesh is not None else 1
