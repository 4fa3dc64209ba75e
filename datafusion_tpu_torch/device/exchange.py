"""The mesh's kernels: the row partition of an all_to_all round (K1) and the
owner's merge of partial group tables (K2), with the owner hash.

Counterpart of the device halves of `datafusion_tpu/parallel/exchange.py`
and `datafusion_tpu/parallel/distributed.py`.

Owner. `shard_owner` is the JAX package's `_owner` (`exchange.py:73`):
splitmix64 of the key (salted: of `key * 0x100000001B3 + s` in 64-bit
wraparound), modulo the shard count as unsigned 64-bit numbers, bit for
bit `host_owner` (`exchange.py:85`) over the port's `physical/hashing.py`
`_splitmix64`. int64 arithmetic is two's complement, so a hash with bit 63
set is a negative int64 whose signed remainder would name another shard;
`shard_owner` takes the unsigned one.

K1 (`partition_rows`, `csrc/exchange.cu`): the pending rows of one shard
bucketed by destination into one send buffer, at most `cap` rows a
destination; the rows past the cap stay pending for the next round. A
destination's rows leave in row order (a stable partition), so the send
buffer is the plain version's exactly. Two launches: a count of each
destination's rows, read back to size the buffer, then one sweep in tiles
taken by a ticket, each ranking its rows within their destination and
finding where they start by a decoupled look-back over the tiles before
(a sweep a pass of 32 lanes). It stands for `_owner`, the
argsort, searchsorted and gathers of `_all_to_all_rows` (`:96`) and of
`_all_to_all_chained`'s rounds (`:158-198`). Its plain version: a stable
`torch.sort` on the destination and an `index_select` a lane.

K2 (`merge_partials`, `csrc/exchange.cu`): (key, count, lanes) entries of
partial group tables folded into the local shards' tables (`MergeTables`,
the hash layout of `device/groupby.py`: row 0 keys, EMPTY = -1; row 1
counts; then the lanes), each lane by its kind's merge: counts and sums
add, min and max take the least and greatest. One launch serves every
local table: on the all_gather route (`n_owner` > 0) it reads the
gathered entries once and sends each to its owner's table, skipping the
entries other processes own; on the shuffle route each local shard's
arrivals fold into its own table. It counts the distinct keys each table
claims (a warp's fresh claims by ballot, one atomic a table) and raises
the table's overflow flag past `limit`. It stands for `_merge_fold`
(`exchange.py:218`) and the final `device_group_aggregate` of
`distributed.py`'s steps (`:99-114`, `:183-189`, `:267-276`). Its plain
version, a table at a time: `torch.unique` against the keys already in
the table, the new keys at the lowest free slots, then `index_add_` and
`scatter_reduce_` a lane. Both count only the keys that found a slot, so
a full table stops the count.

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its CUDA kernel on CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..physical.hashing import _splitmix64
from .groupby import (_DISTINCT_LANES, _IDENTITY, EMPTY, LANE_MAX_F64,
                      LANE_MAX_I64, LANE_MIN_F64, LANE_MIN_I64, LANE_SUM_F32,
                      LANE_SUM_F64, _cuda, _i64, _next_pow2, _stream,
                      splitmix64)

partition_rows_kernel = kernels.register(kernels.Kernel(
    "partition_rows", "datafusion_tpu_torch/csrc/exchange.cu",
    "datafusion_tpu/parallel/exchange.py:96"))
merge_partials_kernel = kernels.register(kernels.Kernel(
    "merge_partials", "datafusion_tpu_torch/csrc/exchange.cu",
    "datafusion_tpu/parallel/exchange.py:218"))

SALT_MUL = 0x100000001B3
SALT_ROW, SALT_REPLICA = 1, 2    # s = local row % salt; s = the replica
MAX_SHARDS = 256                 # destinations of one partition
TILE = 2048                      # rows a tile of K1's sweep
SCATTER_LANES = 32               # lanes a launch of K1's sweep moves
_U64 = 1 << 64


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The unsigned 64-bit remainder of int64 bit patterns `h` by n."""
    r = torch.remainder(h, n)
    return torch.where(h < 0, torch.remainder(r + _U64 % n, n), r)


def shard_owner(keys: torch.Tensor, n: int,
                salt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shard (int64) of each int64 key: splitmix64 modulo n, unsigned;
    with `salt`, of `key * 0x100000001B3 + salt` in 64-bit wraparound
    (`_owner`, `exchange.py:73`)."""
    x = keys.to(torch.int64)
    if salt is not None:
        x = x * _i64(SALT_MUL) + salt.to(torch.int64)
    return _umod(splitmix64(x), int(n))


def host_owner(keys: np.ndarray, n_shards: int,
               salt: Optional[np.ndarray] = None) -> np.ndarray:
    """The host twin of `shard_owner` (`host_owner`, `exchange.py:85`)."""
    x = keys.astype(np.uint64)
    if salt is not None:
        with np.errstate(over="ignore"):
            x = x * np.uint64(SALT_MUL) + salt.astype(np.uint64)
    return (_splitmix64(x) % np.uint64(n_shards)).astype(np.int32)


# --- K1 -------------------------------------------------------------------

class Partition:
    """One shard's send buffer of a round: the (salted) keys and every lane
    in destination order, `splits[d]` rows for destination d, and whether
    rows stay pending for another round (`left`)."""

    def __init__(self, keys: torch.Tensor, lanes: List[torch.Tensor],
                 splits: List[int], left: bool):
        self.keys = keys
        self.lanes = lanes
        self.splits = splits
        self.left = left


def _salt_of(n: int, salt: int, salt_mode: int, salt_r: int,
             device) -> torch.Tensor:
    if salt_mode == SALT_ROW:
        return torch.arange(n, dtype=torch.int64, device=device) % salt
    return torch.full((n,), int(salt_r), dtype=torch.int64, device=device)


def _check_partition(keys, pending, n_dest, cap, lanes) -> None:
    n = keys.numel()
    if keys.dtype != torch.int64 or keys.dim() != 1 or \
            not keys.is_contiguous():
        raise ValueError("keys must be a contiguous int64 [n] tensor")
    if pending.dtype != torch.bool or pending.shape != keys.shape or \
            not pending.is_contiguous() or pending.device != keys.device:
        raise ValueError("pending must be a contiguous bool [n] beside keys")
    if not 1 <= n_dest <= MAX_SHARDS:
        raise ValueError(f"{n_dest} destinations outside 1..{MAX_SHARDS}")
    if cap < 1:
        raise ValueError("cap must be at least 1")
    for lane in lanes:
        if lane.dim() != 1 or lane.shape[0] != n or \
                not lane.is_contiguous() or lane.device != keys.device or \
                lane.element_size() not in (1, 2, 4, 8):
            raise ValueError("lanes must be contiguous [n] tensors of 1, 2, "
                             "4 or 8 bytes beside the keys")


def partition_rows(keys: torch.Tensor, pending: torch.Tensor, n_dest: int,
                   cap: int, lanes: Sequence[torch.Tensor] = (),
                   salt: int = 1, salt_mode: int = SALT_ROW,
                   salt_r: int = 0) -> Partition:
    """The pending rows (`pending`, updated in place: the rows sent are
    cleared) bucketed by destination, `shard_owner(keys)` (salted when
    `salt` > 1), at most `cap` a destination, in row order within each.
    With a salt the keys travel as `key * salt + s`.

    On CPU tensors this runs `partition_rows_plain`; on CUDA tensors it
    launches the K1 kernels (the count, then a sweep a pass of 32 lanes;
    one zero fill of the totals, the tickets and the look-back's status
    words before them) or raises. It reads the destinations' totals back
    to size the buffer: one synchronisation."""
    lanes = list(lanes)
    _check_partition(keys, pending, n_dest, cap, lanes)
    if not _cuda(keys):
        return partition_rows_plain(keys, pending, n_dest, cap, lanes, salt,
                                    salt_mode, salt_r)
    dev, n = keys.device, keys.numel()
    lib = kernels.library()
    passes = max(-(-len(lanes) // SCATTER_LANES), 1)
    n_tiles = max(-(-n // TILE), 1)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        # the totals, a ticket a pass, a status word a tile and destination
        scratch = torch.zeros(n_dest + passes + n_tiles * n_dest,
                              dtype=torch.int64, device=dev)
        totals = scratch[:n_dest]
        flags = pending.view(torch.uint8)
        kernels.check(lib.dft_partition_count(
            keys.data_ptr(), flags.data_ptr(), n, n_dest, int(salt),
            int(salt_mode), int(salt_r), totals.data_ptr(), stream),
            partition_rows_kernel)
        partition_rows_kernel.launches += 1
        tot = totals.tolist()
        splits = [min(int(t), int(cap)) for t in tot]
        m = sum(splits)
        key_out = torch.empty(m, dtype=torch.int64, device=dev)
        outs = [torch.empty(m, dtype=lane.dtype, device=dev)
                for lane in lanes]
        k = max(len(lanes), 1)
        src = (ctypes.c_void_p * k)(*[x.data_ptr() for x in lanes])
        dst = (ctypes.c_void_p * k)(*[x.data_ptr() for x in outs])
        width = (ctypes.c_int * k)(*[x.element_size() for x in lanes])
        kernels.check(lib.dft_partition_sweep(
            keys.data_ptr(), flags.data_ptr(), n, n_dest, int(salt),
            int(salt_mode), int(salt_r), totals.data_ptr(), int(cap),
            len(lanes), src, dst, width, key_out.data_ptr(),
            scratch[n_dest + passes:].data_ptr(),
            scratch[n_dest:].data_ptr(), stream), partition_rows_kernel)
        partition_rows_kernel.launches += passes
    return Partition(key_out, outs, splits, any(t > cap for t in tot))


def partition_rows_plain(keys: torch.Tensor, pending: torch.Tensor,
                         n_dest: int, cap: int,
                         lanes: Sequence[torch.Tensor] = (), salt: int = 1,
                         salt_mode: int = SALT_ROW,
                         salt_r: int = 0) -> Partition:
    """The plain PyTorch version: the owners, a stable sort on the
    destination, each destination's first `cap` rows gathered."""
    dev, n = keys.device, keys.numel()
    if salt > 1:
        s = _salt_of(n, salt, salt_mode, salt_r, dev)
        own = shard_owner(keys, n_dest, s)
        travel = keys * int(salt) + s
    else:
        own, travel = shard_owner(keys, n_dest), keys
    dest = torch.where(pending, own, n_dest)
    srt, idx = torch.sort(dest, stable=True)
    totals = torch.bincount(dest, minlength=n_dest + 1)[:n_dest]
    starts = torch.cumsum(totals, 0) - totals
    tot = totals.tolist()
    splits = [min(int(t), int(cap)) for t in tot]
    send_off = torch.tensor(np.concatenate([[0], np.cumsum(splits)[:-1]]),
                            dtype=torch.int64, device=dev)
    live = srt < n_dest
    d = srt[live]
    rank = torch.arange(n, device=dev)[live] - starts[d]
    go = rank < cap
    rows = idx[live][go]
    pos = send_off[d[go]] + rank[go]
    m = sum(splits)
    key_out = torch.empty(m, dtype=torch.int64, device=dev)
    key_out[pos] = travel[rows]
    outs = []
    for lane in lanes:
        out = torch.empty(m, dtype=lane.dtype, device=dev)
        out[pos] = lane[rows]
        outs.append(out)
    pending[rows] = False
    return Partition(key_out, outs, splits, any(t > cap for t in tot))


# --- K2 -------------------------------------------------------------------

# csrc/exchange.cu: the local tables one K2 launch serves, and the lane
# kinds its parameters hold (4 bits each)
MERGE_TABLES = 16
MERGE_LANES = 4096


class _MergeArgs(ctypes.Structure):
    _fields_ = [("entries", ctypes.c_void_p * MERGE_TABLES),
                ("m", ctypes.c_longlong * MERGE_TABLES),
                ("n_tables", ctypes.c_int), ("n_owner", ctypes.c_int),
                ("first", ctypes.c_int), ("rows", ctypes.c_int),
                ("kinds", ctypes.c_ubyte * (MERGE_LANES // 2))]


class MergeTables:
    """The local shards' group tables for `merge_partials`: `n` tables of
    [rows, cap] (`tables`, one tensor [n, rows, cap]), cap a power of two
    at least twice `limit` + 1 (so a table cannot fill before the limit
    is passed), the distinct keys each claimed (`groups`, int64 [n]) and
    its overflow flag (`overflow`, int64 [n]). Made on the device: one
    fill a row whose identity is not 0 and one zero fill of the counts,
    no upload."""

    def __init__(self, kinds: Sequence[int], limit: int, n: int,
                 device: torch.device):
        check_merge_kinds(kinds)
        self.kinds = list(kinds)
        self.limit = int(limit)
        self.n = int(n)
        self.cap = _next_pow2(2 * (self.limit + 1))
        head = [EMPTY, 0] + [_IDENTITY.get(k, 0) for k in self.kinds]
        self.tables = torch.zeros((self.n, len(head), self.cap),
                                  dtype=torch.int64, device=device)
        for r, v in enumerate(head):
            if v:
                self.tables[:, r].fill_(v)
        state = torch.zeros((2, self.n), dtype=torch.int64, device=device)
        self.groups, self.overflow = state[0], state[1]
        # the launch parameters, their lane kinds and rows set once
        self._launch = _MergeArgs()
        self._launch.rows = len(head)
        for lane, k in enumerate(self.kinds):
            self._launch.kinds[lane // 2] |= k << (4 * (lane % 2))

    def _args(self, sources: Sequence[torch.Tensor], n_owner: int,
              first: int, at: int, n: int) -> _MergeArgs:
        """The parameters of the launch for tables [at, at + n)."""
        a = self._launch
        src = sources if n_owner > 0 else sources[at:at + n]
        for y, e in enumerate(src):
            a.entries[y], a.m[y] = e.data_ptr(), e.shape[1]
        a.n_tables, a.n_owner, a.first = n, n_owner, first + at
        return a


def check_merge_kinds(kinds: Sequence[int]) -> None:
    """Raise ValueError for a lane kind that partial tables cannot merge:
    a float32 sum (the mesh sums float32 in float64) or a distinct lane."""
    if len(kinds) > MERGE_LANES:
        raise ValueError(f"{len(kinds)} lanes do not merge")
    for k in kinds:
        if k == LANE_SUM_F32 or k in _DISTINCT_LANES:
            raise ValueError(f"lane kind {k} does not merge")


def _check_sources(sources: Sequence[torch.Tensor], into: MergeTables,
                   n_owner: int) -> None:
    t = into.tables
    if len(sources) != (1 if n_owner > 0 else into.n):
        raise ValueError(f"{len(sources)} sources for {into.n} tables "
                         f"({'by owner' if n_owner > 0 else 'one each'})")
    for e in sources:
        if e.dtype != torch.int64 or e.dim() != 2 or \
                not e.is_contiguous() or e.device != t.device or \
                e.shape[0] != t.shape[1]:
            raise ValueError(f"entries must be a contiguous int64 "
                             f"[{t.shape[1]}, m] on the tables' device")


def merge_partials(sources: Sequence[torch.Tensor], into: MergeTables,
                   n_owner: int = 0, first: int = 0) -> MergeTables:
    """Fold partial entries (each `[rows, m]` int64: keys, counts, then a
    lane of each of `into.kinds`) into the local tables `into`. With
    `n_owner` > 0 (the all_gather route) `sources` is one tensor, each
    entry going to table `shard_owner(key, n_owner) - first` and skipped
    where that is not a local table; otherwise (the shuffle route) source
    i folds into table i.

    On CPU tensors this runs `merge_partials_plain`; on CUDA tensors it
    launches the K2 kernel, once for every MERGE_TABLES tables that have
    an entry to fold, or raises."""
    _check_sources(sources, into, n_owner)
    if not _cuda(into.tables):
        return merge_partials_plain(sources, into, n_owner, first)
    lib = kernels.library()
    t = into.tables
    ptrs = t.data_ptr(), into.groups.data_ptr(), into.overflow.data_ptr()
    with torch.cuda.device(t.device):
        for at in range(0, into.n, MERGE_TABLES):
            n = min(MERGE_TABLES, into.n - at)
            src = sources if n_owner > 0 else sources[at:at + n]
            if not any(e.shape[1] for e in src):
                continue
            args = into._args(sources, n_owner, first, at, n)
            kernels.check(lib.dft_merge_partials(
                ctypes.byref(args), ptrs[0] + 8 * at * t.stride(0),
                into.cap, ptrs[1] + 8 * at, into.limit, ptrs[2] + 8 * at,
                _stream(t.device)), merge_partials_kernel)
            merge_partials_kernel.launches += 1
    return into


def merge_partials_plain(sources: Sequence[torch.Tensor],
                         into: MergeTables, n_owner: int = 0,
                         first: int = 0) -> MergeTables:
    """The plain PyTorch version, a table at a time: its entries (by owner,
    or its own source) interned with `torch.unique` against the table's
    keys (new keys at the lowest free slots, in key order), then
    `index_add_` / `scatter_reduce_` a row."""
    if n_owner > 0:
        keys = sources[0][0]
        own = torch.where(keys != EMPTY, shard_owner(keys, n_owner), -1)
        picked = [sources[0][:, own == first + i] for i in range(into.n)]
    else:
        picked = [e[:, e[0] != EMPTY] for e in sources]
    for i, e in enumerate(picked):
        _merge_plain(e, into, i)
    return into


def _merge_plain(e: torch.Tensor, into: MergeTables, i: int) -> None:
    t = into.tables[i]
    if e.shape[1] == 0:
        return
    uk, inv = torch.unique(e[0], return_inverse=True)
    live = (t[0] != EMPTY).nonzero().squeeze(1)
    lkeys, order = t[0][live].sort()
    uslot = torch.full_like(uk, -1)
    if lkeys.numel():
        pos = torch.searchsorted(lkeys, uk).clamp(max=lkeys.numel() - 1)
        hit = lkeys[pos] == uk
        uslot[hit] = live[order[pos[hit]]]
    new = (uslot < 0).nonzero().squeeze(1)
    free = (t[0] == EMPTY).nonzero().squeeze(1)[:new.numel()]
    uslot[new[:free.numel()]] = free
    t[0][free] = uk[new[:free.numel()]]
    into.groups[i] += free.numel()   # the keys claimed, as the kernel counts
    if free.numel() < new.numel() or int(into.groups[i].item()) > into.limit:
        into.overflow[i] = 1
    slot = uslot[inv]
    ok = slot >= 0
    slot, e = slot[ok], e[:, ok]
    t[1].index_add_(0, slot, e[1])
    for lane, kind in enumerate(into.kinds):
        row, x = t[2 + lane], e[2 + lane]
        if kind in (LANE_MIN_I64, LANE_MAX_I64):
            row.scatter_reduce_(0, slot, x,
                                "amin" if kind == LANE_MIN_I64 else "amax")
        elif kind in (LANE_MIN_F64, LANE_MAX_F64):
            row.view(torch.float64).scatter_reduce_(
                0, slot, x.view(torch.float64),
                "amin" if kind == LANE_MIN_F64 else "amax")
        elif kind == LANE_SUM_F64:
            row.view(torch.float64).index_add_(0, slot,
                                               x.view(torch.float64))
        else:
            row.index_add_(0, slot, x)
