"""A fanout-1 join chain fused with grouped aggregation: build staging and
the probe walk.

Counterpart of the device half of
`datafusion_tpu/physical/plan/device_join_chain.py`. The spine (the
largest relation) is the probe stream; every other relation is a build
side joined through a unique key (INNER) or a membership test (LEFTSEMI,
LEFTANTI).

Build staging (`chain_build`, kernel `csrc/chain_build.cu`). Counterpart
of `_unfiltered_lut` (`:177`), the per-query mask LUT (`:638-650`), the host
sorted-key packing (`:657-711`), `_stage_build_device` (`:1069`) and
`_stage_semi_member_lut` (`:1158`). One pass over the build rows counts
the rows that pass the build predicate with every key valid and takes each
key's min and max; the host reads those few words and lays the table out
(`table_layout`); a second pass packs each live row's keys as
`sum((v_k - lo_k) << shift_k)` and inserts its row into a direct-address
int32 table (row or -1) when the packed span is at most 16 x rows and
2^26, else into an open-addressing table of (int64 key, int32 row) of
2 x next_pow2(rows) slots. A second row for a key marks a duplicate: an
INNER build with one has fanout > 1 and the exec runs its host plan.
NULL keys are never inserted.

The walk (`chain_aggregate`, kernel `csrc/chain_aggregate.cu`). Counterpart
of `_chain_walk` (`:1597`), `_chain_core` (`:1783`), `_make_chain_step`
(`:1920`) and the row-space programs (`:1946`, `:1994`). Every program
(probe predicate, each hop's probe keys, the residual, the group keys and
the lane arguments) reads the pair space: spine columns first, then each
INNER hop's payload columns in chain order (`ChainBuild`'s docstring,
`:228-236`). A payload column reads its build column at the row its hop
found, so no joined column is materialised. The walk feeds the grouped
fold of `device/groupby.py` (dense slots or a hash table), whose output
table `compact_groups` and the host emit take as they are.

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its CUDA kernel on CUDA tensors, or raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .groupby import (EMPTY, H_OFF_KEYS, AggregateSpec, Columns, HashSpec,
                      _cuda, _next_pow2, _ProgramSpec, _stream,
                      dense_group_aggregate_plain, hash_group_aggregate_plain)
from .lower import LoweringError, Pools, Program, evaluate

chain_build_kernel = kernels.register(kernels.Kernel(
    "chain_build", "datafusion_tpu_torch/csrc/chain_build.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:177"))
chain_aggregate_kernel = kernels.register(kernels.Kernel(
    "chain_aggregate", "datafusion_tpu_torch/csrc/chain_aggregate.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:1597"))

# build table kinds and hop join types (mirrored in csrc/program.cuh)
TAB_DIRECT, TAB_HASH, TAB_EMPTY = range(3)
JT_INNER, JT_SEMI, JT_ANTI = range(3)
JOIN_TYPES = {"INNER": JT_INNER, "LEFTSEMI": JT_SEMI, "LEFTANTI": JT_ANTI}

# the chain section of a descriptor: a head, a record per hop, then the
# hop of every pair-space column (-1: spine)
C_NSPINE, C_NHOPS, C_PPRED, C_OFF_HOPOF, C_HOPS = range(5)
(HOP_KIND, HOP_JTYPE, HOP_TABLE, HOP_KEYS, HOP_SIZE, HOP_NKEYS,
 HOP_KEY0) = range(7)
MAX_HOPS = 8
MAX_HOP_KEYS = 4
HOP_WORDS = HOP_KEY0 + 4 * MAX_HOP_KEYS    # (prog, lo, hi, shift) per key

DIRECT_FILL = 16          # a direct table spans at most 16 x its rows
DIRECT_MAX = 1 << 26      # and at most 2^26 slots (256 MB of int32)

_I64_MAX = int(np.iinfo(np.int64).max)
_I64_MIN = int(np.iinfo(np.int64).min)


# --- build staging -------------------------------------------------------------

class BuildSpec(_ProgramSpec):
    """The build predicate and key programs of one build side, over its
    batch's columns. The kernel reads the keys from the descriptor's key
    section as (program, lo, shift); `packed_meta` fills lo and shift in
    once the range pass has run."""

    def __init__(self, pools: Pools, pred: Optional[Program],
                 keys: Sequence[Program]):
        if not 1 <= len(keys) <= MAX_HOP_KEYS:
            raise LoweringError(f"{len(keys)} build keys")
        if any(k.is_float for k in keys):
            raise LoweringError("float join key")
        super().__init__(pools, pred, [(k, 0, 0) for k in keys], [])
        self.meta = self._layout(0)

    def key_programs(self) -> List[Program]:
        return [p for p, _o, _s in self.keys]

    def packed_meta(self, los: Sequence[int],
                    shifts: Sequence[int]) -> np.ndarray:
        meta = self.meta.copy()
        base = int(meta[H_OFF_KEYS])
        for k, (lo, shift) in enumerate(zip(los, shifts)):
            meta[base + 3 * k + 1] = lo
            meta[base + 3 * k + 2] = shift
        return meta


class BuildTable:
    """One staged build side: `kind` (TAB_DIRECT, TAB_HASH or TAB_EMPTY),
    each key's range [lo, hi] among the live rows and its shift in the
    packed key, the table's `size`, `rows` (int32: the build row, -1
    absent; slot-aligned with `keys`, int64, for a hashed table), the
    number of `live` rows and whether a key had two rows (`duplicate`)."""

    def __init__(self, kind: int, los, his, shifts, size: int,
                 rows: torch.Tensor, keys: Optional[torch.Tensor],
                 live: int, duplicate: bool):
        self.kind = kind
        self.los, self.his, self.shifts = list(los), list(his), list(shifts)
        self.size = int(size)
        self.rows = rows
        self.keys = keys
        self.live = int(live)
        self.duplicate = bool(duplicate)

    def entries(self) -> Tuple[np.ndarray, np.ndarray]:
        """(packed key, build row) of every entry, ordered by key."""
        rows = self.rows.cpu().numpy().astype(np.int64)
        if self.kind == TAB_HASH:
            keys = self.keys.cpu().numpy()
            live = keys != EMPTY
            keys, rows = keys[live], rows[live]
        else:
            keys = np.flatnonzero(rows >= 0)
            rows = rows[keys]
        order = np.argsort(keys, kind="stable")
        return keys[order], rows[order]


def table_layout(live: int, los: Sequence[int], his: Sequence[int]):
    """(kind, shifts, size) of a build table for `live` rows whose keys
    span [lo_k, hi_k]: each key takes the bits of hi_k - lo_k, packed low
    key first; direct-address when the packed span is at most
    DIRECT_FILL x live and DIRECT_MAX, else hashed at 2 x next_pow2(live)
    slots. The reference stops direct tables at 2^24 slots (`:202`);
    TPC-H's o_orderkey spans 4x its rows, 60M at SF10."""
    if live == 0:
        return TAB_EMPTY, [0] * len(los), 1
    shifts, shift = [], 0
    for lo, hi in zip(los, his):
        shifts.append(shift)
        shift += max(int(hi - lo).bit_length(), 1)
    if shift > 62:
        raise LoweringError(f"chain join key bits {shift} > 62")
    span = sum((hi - lo) << s for lo, hi, s in zip(los, his, shifts)) + 1
    if span <= min(DIRECT_FILL * live, DIRECT_MAX):
        return TAB_DIRECT, shifts, span
    return TAB_HASH, shifts, 2 * _next_pow2(live)


def _check_build(spec: BuildSpec, cols: Columns, aux: torch.Tensor,
                 n_rows: int) -> None:
    dev = aux.device
    if aux.dtype != torch.int64 or not aux.is_contiguous():
        raise ValueError("aux must be a contiguous int64 tensor")
    if n_rows >= 1 << 31:
        raise ValueError("a build side holds at most 2^31 - 1 rows")
    for idx in spec.pools.columns:
        data, valid = cols[idx]
        if data.device != dev or not data.is_contiguous() or \
                data.dtype != spec.column_dtype(idx) or \
                data.shape[0] < n_rows:
            raise ValueError(f"build column {idx}: contiguous "
                             f"{spec.column_dtype(idx)} of {n_rows} rows "
                             f"on {dev} expected")
        if valid is not None and (valid.device != dev or
                                  valid.dtype != torch.bool or
                                  valid.shape[0] < n_rows):
            raise ValueError(f"build column {idx}: bad validity")


def chain_build(spec: BuildSpec, cols: Columns, aux: torch.Tensor,
                n_rows: int, unique: bool) -> BuildTable:
    """Stage the first `n_rows` rows of `cols` as a build table; with
    `unique` (an INNER build) a key with two rows sets `duplicate`.

    On CPU tensors this runs `chain_build_plain`; on CUDA tensors it
    launches the `chain_build` kernel's two passes or raises. It reads the
    key ranges back to lay the table out, and the duplicate flag when
    `unique`: one or two synchronisations."""
    _check_build(spec, cols, aux, n_rows)
    dev = aux.device
    if not _cuda(aux):
        return chain_build_plain(spec, cols, aux, n_rows, unique)
    lib = kernels.library()
    n_keys = len(spec.keys)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        stats = torch.tensor([0] + [_I64_MAX, _I64_MIN] * n_keys,
                             dtype=torch.int64, device=dev)
        if n_rows:
            meta_d = spec.device_meta(cols, dev)
            kernels.check(lib.dft_chain_build_range(
                meta_d.data_ptr(), len(spec.meta), aux.data_ptr(), n_rows,
                stats.data_ptr(), stream), chain_build_kernel)
            chain_build_kernel.launches += 1
        host = stats.cpu().tolist()
        live, los, his = host[0], host[1::2], host[2::2]
        kind, shifts, size = table_layout(live, los, his)
        rows = torch.full((size,), -1, dtype=torch.int32, device=dev)
        keys = torch.full((size,), EMPTY, dtype=torch.int64, device=dev) \
            if kind == TAB_HASH else None
        duplicate = False
        if kind != TAB_EMPTY:
            dup = torch.zeros(1, dtype=torch.int32, device=dev)
            meta = spec.packed_meta(los, shifts)
            meta_d = spec.device_meta(cols, dev, meta)
            kernels.check(lib.dft_chain_build_insert(
                meta_d.data_ptr(), len(meta), aux.data_ptr(), n_rows, kind,
                size, rows.data_ptr(),
                None if keys is None else keys.data_ptr(), dup.data_ptr(),
                stream), chain_build_kernel)
            chain_build_kernel.launches += 1
            flag = int(dup.item()) if unique else 0
            if flag == 2:
                raise RuntimeError("chain build table overflowed")
            duplicate = flag == 1
    return BuildTable(kind, los, his, shifts, size, rows, keys, live,
                      duplicate)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _i64(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 of int64 keys in two's-complement int64 arithmetic, bit
    for bit the hash of `csrc/program.cuh`."""
    x = x + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _srl(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


def _hash_insert_plain(packed: torch.Tensor, rows: torch.Tensor, cap: int):
    """(keys, rows) of an open-addressing table of `cap` slots holding each
    distinct key of `packed` with its first row: linear probing from
    splitmix64, in rounds, the lowest pending key winning a contested free
    slot."""
    dev = packed.device
    uk, inv = torch.unique(packed, return_inverse=True)
    n = packed.numel()
    first = torch.full((uk.numel(),), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(n, device=dev), "amin")
    urow = rows[first].to(torch.int32)
    keys = torch.full((cap,), EMPTY, dtype=torch.int64, device=dev)
    table = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    pos = splitmix64(uk) & (cap - 1)
    pending = torch.arange(uk.numel(), device=dev)
    while pending.numel():
        slot = pos[pending]
        free = keys[slot] == EMPTY
        win = torch.full((cap,), uk.numel(), dtype=torch.int64, device=dev)
        win.scatter_reduce_(0, slot[free], pending[free], "amin")
        won = free & (win[slot] == pending)
        keys[slot[won]] = uk[pending[won]]
        table[slot[won]] = urow[pending[won]]
        pending = pending[~won]
        pos[pending] = (pos[pending] + 1) & (cap - 1)
    return keys, table


def chain_build_plain(spec: BuildSpec, cols: Columns, aux: torch.Tensor,
                      n_rows: int, unique: bool) -> BuildTable:
    """The plain PyTorch version: the programs interpreted over whole
    tensors, the ranges by `min`/`max`, duplicates by `torch.unique`, the
    rows placed by indexing (direct) or by rounds of linear probing."""
    dev = aux.device
    n = n_rows
    live = torch.ones(n, dtype=torch.bool, device=dev)
    if spec.pred is not None:
        d, v = evaluate(spec.pred, cols, aux, n)
        live &= (d != 0) & v
    vals = []
    for prog in spec.key_programs():
        d, v = evaluate(prog, cols, aux, n)
        live &= v
        vals.append(d)
    n_live = int(live.sum())
    los = [int(v[live].min()) if n_live else _I64_MAX for v in vals]
    his = [int(v[live].max()) if n_live else _I64_MIN for v in vals]
    kind, shifts, size = table_layout(n_live, los, his)
    rows = torch.full((size,), -1, dtype=torch.int32, device=dev)
    if kind == TAB_EMPTY:
        return BuildTable(kind, los, his, shifts, size, rows, None, 0, False)
    packed = torch.zeros(n_live, dtype=torch.int64, device=dev)
    for v, lo, shift in zip(vals, los, shifts):
        packed |= (v[live] - lo) << shift
    row_ids = live.nonzero().squeeze(1)
    duplicate = unique and torch.unique(packed).numel() < n_live
    keys = None
    if kind == TAB_DIRECT:
        rows[packed] = row_ids.to(torch.int32)
    else:
        keys, rows = _hash_insert_plain(packed, row_ids, size)
    return BuildTable(kind, los, his, shifts, size, rows, keys, n_live,
                      duplicate)


# --- the walk ------------------------------------------------------------------

class Hop:
    """One hop of the walk: its build table, join type, probe-key programs
    (over the pair space) and the pair-space indices of its payload."""

    def __init__(self, table: BuildTable, join_type: str,
                 probe_keys: Sequence[Program], payload: Sequence[int]):
        if join_type not in JOIN_TYPES:
            raise LoweringError(f"{join_type} join in a chain")
        if len(probe_keys) != len(table.los):
            raise ValueError("one probe key per build key")
        if any(k.is_float for k in probe_keys):
            raise LoweringError("float join key")
        self.table = table
        self.jtype = JOIN_TYPES[join_type]
        self.probe_keys = list(probe_keys)
        self.payload = list(payload)


class Chain:
    """The walk of one chain: spine width, probe predicate and hops."""

    def __init__(self, n_spine: int, ppred: Optional[Program],
                 hops: Sequence[Hop]):
        if len(hops) > MAX_HOPS:
            raise LoweringError(f"{len(hops)} hops > {MAX_HOPS}")
        self.n_spine = n_spine
        self.ppred = ppred
        self.hops = list(hops)
        self.hop_of: Dict[int, int] = {}
        for h, hop in enumerate(self.hops):
            for p in hop.payload:
                self.hop_of[p] = h

    def programs(self) -> List[Program]:
        out = [self.ppred] if self.ppred is not None else []
        for hop in self.hops:
            out += hop.probe_keys
        return out

    def section(self, index: Dict[int, int], ncols: int) -> np.ndarray:
        head = [self.n_spine, len(self.hops),
                -1 if self.ppred is None else index[id(self.ppred)],
                C_HOPS + HOP_WORDS * len(self.hops)]
        recs = np.zeros((len(self.hops), HOP_WORDS), np.int64)
        for rec, hop in zip(recs, self.hops):
            t = hop.table
            rec[:HOP_KEY0] = [t.kind, hop.jtype, t.rows.data_ptr(),
                              0 if t.keys is None else t.keys.data_ptr(),
                              t.size, len(hop.probe_keys)]
            for k, prog in enumerate(hop.probe_keys):
                rec[HOP_KEY0 + 4 * k:HOP_KEY0 + 4 * k + 4] = [
                    index[id(prog)], t.los[k], t.his[k], t.shifts[k]]
        hop_of = [self.hop_of.get(i, -1) for i in range(ncols)]
        return np.concatenate([np.asarray(head, np.int64), recs.ravel(),
                               np.asarray(hop_of, np.int64)])


class _ChainSpec:
    """A grouped fold (dense or hash) whose rows come through a join chain:
    the chain's programs join the descriptor's program list, and its
    section follows the lanes."""

    def _init_chain(self, chain: Chain):
        self.chain = chain

    def programs(self) -> List[Program]:
        return super().programs() + self.chain.programs()

    def _chain_section(self, index: Dict[int, int]) -> np.ndarray:
        return self.chain.section(index, self.ncols)


class ChainDenseSpec(_ChainSpec, AggregateSpec):
    def __init__(self, pools, pred, keys, lanes, chain: Chain):
        self._init_chain(chain)
        super().__init__(pools, pred, keys, lanes)


class ChainHashSpec(_ChainSpec, HashSpec):
    def __init__(self, pools, pred, keys, lanes, rows: int, chain: Chain):
        self._init_chain(chain)
        super().__init__(pools, pred, keys, lanes, rows)


def _check_chain(spec, cols: Columns, aux: torch.Tensor, n_rows: int,
                 table: torch.Tensor) -> None:
    dev = table.device
    if table.dtype != torch.int64 or not table.is_contiguous() or \
            tuple(table.shape) != spec.table_shape:
        raise ValueError(f"table must be a contiguous int64 "
                         f"{list(spec.table_shape)}")
    if aux.device != dev or aux.dtype != torch.int64 or \
            not aux.is_contiguous():
        raise ValueError("aux must be a contiguous int64 tensor on the "
                         "table's device")
    for hop in spec.chain.hops:
        for t in (hop.table.rows, hop.table.keys):
            if t is not None and t.device != dev:
                raise ValueError("a build table lies on another device")
    for idx in spec.pools.columns:
        if idx not in cols:
            raise ValueError(f"column {idx} is read but not given")
        data, valid = cols[idx]
        spine = spec.chain.hop_of.get(idx, -1) < 0
        if data.device != dev or not data.is_contiguous() or \
                data.dim() != 1 or data.dtype != spec.column_dtype(idx):
            raise ValueError(f"column {idx}: contiguous 1-D "
                             f"{spec.column_dtype(idx)} on {dev} expected")
        if spine and data.shape[0] < n_rows:
            raise ValueError(f"spine column {idx} shorter than {n_rows} rows")
        if valid is not None and (valid.device != dev or
                                  valid.dtype != torch.bool or
                                  valid.shape[0] < data.shape[0]):
            raise ValueError(f"column {idx}: bad validity")


def chain_aggregate(spec, cols: Columns, aux: torch.Tensor, n_rows: int,
                    table: torch.Tensor,
                    overflow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Walk the chain for the first `n_rows` spine rows and fold the rows
    that survive it into `table` in place: a dense `[lanes + 1, G]` table
    for a ChainDenseSpec, a hash table `[lanes + 2, cap]` and its int32
    `overflow` flag for a ChainHashSpec. `cols` maps pair-space indices to
    (data, validity): spine columns of the batch, payload columns of whole
    build batches.

    On CPU tensors this runs `chain_aggregate_plain`; on CUDA tensors it
    launches the `chain_aggregate` kernel or raises."""
    _check_chain(spec, cols, aux, n_rows, table)
    dense = isinstance(spec, AggregateSpec)
    if not dense and (overflow is None or overflow.device != table.device):
        raise ValueError("a hash fold needs its overflow flag")
    if not _cuda(table):
        return chain_aggregate_plain(spec, cols, aux, n_rows, table,
                                     overflow)
    if n_rows == 0:
        return table
    lib = kernels.library()
    with torch.cuda.device(table.device):
        meta_d = spec.device_meta(cols, table.device)
        rc = lib.dft_chain_aggregate(
            meta_d.data_ptr(), len(spec.meta), len(spec.lanes),
            spec.groups if dense else 0, aux.data_ptr(), n_rows,
            0 if dense else spec.cap,
            0 if dense else (1 if spec.identity_slots else 2),
            table.data_ptr(), None if dense else overflow.data_ptr(),
            _stream(table.device))
    kernels.check(rc, chain_aggregate_kernel)
    chain_aggregate_kernel.launches += 1
    return table


def _lookup_plain(hop: Hop, pair: Columns, aux: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The build row each row finds in `hop`'s table, -1 for none."""
    t = hop.table
    dev = aux.device
    miss = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if t.kind == TAB_EMPTY:
        return miss
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    packed = torch.zeros(n, dtype=torch.int64, device=dev)
    for prog, lo, hi, shift in zip(hop.probe_keys, t.los, t.his, t.shifts):
        d, v = evaluate(prog, pair, aux, n)
        inside = v & (d >= lo) & (d <= hi)
        ok &= inside
        packed |= torch.where(inside, d - lo, 0) << shift
    if t.kind == TAB_DIRECT:
        brow = t.rows[packed.clamp(0, t.size - 1)].to(torch.int64)
    else:
        live = (t.keys != EMPTY).nonzero().squeeze(1)
        skeys, order = t.keys[live].sort()
        pos = torch.searchsorted(skeys, packed).clamp(max=skeys.numel() - 1)
        hit = skeys[pos] == packed
        brow = torch.where(hit, t.rows[live[order[pos]]].to(torch.int64), -1)
    return torch.where(ok, brow, miss)


def chain_aggregate_plain(spec, cols: Columns, aux: torch.Tensor,
                          n_rows: int, table: torch.Tensor,
                          overflow: Optional[torch.Tensor] = None,
                          hop_rows: Optional[list] = None) -> torch.Tensor:
    """The plain PyTorch version: each hop's lookup over whole tensors
    (`_lookup_plain`), the payload columns gathered by the found rows,
    then the grouped fold's plain version over the surviving rows. With
    `hop_rows`, appends (rows that reach the hop, rows still alive after
    it) for each hop: the walk's data-dependent work."""
    n = n_rows
    if n == 0:
        return table
    dev = aux.device
    hop_of = spec.chain.hop_of
    pair = {i: c for i, c in cols.items() if hop_of.get(i, -1) < 0}
    rows = torch.ones(n, dtype=torch.bool, device=dev)
    if spec.chain.ppred is not None:
        d, v = evaluate(spec.chain.ppred, pair, aux, n)
        rows &= (d != 0) & v
    for hop in spec.chain.hops:
        brow = _lookup_plain(hop, pair, aux, n)
        found = brow >= 0
        reach = int(rows.sum()) if hop_rows is not None else 0
        rows &= ~found if hop.jtype == JT_ANTI else found
        if hop_rows is not None:
            hop_rows.append((reach, int(rows.sum())))
        at = brow.clamp(min=0)
        for p in hop.payload:
            if p not in cols:
                continue
            data, valid = cols[p]
            if data.numel() == 0:       # an empty build finds nothing
                pair[p] = (torch.zeros(n, dtype=data.dtype, device=dev),
                           torch.zeros(n, dtype=torch.bool, device=dev))
                continue
            ok = found if valid is None else found & valid[at]
            pair[p] = (data[at], ok)
    if isinstance(spec, AggregateSpec):
        return dense_group_aggregate_plain(spec, pair, aux, n, table, rows)
    return hash_group_aggregate_plain(spec, pair, aux, n, table, overflow,
                                      rows)
