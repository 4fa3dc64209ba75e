"""Grouped aggregation fused with filter, key packing and lanes: dense slots,
a hash table, and the compaction and top-k selection of the group table.

Dense path. Counterpart of `datafusion_tpu/device/groupby.py:70-111`
(`_dense_group_aggregate`) fused with its prologue
`DeviceGroupAggregateExec._make_step.prepare`
(`datafusion_tpu/physical/plan/device_aggregate.py:679-769`): the group
table is one `[lanes + 1, G]` int64 tensor (float lanes hold float64
bits), G <= 64. Per row: the predicate program decides whether the row
counts; each key program packs `(v - offset + 1) << shift` into the slot
(0 = NULL); each lane program is evaluated and folded into the slot under
the rules of `prepare` (NaN is masked out of float min/max and counted in
a NANCNT lane). Lane 0 counts the rows of each slot; a slot with a nonzero
count is a group. Every batch accumulates into the same table.

Hash path. For key spaces above 64 slots: the same programs, with the
packed key inserted into an open-addressing table of `[lanes + 2, cap]`
int64 (row 0 the keys, EMPTY = -1; row 1 the row counts; then the lanes).
It stands for the JAX sort path (`device/groupby.py:159`, `:117`), its
row-space path (`:292`, `:356`), the chunk merge and overflow marker
(`device_aggregate.py:973`, `:97`) and the unbounded path (`:393`): the
caller sizes `cap` from the input, so the table never fills and every
batch folds into it. Float32 sums keep a float32 accumulator (SUM_F32), as
the JAX sparse path does (`device_aggregate.py:725-728`).

Lanes past 32 (ClickBench Q30's 180). A descriptor holds at most
MAX_LANES lanes; a spec with more lays out one descriptor a pass
(`metas`), each with its first lane row (H_LANE0), and a wrapper launches
its kernel once a pass over the same rows into the same table. The first
pass counts the rows and, in hash mode, claims every key's slot; later
passes find the same slots by the same probe sequence before reaching any
EMPTY one. The plain versions fold every lane at once.

count(DISTINCT x). A lane kind (LANE_DISTINCT, or LANE_DISTINCT_F64 for a
float argument, whose -0.0 counts as 0.0): each admitted row with a valid
argument inserts the pair (slot and lane, value) into a `DistinctSet`, a
global open-addressing set the caller sizes at twice the pairs there can
be, and a pair that is new adds 1 to the group's lane. It stands for the
reference's (key, value) sort and run count (`device/groupby.py:214-228`,
the row-space lane `:338-350`), without its one-chunk limit: the set
persists across batches as the table does. NULL is never counted, and a
real INT64_MIN is a value like any other (the reference uses it as its
NULL marker, `device_aggregate.py:732-743`). The plain version finds the
new pairs with `torch.unique` against the pairs already in the set.

Emit. `compact_groups` keeps the occupied slots of a `[lanes + 2, cap]`
table, optionally those that pass a HAVING program over the finalised
output columns (`_apply_post_filter`, `device_aggregate.py:1279`), or the
slots of a list that `group_topk` chose (`_emit_topk`, `:1127`). One
`.cpu()` of its `[lanes + 2, ng]` output brings the groups to the host.

Resident emit. `group_emit_columns` turns the live groups of a compacted
table into typed device columns that never leave the card: each group
key unpacked from the packed key word, each count, each non-float sum
with its validity (`_emit_device_resident`, `device_aggregate.py:899`).
A large group table's consumer (a join build) reads them in place.

Row permutation. `reorder_rows` moves many row-aligned lanes through one
int64 index list with `csrc/gather_lanes.cu`, the counterpart of
`reorder_rows_packed` (`datafusion_tpu/device/groupby.py:237`): like it,
it packs the lanes into row records and gathers whole records, records
laid out for the H100's 32-byte sector (`gather_plan`). The window
evaluation (`device/window.py`) carries its words and value lanes into
sorted order with it.

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its CUDA kernel (`csrc/`) on CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .lower import FULL_OPS_FROM, LoweringError, Pools, Program, evaluate

fused_dense_aggregate = kernels.register(kernels.Kernel(
    "fused_dense_aggregate", "datafusion_tpu_torch/csrc/fused_dense_aggregate.cu",
    "datafusion_tpu/physical/plan/device_aggregate.py:679"))
hash_group_aggregate_kernel = kernels.register(kernels.Kernel(
    "hash_group_aggregate", "datafusion_tpu_torch/csrc/hash_group_aggregate.cu",
    "datafusion_tpu/device/groupby.py:159"))
compact_groups_kernel = kernels.register(kernels.Kernel(
    "compact_groups", "datafusion_tpu_torch/csrc/compact_groups.cu",
    "datafusion_tpu/physical/plan/device_aggregate.py:1279"))
group_topk_kernel = kernels.register(kernels.Kernel(
    "group_topk", "datafusion_tpu_torch/csrc/group_topk.cu",
    "datafusion_tpu/physical/plan/device_aggregate.py:1127"))
gather_lanes_kernel = kernels.register(kernels.Kernel(
    "gather_lanes", "datafusion_tpu_torch/csrc/gather_lanes.cu",
    "datafusion_tpu/device/groupby.py:237"))
group_emit_kernel = kernels.register(kernels.Kernel(
    "group_emit", "datafusion_tpu_torch/csrc/group_emit.cu",
    "datafusion_tpu/physical/plan/device_aggregate.py:899"))

# lane kinds (mirrored in csrc/program.cuh)
LANE_ROWS = 0        # +1 per row that passed the predicate (count(*))
LANE_CNT = 1         # +1 per row whose argument is valid
LANE_SUM_I64 = 2
LANE_SUM_F64 = 3     # float32 arguments too on the dense path: it widens them
LANE_MIN_I64 = 4
LANE_MAX_I64 = 5
LANE_MIN_F64 = 6     # NaN masked out
LANE_MAX_F64 = 7
LANE_NANCNT = 8      # +1 per valid NaN argument
LANE_SUM_F32 = 9     # hash path: a float32 sum in the cell's low word
LANE_DISTINCT = 10   # count(DISTINCT x) of an integer (or code) argument
LANE_DISTINCT_F64 = 11   # of a float argument: its float64 bits, -0.0 as 0.0
_DISTINCT_LANES = (LANE_DISTINCT, LANE_DISTINCT_F64)

MAX_GROUPS = 64      # dense slots; larger key spaces take the hash path
MAX_LANES = 32       # lanes a pass of a kernel folds
MAX_ALL_LANES = 1 << 12   # a distinct pair's group word holds the lane in 12 bits
MAX_DISTINCT_ENTRIES = 1 << 30   # 24 GiB of set entries
SMEM_BYTES = 48 * 1024   # a kernel's shared descriptor (+ the dense table)
EMPTY = -1           # key of a free hash slot
MAX_TOPK = 1 << 16
# csrc/group_topk.cu: its launches a call (the compaction, one select round
# a byte, the gather), its 32-bit candidate slots and the most candidates
# it lists (12 bytes each: 96 MiB; past them it reads the table instead)
TOPK_LAUNCHES = 10
TOPK_MAX_SLOTS = 1 << 32
TOPK_CANDIDATES = 1 << 23
# csrc/compact_groups.cu: entries a tile, and keep words (32 entries) a tile
COMPACT_TILE = 4096
COMPACT_WORDS = COMPACT_TILE // 32
# csrc/gather_lanes.cu: the bytes of a record (a group of lanes), and the
# sector whose size pads it
GATHER_MAX_RECORD = 128
GATHER_SECTOR = 32

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min
_IDENTITY = {
    LANE_MIN_I64: _I64_MAX, LANE_MAX_I64: _I64_MIN,
    LANE_MIN_F64: int(np.float64(np.inf).view(np.int64)),
    LANE_MAX_F64: int(np.float64(-np.inf).view(np.int64)),
}
_FLOAT_LANES = (LANE_SUM_F64, LANE_MIN_F64, LANE_MAX_F64)

# column dtype codes of the kernels' loads
_DTYPE_CODE = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
               torch.float32: 3, torch.float64: 4}
_NP_TO_TORCH = {np.dtype(np.bool_): torch.bool,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}

# meta header: int64 words at the start of a kernel's descriptor
# (H_LANE0: the pass's first lane row; H_DSET, H_DMASK: the distinct set's
# words and its entries - 1, filled in per launch)
(H_NCOLS, H_NLANES, H_G, H_NKEYS, H_PRED, H_OFF_COLS, H_OFF_PROGS,
 H_OFF_CODE, H_OFF_ICONST, H_OFF_FCONST, H_OFF_KEYS, H_OFF_LANES,
 H_OFF_CHAIN, H_LANE0, H_DSET, H_DMASK) = range(16)
HEADER = 16
_SECTIONS = (H_OFF_COLS, H_OFF_PROGS, H_OFF_CODE, H_OFF_ICONST, H_OFF_FCONST,
             H_OFF_KEYS, H_OFF_LANES, H_OFF_CHAIN)

Columns = Dict[int, Tuple[torch.Tensor, Optional[torch.Tensor]]]


def lane_kind(cat: str, prog: Optional[Program], f32_sums: bool = False) -> int:
    """The lane kind of a slot category of `DeviceGroupAggregateExec`
    (`sum`, `cnt`, `min`, `max`, `nancnt`, `distinct`, and `rowid`: a join
    chain's representative spine row, the max of `OP_ROWID`) over `prog`'s
    values. With `f32_sums` (the hash path) a float32 sum keeps a float32
    lane."""
    if prog is None:
        return LANE_ROWS
    if cat == "rowid":
        return LANE_MAX_I64
    f = prog.is_float
    if cat == "distinct":
        return LANE_DISTINCT_F64 if f else LANE_DISTINCT
    fsum = LANE_SUM_F32 if f32_sums and prog.out_dtype == np.float32 \
        else LANE_SUM_F64
    kinds = {"cnt": LANE_CNT, "sum": fsum if f else LANE_SUM_I64,
             "min": LANE_MIN_F64 if f else LANE_MIN_I64,
             "max": LANE_MAX_F64 if f else LANE_MAX_I64}
    if cat == "nancnt":
        if not f:
            raise LoweringError("nancnt over an integer lane")
        return LANE_NANCNT
    if cat not in kinds:
        raise LoweringError(f"slot {cat} not on the device path")
    return kinds[cat]


def _descriptor(head: Dict[int, int], sections: Sequence[np.ndarray]
                ) -> np.ndarray:
    """Header words `head` plus the sections, whose offsets fill
    H_OFF_COLS .. H_OFF_CHAIN in order."""
    out = np.zeros(HEADER, np.int64)
    for h, v in head.items():
        out[h] = v
    sections = [np.asarray(s, np.int64).reshape(-1) for s in sections]
    off = HEADER
    for h, sec in zip(_SECTIONS, sections):
        out[h] = off
        off += len(sec)
    return np.concatenate([out, *sections])


def _program_sections(progs: Sequence[Program], pools: Pools):
    """The programs, code, iconst and fconst sections of a descriptor."""
    code, starts = [], []
    for p in progs:
        starts.append((len(code), len(p.code)))
        code.extend(p.code)
    return [np.asarray(starts, np.int64), np.asarray(code, np.int64),
            np.asarray(pools.iconst, np.int64),
            np.asarray(pools.fconst, np.float64).view(np.int64)]


class _ProgramSpec:
    """Predicate, packed keys and lanes of one aggregate, with the kernel's
    descriptor laid out once; only column pointers change per batch."""

    def __init__(self, pools: Pools, pred: Optional[Program],
                 keys: Sequence[Tuple[Program, int, int]],
                 lanes: Sequence[Tuple[Optional[Program], int]]):
        self.pools = pools
        self.pred = pred
        shift, self.keys = 0, []
        for prog, offset, bits in keys:
            if prog.is_float:
                raise LoweringError("float group key")
            self.keys.append((prog, int(offset), shift))
            shift += int(bits)
        self.key_bits = shift
        self.lanes = list(lanes)
        if len(self.lanes) >= MAX_ALL_LANES:
            raise LoweringError(f"{len(self.lanes)} lanes")
        # (first lane, lanes) of each pass of the kernels
        self.passes = [(at, self.lanes[at:at + MAX_LANES])
                       for at in range(0, max(len(self.lanes), 1), MAX_LANES)]
        for prog in self.programs():
            if prog.pools is not pools:
                raise ValueError("programs of one aggregate share one pool")
        self.ncols = max(pools.columns, default=-1) + 1

    def programs(self) -> List[Program]:
        return self._pass_programs(self.lanes)

    def _pass_programs(self, lanes) -> List[Program]:
        """The programs of a descriptor that folds `lanes`."""
        out = [self.pred] if self.pred is not None else []
        out += [p for p, _o, _s in self.keys]
        out += [p for p, _k in lanes if p is not None]
        return out

    @property
    def distinct_lanes(self) -> List[int]:
        return [i for i, (_p, k) in enumerate(self.lanes)
                if k in _DISTINCT_LANES]

    def distinct_set(self, rows: int,
                     device: torch.device) -> Optional["DistinctSet"]:
        """A set for the distinct lanes' pairs over `rows` admitted rows
        (or pairs), or None when there is no distinct lane."""
        n = len(self.distinct_lanes)
        return DistinctSet(n * int(rows), device) if n else None

    def check_distinct_set(self, rows: int) -> None:
        """Raise LoweringError when the distinct set for `rows` rows would
        hold more than MAX_DISTINCT_ENTRIES entries."""
        cap = _next_pow2(2 * max(len(self.distinct_lanes) * int(rows), 1))
        if self.distinct_lanes and cap > MAX_DISTINCT_ENTRIES:
            raise LoweringError(f"distinct set of {cap} entries")

    @property
    def full(self) -> bool:
        """Whether the kernels must launch their interpreter's full variant:
        a program uses an opcode from FULL_OPS_FROM on."""
        return any(op >= FULL_OPS_FROM for p in self.programs()
                   for op, _a, _b in p.code)

    def _chain_section(self, index: Dict[int, int]) -> np.ndarray:
        """The join-chain section of the descriptor (`device/join_chain.py`);
        empty for a plain aggregate."""
        return np.zeros(0, np.int64)

    def _layout(self, slots: int, lane0: int = 0,
                lanes: Optional[Sequence] = None) -> np.ndarray:
        """The descriptor of the pass that folds `lanes` (all of them by
        default) from lane row `lane0` on."""
        lanes = self.lanes if lanes is None else lanes
        progs = self._pass_programs(lanes)
        index = {id(p): i for i, p in enumerate(progs)}
        head = {H_NCOLS: self.ncols, H_NLANES: len(lanes), H_G: slots,
                H_NKEYS: len(self.keys), H_LANE0: lane0,
                H_PRED: 0 if self.pred is not None else -1}
        return _descriptor(head, [
            np.zeros(3 * self.ncols, np.int64),                  # columns
            *_program_sections(progs, self.pools),
            np.asarray([(index[id(p)], o, s) for p, o, s in self.keys],
                       np.int64),                                # keys
            np.asarray([(-1 if p is None else index[id(p)], k)
                        for p, k in lanes], np.int64),           # lanes
            self._chain_section(index)])

    def _pass_layouts(self, slots: int) -> List[np.ndarray]:
        """One descriptor a pass (`metas`)."""
        return [self._layout(slots, at, lanes) for at, lanes in self.passes]

    def identity(self) -> np.ndarray:
        """Each lane's identity: 0 for counts and sums, the extreme of the
        lane's type for min and max."""
        return np.asarray([_IDENTITY.get(k, 0) for _p, k in self.lanes],
                          np.int64)

    def _table(self, head: Sequence[int], device: torch.device
               ) -> torch.Tensor:
        """A table of `table_shape`: the rows `head`, then each lane at its
        identity."""
        ident = torch.from_numpy(
            np.concatenate([np.asarray(head, np.int64), self.identity()]))
        table = torch.empty(self.table_shape, dtype=torch.int64,
                            device=device)
        table.copy_(ident.to(device)[:, None].expand_as(table))
        return table

    def lane_arrays(self, host_table: np.ndarray,
                    first: int = 1) -> List[np.ndarray]:
        """Per lane, the host values (lanes from row `first` on: 1 in a
        dense table, 2 in the hash layout) as int64, float64 or float32."""
        out = []
        for i, (_p, k) in enumerate(self.lanes):
            row = host_table[first + i]
            if k == LANE_SUM_F32:
                out.append(np.ascontiguousarray(row).view(np.float32)[0::2])
            else:
                out.append(row.view(np.float64) if k in _FLOAT_LANES else row)
        return out

    def column_dtype(self, idx: int) -> torch.dtype:
        return _NP_TO_TORCH[self.pools.columns[idx]]

    def device_meta(self, cols: Columns, device: torch.device,
                    meta: Optional[np.ndarray] = None,
                    dset: Optional["DistinctSet"] = None) -> torch.Tensor:
        """The descriptor (`self.meta`, or `meta` of the same layout) with
        the batch's column pointers and the distinct set, on `device`."""
        return torch.from_numpy(self.host_meta(cols, meta, dset)).to(device)

    def host_meta(self, cols: Columns, meta: Optional[np.ndarray] = None,
                  dset: Optional["DistinctSet"] = None) -> np.ndarray:
        """`device_meta`'s words, on the host."""
        meta = (self.meta if meta is None else meta).copy()
        if dset is not None:
            meta[H_DSET] = dset.words.data_ptr()
            meta[H_DMASK] = dset.cap - 1
        base = int(meta[H_OFF_COLS])
        for idx, (data, valid) in cols.items():
            if idx in self.pools.columns:
                meta[base + 3 * idx] = data.data_ptr()
                meta[base + 3 * idx + 1] = 0 if valid is None else valid.data_ptr()
                meta[base + 3 * idx + 2] = _DTYPE_CODE[data.dtype]
        self._patch_columns(meta)
        return meta

    def _patch_columns(self, meta: np.ndarray) -> None:
        """Column descriptors that read elsewhere than the given columns
        (a join chain's folded records); none for a plain aggregate."""


class AggregateSpec(_ProgramSpec):
    """A dense aggregate: G = 2^key bits <= 64 slots, each slot its own
    packed key."""

    def __init__(self, pools, pred, keys, lanes):
        super().__init__(pools, pred, keys, lanes)
        self.groups = 1 << self.key_bits
        if self.groups > MAX_GROUPS:
            raise LoweringError(f"{self.groups} slots > {MAX_GROUPS}")
        self.metas = self._pass_layouts(self.groups)
        self.meta = self.metas[0]
        for meta, (_at, lanes) in zip(self.metas, self.passes):
            if (len(meta) + (len(lanes) + 1) * self.groups) * 8 > SMEM_BYTES:
                raise LoweringError("aggregate program too large for the "
                                    "kernel")

    @property
    def table_shape(self) -> Tuple[int, int]:
        return len(self.lanes) + 1, self.groups

    @property
    def table_words(self) -> int:
        return (len(self.lanes) + 1) * self.groups

    def new_table(self, device: torch.device) -> torch.Tensor:
        """[lanes + 1, G]: counts 0, lanes their identity."""
        return self._table([0], device)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class HashSpec(_ProgramSpec):
    """A hash aggregate over a key space above 64 slots.

    The table has `cap` slots, a power of two at least twice the number
    of groups there can be: min(key space, `rows`), `rows` being the
    total input rows. When the key space itself fits in `cap`, the packed
    key is the slot (`identity_slots`: no probe, no CAS) and `cap` is the
    key space; otherwise the kernel probes a hashed table."""

    def __init__(self, pools, pred, keys, lanes, rows: int):
        super().__init__(pools, pred, keys, lanes)
        key_space = 1 << self.key_bits
        cap = _next_pow2(2 * min(key_space, max(int(rows), 1)))
        self.identity_slots = key_space <= cap
        self.cap = key_space if self.identity_slots else cap
        self.metas = self._pass_layouts(self.cap)
        self.meta = self.metas[0]
        if max(len(m) for m in self.metas) * 8 > SMEM_BYTES:
            raise LoweringError("aggregate program too large for the kernel")

    @property
    def table_shape(self) -> Tuple[int, int]:
        return len(self.lanes) + 2, self.cap

    def new_table(self, device: torch.device) -> torch.Tensor:
        """[lanes + 2, cap]: keys EMPTY, counts 0, lanes their identity."""
        return self._table([EMPTY, 0], device)


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


class DistinctSet:
    """The pairs (group word, value) that count(DISTINCT x) lanes have
    seen: `cap` entries (a power of two, at least twice the pairs there can
    be) of three int64 words, (tag, group word, value), then one overflow
    word, in `words` on the table's device. A tag is 0 while its entry is
    free. The group word is `slot << 12 | lane`. The kernels insert with
    `distinct_insert` (csrc/program.cuh); the plain version places the new
    pairs at the lowest free entries. Free it with the query."""

    def __init__(self, pairs: int, device: torch.device):
        self.cap = _next_pow2(2 * max(int(pairs), 1))
        self.words = torch.zeros(3 * self.cap + 1, dtype=torch.int64,
                                 device=device)

    @property
    def nbytes(self) -> int:
        return self.words.numel() * 8

    def overflowed(self) -> bool:
        """Whether a pair found no entry (one synchronisation)."""
        return bool(int(self.words[-1].item()))

    def pairs(self) -> torch.Tensor:
        """Every pair in the set, as a sorted int64 [m, 2]."""
        e = self.words[:-1].view(-1, 3)
        live = e[e[:, 0] != 0][:, 1:]
        return torch.unique(live, dim=0) if live.numel() else live

    def insert_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The plain version of the insert: the pairs (a[i], b[i]) that are
        new to the set, each at its first occurrence (a bool mask), added."""
        n = a.numel()
        fresh = torch.zeros(n, dtype=torch.bool, device=a.device)
        if n == 0:
            return fresh
        uniq, inv = torch.unique(torch.stack([a, b], 1), dim=0,
                                 return_inverse=True)
        e = self.words[:-1].view(-1, 3)
        used = e[:, 0] != 0
        old = e[used][:, 1:]
        _u, inv2, cnt = torch.unique(torch.cat([old, uniq]), dim=0,
                                     return_inverse=True, return_counts=True)
        new = (cnt[inv2[old.shape[0]:]] == 1).nonzero().squeeze(1)
        free = (~used).nonzero().squeeze(1)
        if free.numel() < new.numel():
            self.words[-1] = 1
            new = new[:free.numel()]
        place = free[:new.numel()]
        na, nb = uniq[new, 0], uniq[new, 1]
        e[place, 0] = splitmix64(na ^ splitmix64(nb)) | 3
        e[place, 1], e[place, 2] = na, nb
        first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                           device=a.device)
        first.scatter_reduce_(0, inv, torch.arange(n, device=a.device),
                              "amin")
        fresh[first[new]] = True
        return fresh


def _check_dset(spec: _ProgramSpec, dset: Optional[DistinctSet],
                device: torch.device) -> None:
    if spec.distinct_lanes and (dset is None or dset.words.device != device):
        raise ValueError("distinct lanes need a DistinctSet on the table's "
                         "device")


def _check(spec: _ProgramSpec, cols: Columns, aux: torch.Tensor,
           n_rows: int, table: torch.Tensor) -> None:
    dev = table.device
    if table.dtype != torch.int64 or not table.is_contiguous() or \
            tuple(table.shape) != spec.table_shape:
        raise ValueError(f"table must be a contiguous int64 "
                         f"{list(spec.table_shape)}")
    if aux.device != dev or aux.dtype != torch.int64 or \
            not aux.is_contiguous():
        raise ValueError("aux must be a contiguous int64 tensor on the "
                         "table's device")
    for idx in spec.pools.columns:
        if idx not in cols:
            raise ValueError(f"column {idx} is read but not given")
        data, valid = cols[idx]
        if data.device != dev or not data.is_contiguous() or data.dim() != 1:
            raise ValueError(f"column {idx}: contiguous 1-D on {dev} expected")
        if data.dtype != spec.column_dtype(idx):
            raise ValueError(f"column {idx}: {data.dtype}, program expects "
                             f"{spec.column_dtype(idx)}")
        if data.shape[0] < n_rows:
            raise ValueError(f"column {idx} shorter than {n_rows} rows")
        if valid is not None and (valid.device != dev or
                                  valid.dtype != torch.bool or
                                  not valid.is_contiguous() or
                                  valid.shape[0] < n_rows):
            raise ValueError(f"column {idx}: bad validity")


def _cuda(table: torch.Tensor) -> bool:
    """False for a CPU table (run the plain version), True for CUDA."""
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    return True


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dense_group_aggregate(spec: AggregateSpec, cols: Columns,
                          aux: torch.Tensor, n_rows: int,
                          table: torch.Tensor,
                          dset: Optional[DistinctSet] = None) -> torch.Tensor:
    """Fold the first `n_rows` rows of `cols` into `table` in place; the
    distinct lanes' pairs go to `dset`.

    On CPU tensors this runs `dense_group_aggregate_plain`; on CUDA
    tensors it launches the `fused_dense_aggregate` kernel once a pass of
    lanes, or raises."""
    _check(spec, cols, aux, n_rows, table)
    _check_dset(spec, dset, table.device)
    if not _cuda(table):
        return dense_group_aggregate_plain(spec, cols, aux, n_rows, table,
                                           dset=dset)
    if n_rows == 0:
        return table
    lib = kernels.library()
    with torch.cuda.device(table.device):
        for meta, (_at, lanes) in zip(spec.metas, spec.passes):
            meta_d = spec.device_meta(cols, table.device, meta, dset)
            rc = lib.dft_fused_dense_aggregate(
                meta_d.data_ptr(), len(meta), len(lanes), spec.groups,
                aux.data_ptr(), n_rows, table.data_ptr(), int(spec.full),
                _stream(table.device))
            kernels.check(rc, fused_dense_aggregate)
            fused_dense_aggregate.launches += 1
    return table


def _rows_and_keys(spec: _ProgramSpec, cols: Columns, aux: torch.Tensor,
                   n: int, rows: Optional[torch.Tensor] = None):
    """The plain versions' prologue: (rows that pass the predicate, among
    `rows` when it is given, and the packed key of every row)."""
    dev = aux.device
    row_valid = torch.ones(n, dtype=torch.bool, device=dev) if rows is None \
        else rows.clone()
    if spec.pred is not None:
        d, v = evaluate(spec.pred, cols, aux, n)
        row_valid &= (d != 0) & v
    packed = torch.zeros(n, dtype=torch.int64, device=dev)
    for prog, offset, shift in spec.keys:
        d, v = evaluate(prog, cols, aux, n)
        packed |= torch.where(v, d - offset + 1, 0) << shift
    return row_valid, packed


def _fold_plain(spec: _ProgramSpec, cols: Columns, aux: torch.Tensor, n: int,
                row_valid: torch.Tensor, slot: torch.Tensor,
                counts: torch.Tensor, lane_rows: torch.Tensor,
                dset: Optional[DistinctSet] = None) -> None:
    """Fold the rows `row_valid` selects into `slot` of the count row and
    the lane rows, under the rules of `prepare`; a distinct lane counts
    the rows whose pair is new to `dset`."""
    ones = torch.ones_like(slot)
    counts.index_add_(0, slot, ones)
    for i, (prog, kind) in enumerate(spec.lanes):
        row = lane_rows[i]
        if prog is None:
            row.index_add_(0, slot, ones)
            continue
        d, v = evaluate(prog, cols, aux, n)
        d, v = d[row_valid], v[row_valid]
        if kind == LANE_CNT:
            row.index_add_(0, slot, v.to(torch.int64))
        elif kind == LANE_SUM_I64:
            row.index_add_(0, slot, torch.where(v, d, 0))
        elif kind == LANE_SUM_F64:
            row.view(torch.float64).index_add_(0, slot, torch.where(v, d, 0.0))
        elif kind == LANE_SUM_F32:
            low = row.view(torch.float32)[0::2]     # little-endian low words
            low.index_add_(0, slot, torch.where(v, d, 0.0).to(torch.float32))
        elif kind == LANE_NANCNT:
            row.index_add_(0, slot, (v & d.isnan()).to(torch.int64))
        elif kind in _DISTINCT_LANES:
            if kind == LANE_DISTINCT_F64:    # -0.0 is 0.0
                d = torch.where(d == 0, 0.0, d.to(torch.float64)) \
                    .view(torch.int64)
            s = slot[v]
            fresh = dset.insert_plain((s << 12) | i, d[v].to(torch.int64))
            row.index_add_(0, s[fresh], torch.ones_like(s[fresh]))
        elif kind in (LANE_MIN_I64, LANE_MAX_I64):
            red = "amin" if kind == LANE_MIN_I64 else "amax"
            ident = _IDENTITY[kind]
            row.scatter_reduce_(0, slot, torch.where(v, d, ident), red)
        elif kind in (LANE_MIN_F64, LANE_MAX_F64):
            red = "amin" if kind == LANE_MIN_F64 else "amax"
            ident = np.inf if kind == LANE_MIN_F64 else -np.inf
            avail = v & ~d.isnan()
            row.view(torch.float64).scatter_reduce_(
                0, slot, torch.where(avail, d, ident), red)
        else:
            raise ValueError(f"bad lane kind {kind}")


def dense_group_aggregate_plain(spec: AggregateSpec, cols: Columns,
                                aux: torch.Tensor, n_rows: int,
                                table: torch.Tensor,
                                rows: Optional[torch.Tensor] = None,
                                dset: Optional[DistinctSet] = None
                                ) -> torch.Tensor:
    """The plain PyTorch version: the programs interpreted over whole
    tensors, then `index_add_` / `scatter_reduce_` into the slots. Only
    the rows that `rows` selects count, when it is given."""
    if n_rows == 0:
        return table
    row_valid, packed = _rows_and_keys(spec, cols, aux, n_rows, rows)
    slot = packed.clamp(0, spec.groups - 1)[row_valid]
    _fold_plain(spec, cols, aux, n_rows, row_valid, slot, table[0], table[1:],
                dset)
    return table


def dense_group_table(table: torch.Tensor) -> torch.Tensor:
    """A dense `[lanes + 1, G]` table in the hash layout `[lanes + 2, G]`:
    row 0 the packed key (the slot) of each group, EMPTY elsewhere."""
    slots = torch.arange(table.shape[1], dtype=torch.int64,
                         device=table.device)
    keys = torch.where(table[0] > 0, slots, EMPTY)
    return torch.cat([keys[None], table])


def _check_overflow(overflow: torch.Tensor, device: torch.device) -> None:
    if overflow.device != device or overflow.dtype != torch.int32 or \
            overflow.numel() != 1:
        raise ValueError("overflow must be one int32 on the table's device")


def hash_group_aggregate(spec: HashSpec, cols: Columns, aux: torch.Tensor,
                         n_rows: int, table: torch.Tensor,
                         overflow: torch.Tensor,
                         dset: Optional[DistinctSet] = None) -> torch.Tensor:
    """Fold the first `n_rows` rows of `cols` into the hash `table` in
    place; `overflow` (one int32) is set to 1 if a row found no slot; the
    distinct lanes' pairs go to `dset`.

    On CPU tensors this runs `hash_group_aggregate_plain`; on CUDA tensors
    it launches the `hash_group_aggregate` kernel once a pass of lanes, or
    raises."""
    _check(spec, cols, aux, n_rows, table)
    _check_overflow(overflow, table.device)
    _check_dset(spec, dset, table.device)
    if not _cuda(table):
        return hash_group_aggregate_plain(spec, cols, aux, n_rows, table,
                                          overflow, dset=dset)
    if n_rows == 0:
        return table
    lib = kernels.library()
    with torch.cuda.device(table.device):
        for meta, (_at, lanes) in zip(spec.metas, spec.passes):
            meta_d = spec.device_meta(cols, table.device, meta, dset)
            # a pass with a distinct lane folds without the block cache
            cache = not any(k in _DISTINCT_LANES for _p, k in lanes)
            rc = lib.dft_hash_group_aggregate(
                meta_d.data_ptr(), len(meta), len(lanes), int(cache),
                aux.data_ptr(), n_rows, spec.cap, int(spec.identity_slots),
                table.data_ptr(), overflow.data_ptr(), int(spec.full),
                _stream(table.device))
            kernels.check(rc, hash_group_aggregate_kernel)
            hash_group_aggregate_kernel.launches += 1
    return table


def _plain_slots(spec: HashSpec, table: torch.Tensor, packed: torch.Tensor,
                 overflow: torch.Tensor) -> torch.Tensor:
    """The slot of each packed key, claiming free slots for new keys (in
    key order, at the lowest free slots); -1 and the overflow flag where
    none is left."""
    keys = table[0]
    if spec.identity_slots:
        bad = (packed < 0) | (packed >= spec.cap)
        slot = torch.where(bad, -1, packed)
        keys[slot[~bad]] = packed[~bad]
    else:
        uk, inv = torch.unique(packed, return_inverse=True)
        live = (keys != EMPTY).nonzero().squeeze(1)
        lkeys, order = keys[live].sort()
        uslot = torch.full_like(uk, -1)
        if lkeys.numel():
            pos = torch.searchsorted(lkeys, uk).clamp(max=lkeys.numel() - 1)
            hit = lkeys[pos] == uk
            uslot[hit] = live[order[pos[hit]]]
        new = (uslot < 0).nonzero().squeeze(1)
        free = (keys == EMPTY).nonzero().squeeze(1)[:new.numel()]
        uslot[new[:free.numel()]] = free
        keys[free] = uk[new[:free.numel()]]
        slot = uslot[inv]
        bad = slot < 0
    if bool(bad.any()):
        overflow.fill_(1)
    return slot


def hash_group_aggregate_plain(spec: HashSpec, cols: Columns,
                               aux: torch.Tensor, n_rows: int,
                               table: torch.Tensor,
                               overflow: torch.Tensor,
                               rows: Optional[torch.Tensor] = None,
                               dset: Optional[DistinctSet] = None
                               ) -> torch.Tensor:
    """The plain PyTorch version: the programs interpreted over whole
    tensors, the keys interned with `torch.unique` against the keys
    already in the table, then `index_add_` / `scatter_reduce_`. Only the
    rows that `rows` selects count, when it is given."""
    if n_rows == 0:
        return table
    row_valid, packed = _rows_and_keys(spec, cols, aux, n_rows, rows)
    slot = torch.full_like(packed, -1)
    slot[row_valid] = _plain_slots(spec, table, packed[row_valid], overflow)
    row_valid &= slot >= 0
    _fold_plain(spec, cols, aux, n_rows, row_valid, slot[row_valid],
                table[1], table[2:], dset)
    return table


# finaliser kinds (mirrored in csrc/compact_groups.cu)
FIN_KEY, FIN_COUNT, FIN_SUM, FIN_AVG, FIN_MIN, FIN_MAX = range(6)
FIN_WORDS = 6


class Finaliser:
    """One output column of an aggregate read from its group table, as
    `_apply_post_filter` (`device_aggregate.py:1301-1352`) reads it:
    - FIN_KEY (shift, bits, offset, is_bool, is_float): `((k >> shift) &
      mask) - 1 + offset` (bool: != 0; float: as float64, a date_part
      key), valid when that field is not 0;
    - FIN_COUNT (count row);
    - FIN_SUM / FIN_AVG (sum row, count row, sum lane kind): valid when the
      count is above 0; avg is `s / c` in float64;
    - FIN_MIN / FIN_MAX (value row, count row, lane kind, nancnt row or
      -1): NaN restored, for min where every value was NaN, for max where
      any was."""

    def __init__(self, kind: int, *words: int):
        self.kind = kind
        self.words = tuple(int(w) for w in words)

    def descriptor(self) -> List[int]:
        return [self.kind, *self.words,
                *[0] * (FIN_WORDS - 1 - len(self.words))]


def _sum_value(row: torch.Tensor, kind: int) -> torch.Tensor:
    if kind == LANE_SUM_F64:
        return row.view(torch.float64)
    if kind == LANE_SUM_F32:          # the low word (little-endian)
        return row.contiguous().view(torch.float32)[0::2].to(torch.float64)
    return row


def finalise(table: torch.Tensor, fins: Dict[int, Finaliser]):
    """The plain PyTorch version of the finalisers: output column index ->
    (data, valid) over every slot of `table`, as `evaluate` reads them."""
    out = {}
    for idx, f in fins.items():
        w = f.words
        if f.kind == FIN_KEY:
            shift, bits, offset, is_bool, is_float = (*w, 0)[:5]
            raw = (table[0] >> shift) & ((1 << bits) - 1)
            code = raw - 1 + offset
            if is_bool:
                code = (code != 0).to(torch.int64)
            elif is_float:
                code = code.to(torch.float64)
            out[idx] = (code, raw != 0)
        elif f.kind == FIN_COUNT:
            out[idx] = (table[w[0]], torch.ones_like(table[w[0]],
                                                     dtype=torch.bool))
        else:
            cnt = table[w[1]]
            has = cnt > 0
            if f.kind == FIN_SUM:
                out[idx] = (_sum_value(table[w[0]], w[2]), has)
            elif f.kind == FIN_AVG:
                s = _sum_value(table[w[0]], w[2]).to(torch.float64)
                out[idx] = (s / torch.where(has, cnt, 1), has)
            else:
                x = table[w[0]]
                if w[2] in (LANE_MIN_F64, LANE_MAX_F64):
                    x = x.view(torch.float64)
                if w[3] >= 0:
                    nn = table[w[3]]
                    nan = has & ((nn == cnt) if f.kind == FIN_MIN
                                 else (nn > 0))
                    x = torch.where(nan, torch.nan, x)
                out[idx] = (x, has)
    return out


class HavingSpec:
    """A HAVING program over an aggregate's output columns, each read from
    the group table through a `Finaliser`, laid out as the descriptor of
    `csrc/compact_groups.cu`."""

    def __init__(self, prog: Program, fins: Dict[int, Finaliser]):
        self.prog = prog
        self.fins = fins
        ncols = max(fins, default=-1) + 1
        words = np.zeros((ncols, FIN_WORDS), np.int64)
        for idx, f in fins.items():
            words[idx] = f.descriptor()
        self.meta = _descriptor({H_NCOLS: ncols, H_PRED: 0}, [
            words, *_program_sections([prog], prog.pools)])
        if len(self.meta) * 8 > SMEM_BYTES:
            raise LoweringError("HAVING program too large for the kernel")

    def mask(self, table: torch.Tensor) -> torch.Tensor:
        """The plain version: the program over every slot of `table`."""
        n = table.shape[1]
        empty = torch.zeros(0, dtype=torch.int64, device=table.device)
        d, v = evaluate(self.prog, finalise(table, self.fins), empty, n)
        return (d != 0) & v


_NO_HAVING = _descriptor({H_PRED: -1}, [])


def _check_group_table(table: torch.Tensor) -> None:
    if table.dtype != torch.int64 or not table.is_contiguous() or \
            table.dim() != 2 or table.shape[0] < 2:
        raise ValueError("group table must be a contiguous int64 "
                         "[lanes + 2, cap]")


def _check_slots(slots: Optional[torch.Tensor], table: torch.Tensor) -> None:
    if slots is not None and (slots.device != table.device or
                              slots.dtype != torch.int64 or
                              slots.dim() != 1 or not slots.is_contiguous()):
        raise ValueError("slots must be a contiguous int64 [k] on the "
                         "table's device")


def compact_groups(table: torch.Tensor, having: Optional[HavingSpec] = None,
                   slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The occupied slots of `table` (`[lanes + 2, cap]`, row 0 keys) that
    pass `having`, in slot order, or, with `slots`, the occupied ones among
    those slots in their order: a `[lanes + 2, ng]` tensor.

    On CPU tensors this runs `compact_groups_plain`; on CUDA tensors it
    launches the `compact_groups` kernels (the mark pass, then the copy
    unless ng is 0) or raises. It reads ng back to size the output: one
    synchronisation. Its scratch is a keep bit an entry and a status word
    a tile."""
    _check_group_table(table)
    _check_slots(slots, table)
    if not _cuda(table):
        return compact_groups_plain(table, having, slots)
    lib = kernels.library()
    dev = table.device
    rows, cap = table.shape
    n = cap if slots is None else slots.numel()
    nt = max(-(-n // COMPACT_TILE), 1)
    meta = _NO_HAVING if having is None else having.meta
    slots_ptr = None if slots is None else slots.data_ptr()
    with torch.cuda.device(dev):
        meta_d = torch.from_numpy(meta).to(dev)
        # the tiles' status words, the tile counter, ng
        state = torch.zeros(nt + 2, dtype=torch.int64, device=dev)
        words = torch.empty(nt * COMPACT_WORDS, dtype=torch.int32,
                            device=dev)
        stream = _stream(dev)
        kernels.check(lib.dft_compact_mark(
            meta_d.data_ptr(), len(meta), int(having is not None),
            table.data_ptr(), cap, slots_ptr, n, words.data_ptr(),
            state.data_ptr(), stream), compact_groups_kernel)
        compact_groups_kernel.launches += 1
        ng = int(state[nt + 1].item())
        out = torch.empty((rows, ng), dtype=torch.int64, device=dev)
        if ng:
            kernels.check(lib.dft_compact_copy(
                table.data_ptr(), cap, rows, slots_ptr, n, words.data_ptr(),
                state.data_ptr(), out.data_ptr(), ng, stream),
                compact_groups_kernel)
            compact_groups_kernel.launches += 1
    return out


def compact_groups_plain(table: torch.Tensor,
                         having: Optional[HavingSpec] = None,
                         slots: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The plain PyTorch version: a keep mask, `nonzero` and a gather."""
    keep = table[0] != EMPTY
    if having is not None:
        keep &= having.mask(table)
    if slots is None:
        return table[:, keep.nonzero().squeeze(1)]
    picked = slots[slots >= 0]
    return table[:, picked[keep[picked]]]


def group_topk(table: torch.Tensor, lane_row: int, asc: bool,
               k: int) -> torch.Tensor:
    """The slots of the k best occupied groups of `table` by its int64 row
    `lane_row`, ascending or descending: an int64 `[k]` list, -1 past the
    number of groups. Which of the groups tied at the k-th value are kept
    is unspecified.

    On CPU tensors this runs `group_topk_plain`; on CUDA tensors it
    launches the `group_topk` kernels (TOPK_LAUNCHES of them: the
    compaction, the select's rounds and the gather) or raises. Its
    scratch is a candidate list of `topk_candidates(cap, k)` entries, 12
    bytes each; with more live groups the rounds read the table."""
    _check_group_table(table)
    if not 0 < k <= MAX_TOPK:
        raise ValueError(f"k = {k} outside 1..{MAX_TOPK}")
    if not 1 <= lane_row < table.shape[0]:
        raise ValueError(f"lane row {lane_row} outside the table")
    if not _cuda(table):
        return group_topk_plain(table, lane_row, asc, k)
    cap = table.shape[1]
    if cap > TOPK_MAX_SLOTS:
        raise ValueError(f"group_topk takes at most {TOPK_MAX_SLOTS} slots "
                         f"(32-bit candidate slots), not {cap}")
    lib = kernels.library()
    dev = table.device
    ncand = topk_candidates(cap, k)
    with torch.cuda.device(dev):
        # zeros (no copy from the host): the kernels' state words, then
        # the rounds' histogram
        scratch = torch.zeros(8 + 256, dtype=torch.int64, device=dev)
        state, hist = scratch[:8], scratch[8:]
        cand_u = torch.empty(ncand, dtype=torch.int64, device=dev)
        cand_s = torch.empty(ncand, dtype=torch.int32, device=dev)
        out = torch.empty(k, dtype=torch.int64, device=dev)
        rc = lib.dft_group_topk(table.data_ptr(), cap, lane_row, int(asc), k,
                                state.data_ptr(), hist.data_ptr(), ncand,
                                cand_u.data_ptr(), cand_s.data_ptr(),
                                out.data_ptr(), _stream(dev))
    kernels.check(rc, group_topk_kernel)
    group_topk_kernel.launches += TOPK_LAUNCHES
    return out


def topk_candidates(cap: int, k: int) -> int:
    """The entries of `group_topk`'s candidate list for a table of `cap`
    slots: TOPK_CANDIDATES, but never more than the slots nor fewer than
    min(cap, k), so that k or fewer live groups are always listed."""
    return min(cap, max(TOPK_CANDIDATES, k))


def group_topk_plain(table: torch.Tensor, lane_row: int, asc: bool,
                     k: int) -> torch.Tensor:
    """The plain PyTorch version: `torch.topk` over the occupied slots
    (ascending through the bitwise complement, which reverses int64 order
    without overflow)."""
    live = (table[0] != EMPTY).nonzero().squeeze(1)
    w = table[lane_row][live]
    kk = min(k, live.numel())
    _vals, idx = torch.topk(~w if asc else w, kk)
    out = torch.full((k,), -1, dtype=torch.int64, device=table.device)
    out[:kk] = live[idx]
    return out


# resident emit field kinds (mirrored in csrc/group_emit.cu)
EMIT_KEY, EMIT_DICT, EMIT_COUNT, EMIT_SUM = range(4)
MAX_EMIT_FIELDS = 64


class EmitField:
    """One output column of the resident emit, read from a compacted
    group table `[rows, ng]`:
    - EMIT_KEY (shift, bits, offset): `raw = (k >> shift) & mask`, the
      value `raw - 1 + offset` at `dtype`, valid where raw != 0;
    - EMIT_DICT (shift, bits): the dictionary code `max(raw - 1, 0)`
      (int32), valid where raw != 0;
    - EMIT_COUNT (row): the count lane at `row`, int64, no validity;
    - EMIT_SUM (row, count row): the sum lane at `row`, valid where the
      count lane at `count_row` is above 0."""

    def __init__(self, kind: int, dtype: torch.dtype, row: int = 0,
                 shift: int = 0, bits: int = 0, offset: int = 0,
                 count_row: int = 0):
        if dtype not in (torch.int32, torch.int64):
            raise LoweringError(f"resident emit of {dtype}")
        if kind == EMIT_DICT and dtype != torch.int32:
            raise ValueError("dictionary codes are int32")
        self.kind, self.dtype, self.row = kind, dtype, int(row)
        self.shift, self.bits, self.offset = int(shift), int(bits), int(offset)
        self.count_row = int(count_row)

    @property
    def has_validity(self) -> bool:
        return self.kind != EMIT_COUNT

    def words(self, data: torch.Tensor,
              valid: Optional[torch.Tensor]) -> List[int]:
        """The kernel's 8 descriptor words of this field."""
        aux = self.count_row if self.kind == EMIT_SUM else self.shift
        return [self.kind, self.row, aux, self.bits, self.offset,
                _DTYPE_CODE[self.dtype], data.data_ptr(),
                0 if valid is None else valid.data_ptr()]


def group_emit_columns(groups: torch.Tensor, fields: Sequence[EmitField]
                       ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """(data, validity or None) of every field over the `ng` groups of a
    compacted table `groups` (`[rows, ng]`, `compact_groups`' output), on
    its device.

    On CPU tensors this runs `group_emit_columns_plain`; on CUDA tensors it
    launches the `group_emit` kernel or raises."""
    _check_group_table(groups)
    if len(fields) > MAX_EMIT_FIELDS:
        raise ValueError(f"{len(fields)} fields > {MAX_EMIT_FIELDS}")
    for f in fields:
        if not 0 <= f.row < groups.shape[0] or \
                not 0 <= f.count_row < groups.shape[0]:
            raise ValueError("an emit field reads outside the table")
    if not _cuda(groups):
        return group_emit_columns_plain(groups, fields)
    dev, ng = groups.device, groups.shape[1]
    outs = [(torch.empty(ng, dtype=f.dtype, device=dev),
             torch.empty(ng, dtype=torch.bool, device=dev)
             if f.has_validity else None) for f in fields]
    if ng == 0 or not fields:
        return outs
    lib = kernels.library()
    with torch.cuda.device(dev):
        words = torch.tensor([w for f, (d, v) in zip(fields, outs)
                              for w in f.words(d, v)],
                             dtype=torch.int64).to(dev)
        kernels.check(lib.dft_group_emit(groups.data_ptr(), ng, len(fields),
                                         words.data_ptr(), _stream(dev)),
                      group_emit_kernel)
    group_emit_kernel.launches += 1
    return outs


def group_emit_columns_plain(groups: torch.Tensor,
                             fields: Sequence[EmitField]
                             ) -> List[Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]]:
    """The plain PyTorch version: shifts, masks and casts over whole rows."""
    outs = []
    for f in fields:
        word = groups[f.row]
        if f.kind in (EMIT_KEY, EMIT_DICT):
            # shift + bits <= 62, so the sign bits are masked away
            raw = (word >> f.shift) & ((1 << f.bits) - 1)
            data = (raw - 1).clamp(min=0) if f.kind == EMIT_DICT \
                else raw - 1 + f.offset
            outs.append((data.to(f.dtype), raw != 0))
        elif f.kind == EMIT_SUM:
            outs.append((word.to(f.dtype), groups[f.count_row] > 0))
        else:
            outs.append((word.to(f.dtype), None))
    return outs


class GatherGroup(NamedTuple):
    """Lanes that `gather_lanes.cu` moves as one record: `lanes` (indices
    into the caller's list, widest first), their byte `offsets` in the
    record, the row's bytes `w`, the record's padded `width`, and whether
    the group is `packed` (pack, then gather records: two launches) or
    moved lane by lane (`direct`: one launch)."""
    lanes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    w: int
    width: int
    packed: bool

    @property
    def launches(self) -> int:
        return 2 if self.packed else 1


def record_width(w: int) -> int:
    """A record of w bytes padded to a power of two up to GATHER_SECTOR
    bytes, past that to a multiple of GATHER_SECTOR, so that a record of
    at most a sector never straddles two."""
    if w <= GATHER_SECTOR:
        return 1 << (w - 1).bit_length()
    return -(-w // GATHER_SECTOR) * GATHER_SECTOR


def gather_plan(widths: Sequence[int], m: int, n: int) -> List[GatherGroup]:
    """How `reorder_rows` moves lanes of `widths` bytes (n rows each) to m
    output rows: the lanes widest first (stable), cut into groups of at
    most GATHER_MAX_RECORD bytes a row. A group is packed when the random
    sectors it saves outweigh the pack's bytes: one sector a lane a row
    read directly, against the record's sectors, so packed iff
    m * 32 * (lanes - sectors) > n * (w + width)."""
    order = sorted(range(len(widths)), key=lambda i: -widths[i])
    groups, cur = [], []
    for i in order:
        if sum(widths[j] for j in cur) + widths[i] > GATHER_MAX_RECORD:
            groups.append(cur)
            cur = []
        cur.append(i)
    if cur:
        groups.append(cur)
    plan = []
    for g in groups:
        offsets = np.cumsum([0] + [widths[i] for i in g])
        w = int(offsets[-1])
        width = record_width(w)
        sectors = -(-width // GATHER_SECTOR)
        packed = m * GATHER_SECTOR * (len(g) - sectors) > n * (w + width)
        plan.append(GatherGroup(tuple(g), tuple(int(o) for o in offsets[:-1]),
                                w, width, bool(packed)))
    return plan


def reorder_rows(order: torch.Tensor,
                 lanes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every lane (a contiguous [n] tensor of 1, 2, 4 or 8 bytes a row, the
    same n for all) read through `order` (int64 [m], row indices into the
    lanes): new lanes of m rows, `lane[order]` each.

    On CPU tensors this runs `reorder_rows_plain`; on CUDA tensors it
    launches the `gather_lanes` kernels, for each group of `gather_plan`
    a pack and a gather of whole records or one direct launch, or raises.
    A packed group's scratch is n * width bytes, freed at return."""
    if order.dtype != torch.int64 or order.dim() != 1 or \
            not order.is_contiguous():
        raise ValueError("order must be a contiguous int64 [m] tensor")
    for lane in lanes:
        if lane.device != order.device or lane.dim() != 1 or \
                not lane.is_contiguous() or \
                lane.element_size() not in (1, 2, 4, 8):
            raise ValueError("lanes must be contiguous [n] tensors of 1, 2, 4 "
                             "or 8 bytes on the order's device")
    if len({lane.numel() for lane in lanes}) > 1:
        raise ValueError("lanes must be row-aligned: the same length each")
    if not _cuda(order):
        return reorder_rows_plain(order, lanes)
    m, dev = order.numel(), order.device
    outs = [torch.empty(m, dtype=lane.dtype, device=dev) for lane in lanes]
    if m == 0 or not lanes:
        return outs
    n = lanes[0].numel()
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for g in gather_plan([t.element_size() for t in lanes], m, n):
            k = len(g.lanes)
            srcs = (ctypes.c_void_p * k)(*[lanes[i].data_ptr()
                                           for i in g.lanes])
            dsts = (ctypes.c_void_p * k)(*[outs[i].data_ptr()
                                           for i in g.lanes])
            widths = (ctypes.c_int * k)(*[lanes[i].element_size()
                                          for i in g.lanes])
            offs = (ctypes.c_int * k)(*g.offsets)
            if not g.packed:
                kernels.check(lib.dft_gather_direct(
                    order.data_ptr(), m, k, srcs, dsts, widths, offs,
                    stream), gather_lanes_kernel)
                gather_lanes_kernel.launches += 1
                continue
            recs = torch.empty(-(-n * g.width // 16) * 16,
                               dtype=torch.uint8, device=dev)
            kernels.check(lib.dft_gather_pack(
                n, k, srcs, widths, offs, g.width, recs.data_ptr(), stream),
                gather_lanes_kernel)
            gather_lanes_kernel.launches += 1
            kernels.check(lib.dft_gather_records(
                order.data_ptr(), m, recs.data_ptr(), g.width, k, dsts,
                widths, offs, stream), gather_lanes_kernel)
            gather_lanes_kernel.launches += 1
            del recs
    return outs


def reorder_rows_plain(order: torch.Tensor,
                       lanes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain PyTorch version: one `index_select` a lane."""
    return [lane.index_select(0, order) for lane in lanes]
