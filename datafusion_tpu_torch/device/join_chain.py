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
`_stage_semi_member_lut` (`:1158`) with its min/max branch (`:1170-1300`).
One pass over the build rows counts
the rows that pass the build predicate with every key valid and takes each
key's min and max; the host reads those few words and lays the table out
(`table_layout`); a second pass packs each live row's keys as
`sum((v_k - lo_k) << shift_k)` and inserts its row into a direct-address
int32 table (row or -1) when the packed span is at most 16 x rows and
2^26, else into an open-addressing table of (int64 key, int32 row) of
2 x next_pow2(rows) slots. A second row for a key marks a duplicate: an
INNER build with one has fanout > 1 and the exec runs its host plan.
NULL keys are never inserted. A min/max build (a filtered SEMI or ANTI
hop, `member_col OP probe_expr`, TPC-H Q21) counts a row only when its
member value is valid too, and keeps the member's min and max over each
key's rows in two int64 arrays aligned with the table, laid out by the same
rule as every other build.

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

The row-returning walk (`chain_rows`, kernel `csrc/chain_rows.cu`).
Counterpart of `DeviceJoinChainRowsExec`'s mask program (`:2312`, jit
`:2339`) and emit program (`:2352`, jit `:2377`). The same walk, with no
fold: a first pass marks the spine rows that survive the probe
predicate, the hops and the residual, an exclusive scan gives each kept
row its output slot, the wrapper reads the count (one synchronisation a
spine batch, as `:2347`), and a second pass re-walks the kept rows and
writes every output program's value and validity at the row's slot. The
output is in spine order, as the reference's `searchsorted` compaction
gives it.

A filtered SEMI/ANTI hop keeps a row when some member row of its key
satisfies `member OP x` (`_mmx_exists`, `:1325-1347`): `<>` when the min
or the max differs from x, `<` and `<=` by the min, `>` and `>=` by the
max; a NULL x satisfies nothing, and ANTI negates the test. The
representative-row lane of a functional-dependence reduction (`:1859-1866`)
is a max lane over `OP_ROWID`, the spine row's index.

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its CUDA kernel on CUDA tensors, or raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .groupby import (_DTYPE_CODE, _NP_TO_TORCH, EMPTY, H_OFF_KEYS,
                      LANE_MIN_I64, SMEM_BYTES, AggregateSpec, Columns,
                      HashSpec, _cuda, _next_pow2, _ProgramSpec, _stream,
                      dense_group_aggregate_plain, hash_group_aggregate_plain)
from .lower import (CMP_EQ, CMP_GE, CMP_GT, CMP_LE, CMP_LT, CMP_NE,
                    LoweringError, Pools, Program, evaluate)

chain_build_kernel = kernels.register(kernels.Kernel(
    "chain_build", "datafusion_tpu_torch/csrc/chain_build.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:177"))
chain_aggregate_kernel = kernels.register(kernels.Kernel(
    "chain_aggregate", "datafusion_tpu_torch/csrc/chain_aggregate.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:1597"))
chain_rows_kernel = kernels.register(kernels.Kernel(
    "chain_rows", "datafusion_tpu_torch/csrc/chain_rows.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:2312"))

# build table kinds and hop join types (mirrored in csrc/program.cuh)
TAB_DIRECT, TAB_HASH, TAB_EMPTY = range(3)
JT_INNER, JT_SEMI, JT_ANTI = range(3)
JOIN_TYPES = {"INNER": JT_INNER, "LEFTSEMI": JT_SEMI, "LEFTANTI": JT_ANTI}

# the chain section of a descriptor: a head, a record per hop, then the
# hop of every pair-space column (-1: spine)
C_NSPINE, C_NHOPS, C_PPRED, C_OFF_HOPOF, C_HOPS = range(5)
(HOP_KIND, HOP_JTYPE, HOP_TABLE, HOP_KEYS, HOP_SIZE, HOP_NKEYS, HOP_MOP,
 HOP_MPROG, HOP_MN, HOP_MX, HOP_KEY0) = range(11)
MAX_HOPS = 8
MAX_HOP_KEYS = 4
HOP_WORDS = HOP_KEY0 + 4 * MAX_HOP_KEYS    # (prog, lo, hi, shift) per key

SCAN_TILE = 8192          # words a block of csrc/scan.cuh scans
DIRECT_FILL = 16          # a direct table spans at most 16 x its rows
DIRECT_MAX = 1 << 26      # and at most 2^26 slots (256 MB of int32)

_I64_MAX = int(np.iinfo(np.int64).max)
_I64_MIN = int(np.iinfo(np.int64).min)


# --- build staging -------------------------------------------------------------

class BuildSpec(_ProgramSpec):
    """The build predicate and key programs of one build side, over its
    batch's columns, and for a min/max build the member column's program
    (the descriptor's one lane). The kernel reads the keys from the
    descriptor's key section as (program, lo, shift); `packed_meta` fills
    lo and shift in once the range pass has run."""

    def __init__(self, pools: Pools, pred: Optional[Program],
                 keys: Sequence[Program], member: Optional[Program] = None):
        if not 1 <= len(keys) <= MAX_HOP_KEYS:
            raise LoweringError(f"{len(keys)} build keys")
        if any(k.is_float for k in keys):
            raise LoweringError("float join key")
        if member is not None and member.is_float:
            raise LoweringError("semi filter needs int member col")
        lanes = [] if member is None else [(member, LANE_MIN_I64)]
        super().__init__(pools, pred, [(k, 0, 0) for k in keys], lanes)
        self.meta = self._layout(0)

    @property
    def member(self) -> Optional[Program]:
        return self.lanes[0][0] if self.lanes else None

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
    number of `live` rows and whether a key had two rows (`duplicate`).
    A min/max build also has `mn` and `mx`, int64 and slot-aligned: the
    member column's min and max over each key's rows."""

    def __init__(self, kind: int, los, his, shifts, size: int,
                 rows: torch.Tensor, keys: Optional[torch.Tensor],
                 live: int, duplicate: bool,
                 mn: Optional[torch.Tensor] = None,
                 mx: Optional[torch.Tensor] = None):
        self.kind = kind
        self.los, self.his, self.shifts = list(los), list(his), list(shifts)
        self.size = int(size)
        self.rows = rows
        self.keys = keys
        self.live = int(live)
        self.duplicate = bool(duplicate)
        self.mn = mn
        self.mx = mx

    def tensors(self) -> List[torch.Tensor]:
        return [t for t in (self.rows, self.keys, self.mn, self.mx)
                if t is not None]

    def find(self, vals: Sequence[np.ndarray]) -> np.ndarray:
        """The build row (-1 for none) of each probe key tuple `vals` (one
        int64 array a key), looked up in the staged table: the host replay
        of a functional-dependence reduction reads a few rows this way."""
        n = len(vals[0]) if vals else 0
        if self.kind == TAB_EMPTY or n == 0:
            return np.full(n, -1, np.int64)
        ok = np.ones(n, bool)
        packed = np.zeros(n, np.int64)
        for v, lo, hi, shift in zip(vals, self.los, self.his, self.shifts):
            v = np.asarray(v, np.int64)
            inside = (v >= lo) & (v <= hi)
            ok &= inside
            packed |= np.where(inside, v - lo, 0) << shift
        p = torch.from_numpy(packed).to(self.rows.device)
        if self.kind == TAB_DIRECT:
            found = self.rows[p].to(torch.int64)
        else:
            slot, hit = _sorted_slots(self.keys, p)
            found = torch.where(hit, self.rows[slot].to(torch.int64), -1)
        return np.where(ok, found.cpu().numpy(), -1)

    def _slots(self) -> Tuple[np.ndarray, np.ndarray]:
        """(packed key, slot) of every entry, ordered by key."""
        if self.kind == TAB_HASH:
            keys = self.keys.cpu().numpy()
            slots = np.flatnonzero(keys != EMPTY)
            keys = keys[slots]
        else:
            slots = keys = np.flatnonzero(self.rows.cpu().numpy() >= 0)
        order = np.argsort(keys, kind="stable")
        return keys[order], slots[order]

    def entries(self) -> Tuple[np.ndarray, np.ndarray]:
        """(packed key, build row) of every entry, ordered by key."""
        keys, slots = self._slots()
        return keys, self.rows.cpu().numpy().astype(np.int64)[slots]

    def extremes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(min, max) of the member column at every entry of a min/max
        table, ordered by key as `entries` is."""
        _keys, slots = self._slots()
        return self.mn.cpu().numpy()[slots], self.mx.cpu().numpy()[slots]


def table_layout(live: int, los: Sequence[int], his: Sequence[int]):
    """(kind, shifts, size) of a build table for `live` rows whose keys
    span [lo_k, hi_k]: each key takes the bits of hi_k - lo_k, packed low
    key first; direct-address when the packed span is at most
    DIRECT_FILL x live and DIRECT_MAX, else hashed at 2 x next_pow2(live)
    slots; a min/max table follows the same rule. The reference stops
    direct tables at 2^24 slots (`:202`); TPC-H's o_orderkey spans 4x its
    rows, 60M at SF10."""
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
                stats.data_ptr(), int(spec.full), stream),
                chain_build_kernel)
            chain_build_kernel.launches += 1
        host = stats.cpu().tolist()
        live, los, his = host[0], host[1::2], host[2::2]
        mmx = spec.member is not None
        kind, shifts, size = table_layout(live, los, his)
        rows = torch.full((size,), -1, dtype=torch.int32, device=dev)
        keys = torch.full((size,), EMPTY, dtype=torch.int64, device=dev) \
            if kind == TAB_HASH else None
        mn = torch.full((size,), _I64_MAX, dtype=torch.int64, device=dev) \
            if mmx else None
        mx = torch.full((size,), _I64_MIN, dtype=torch.int64, device=dev) \
            if mmx else None
        duplicate = False
        if kind != TAB_EMPTY:
            dup = torch.zeros(1, dtype=torch.int32, device=dev)
            meta = spec.packed_meta(los, shifts)
            meta_d = spec.device_meta(cols, dev, meta)
            kernels.check(lib.dft_chain_build_insert(
                meta_d.data_ptr(), len(meta), aux.data_ptr(), n_rows, kind,
                size, rows.data_ptr(),
                None if keys is None else keys.data_ptr(),
                None if mn is None else mn.data_ptr(),
                None if mx is None else mx.data_ptr(), dup.data_ptr(),
                int(spec.full), stream), chain_build_kernel)
            chain_build_kernel.launches += 1
            flag = int(dup.item()) if unique else 0
            if flag == 2:
                raise RuntimeError("chain build table overflowed")
            duplicate = flag == 1
    return BuildTable(kind, los, his, shifts, size, rows, keys, live,
                      duplicate, mn, mx)


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


def _sorted_slots(keys: torch.Tensor, packed: torch.Tensor):
    """(slot of each packed key in the hashed table `keys`, whether it is
    there), by a search over the table's sorted live keys."""
    live = (keys != EMPTY).nonzero().squeeze(1)
    skeys, order = keys[live].sort()
    if not skeys.numel():
        return torch.zeros_like(packed), torch.zeros_like(packed,
                                                          dtype=torch.bool)
    pos = torch.searchsorted(skeys, packed).clamp(max=skeys.numel() - 1)
    return live[order[pos]], skeys[pos] == packed


def chain_build_plain(spec: BuildSpec, cols: Columns, aux: torch.Tensor,
                      n_rows: int, unique: bool) -> BuildTable:
    """The plain PyTorch version: the programs interpreted over whole
    tensors, the ranges by `min`/`max`, duplicates by `torch.unique`, the
    rows placed by indexing (direct) or by rounds of linear probing, a
    min/max build's member values by `scatter_reduce_`."""
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
    mmx = spec.member is not None
    if mmx:
        member, v = evaluate(spec.member, cols, aux, n)
        live &= v
    n_live = int(live.sum())
    los = [int(v[live].min()) if n_live else _I64_MAX for v in vals]
    his = [int(v[live].max()) if n_live else _I64_MIN for v in vals]
    kind, shifts, size = table_layout(n_live, los, his)
    rows = torch.full((size,), -1, dtype=torch.int32, device=dev)
    mn = torch.full((size,), _I64_MAX, dtype=torch.int64, device=dev) \
        if mmx else None
    mx = torch.full((size,), _I64_MIN, dtype=torch.int64, device=dev) \
        if mmx else None
    if kind == TAB_EMPTY:
        return BuildTable(kind, los, his, shifts, size, rows, None, 0, False,
                          mn, mx)
    packed = torch.zeros(n_live, dtype=torch.int64, device=dev)
    for v, lo, shift in zip(vals, los, shifts):
        packed |= (v[live] - lo) << shift
    row_ids = live.nonzero().squeeze(1)
    duplicate = unique and torch.unique(packed).numel() < n_live
    keys = None
    if kind == TAB_DIRECT:
        rows[packed] = row_ids.to(torch.int32)
        slot = packed
    else:
        keys, rows = _hash_insert_plain(packed, row_ids, size)
        slot = _sorted_slots(keys, packed)[0]
    if mmx:
        mn.scatter_reduce_(0, slot, member[live], "amin")
        mx.scatter_reduce_(0, slot, member[live], "amax")
    return BuildTable(kind, los, his, shifts, size, rows, keys, n_live,
                      duplicate, mn, mx)


# --- the walk ------------------------------------------------------------------

class Hop:
    """One hop of the walk: its build table, join type, probe-key programs
    (over the pair space), the pair-space indices of its payload and, for
    a filtered SEMI/ANTI over a min/max table, `mfilter`: (comparison code
    of `member OP x`, the program of x over the pair space)."""

    def __init__(self, table: BuildTable, join_type: str,
                 probe_keys: Sequence[Program], payload: Sequence[int],
                 mfilter: Optional[Tuple[int, Program]] = None):
        if join_type not in JOIN_TYPES:
            raise LoweringError(f"{join_type} join in a chain")
        if len(probe_keys) != len(table.los):
            raise ValueError("one probe key per build key")
        if any(k.is_float for k in probe_keys):
            raise LoweringError("float join key")
        if (mfilter is not None) != (table.mn is not None) or \
                (mfilter is not None and join_type == "INNER"):
            raise ValueError("a min/max test needs a SEMI/ANTI min/max table")
        if mfilter is not None and (mfilter[0] == CMP_EQ or
                                    mfilter[1].is_float):
            raise LoweringError("min/max test of an int `<>, <, <=, >, >=`")
        self.table = table
        self.jtype = JOIN_TYPES[join_type]
        self.probe_keys = list(probe_keys)
        self.payload = list(payload)
        self.mfilter = mfilter


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
            if hop.mfilter is not None:
                out.append(hop.mfilter[1])
        return out

    def section(self, index: Dict[int, int], ncols: int) -> np.ndarray:
        head = [self.n_spine, len(self.hops),
                -1 if self.ppred is None else index[id(self.ppred)],
                C_HOPS + HOP_WORDS * len(self.hops)]
        recs = np.zeros((len(self.hops), HOP_WORDS), np.int64)
        for rec, hop in zip(recs, self.hops):
            t = hop.table
            mop, mprog = hop.mfilter or (-1, None)
            rec[:HOP_KEY0] = [t.kind, hop.jtype, t.rows.data_ptr(),
                              0 if t.keys is None else t.keys.data_ptr(),
                              t.size, len(hop.probe_keys), mop,
                              -1 if mprog is None else index[id(mprog)],
                              0 if t.mn is None else t.mn.data_ptr(),
                              0 if t.mx is None else t.mx.data_ptr()]
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

    @property
    def full(self) -> bool:
        """A min/max hop's test is in the full variant too."""
        return super().full or \
            any(hop.mfilter is not None for hop in self.chain.hops)

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
    if table.dtype != torch.int64 or not table.is_contiguous() or \
            tuple(table.shape) != spec.table_shape:
        raise ValueError(f"table must be a contiguous int64 "
                         f"{list(spec.table_shape)}")
    _check_pair(spec, cols, aux, n_rows, table.device)


def _check_pair(spec, cols: Columns, aux: torch.Tensor, n_rows: int,
                dev: torch.device) -> None:
    """The pair-space columns, aux inputs and build tables of a walk all
    lie on `dev` at the dtypes the programs read."""
    if aux.device != dev or aux.dtype != torch.int64 or \
            not aux.is_contiguous():
        raise ValueError("aux must be a contiguous int64 tensor on the "
                         "walk's device")
    for hop in spec.chain.hops:
        for t in hop.table.tensors():
            if t.device != dev:
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
            int(spec.full), _stream(table.device))
    kernels.check(rc, chain_aggregate_kernel)
    chain_aggregate_kernel.launches += 1
    return table


class ChainRowsSpec(_ChainSpec, _ProgramSpec):
    """A row-returning walk: the chain (its probe predicate and hops), the
    residual predicate over the pair space (the descriptor's H_PRED) and
    one output program per output column. The descriptor's lane section
    holds the outputs as (program, dtype code of the output column); there
    are no keys and no fold."""

    def __init__(self, pools: Pools, residual: Optional[Program],
                 outputs: Sequence[Program], chain: Chain):
        self._init_chain(chain)
        outs = []
        for prog in outputs:
            dtype = _NP_TO_TORCH.get(prog.out_dtype)
            if dtype is None:
                raise LoweringError(f"output of dtype {prog.out_dtype}")
            outs.append((prog, _DTYPE_CODE[dtype]))
        super().__init__(pools, residual, [], outs)
        self.meta = self._layout(0)
        if len(self.meta) * 8 > SMEM_BYTES:
            raise LoweringError("join program too large for the kernel")

    @property
    def outputs(self) -> List[Program]:
        return [p for p, _code in self.lanes]

    def output_dtypes(self) -> List[torch.dtype]:
        return [_NP_TO_TORCH[p.out_dtype] for p in self.outputs]


def chain_rows(spec: ChainRowsSpec, cols: Columns, aux: torch.Tensor,
               n_rows: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Walk the chain for the first `n_rows` spine rows and return, for
    each output program, (data, validity) of the rows that survive, in
    spine order. `cols` maps pair-space indices to (data, validity):
    spine columns of the batch, payload columns of whole build batches.
    Data under a NULL is 0.

    On CPU tensors this runs `chain_rows_plain`; on CUDA tensors it
    launches the `chain_rows` kernel's two passes or raises: the mark
    pass with the three launches of its scan (four), then the emit (one)
    when any row survives. It reads the number of surviving rows back
    between them: one synchronisation."""
    dev = aux.device
    _check_pair(spec, cols, aux, n_rows, dev)
    if not _cuda(aux):
        return chain_rows_plain(spec, cols, aux, n_rows)
    dtypes = spec.output_dtypes()
    if n_rows == 0:
        return [(torch.empty(0, dtype=d, device=dev),
                 torch.empty(0, dtype=torch.bool, device=dev))
                for d in dtypes]
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        meta_d = spec.device_meta(cols, dev)
        # pos[i]: 1 where spine row i survives, then its exclusive prefix
        # sum, the row's output slot; pos[n_rows] ends as the total
        pos = torch.empty(n_rows + 1, dtype=torch.int64, device=dev)
        sums = torch.empty(-(-(n_rows + 1) // SCAN_TILE), dtype=torch.int64,
                           device=dev)
        kernels.check(lib.dft_chain_rows_mark(
            meta_d.data_ptr(), len(spec.meta), aux.data_ptr(), n_rows,
            pos.data_ptr(), sums.data_ptr(), int(spec.full), stream),
            chain_rows_kernel)
        chain_rows_kernel.launches += 4   # the mark, the scan's three
        total = int(pos[n_rows].item())
        outs = [(torch.empty(total, dtype=d, device=dev),
                 torch.empty(total, dtype=torch.bool, device=dev))
                for d in dtypes]
        if total:
            ptrs = torch.tensor([p for d, v in outs
                                 for p in (d.data_ptr(), v.data_ptr())],
                                dtype=torch.int64).to(dev)
            kernels.check(lib.dft_chain_rows_emit(
                meta_d.data_ptr(), len(spec.meta), aux.data_ptr(), n_rows,
                pos.data_ptr(), ptrs.data_ptr(), int(spec.full), stream),
                chain_rows_kernel)
            chain_rows_kernel.launches += 1
    return outs


def _walk_plain(spec, cols: Columns, aux: torch.Tensor, n: int,
                hop_rows: Optional[list] = None):
    """The plain walk: (rows that survive the probe predicate and every
    hop, the pair space with each payload column gathered at the row its
    hop found). With `hop_rows`, appends (rows that reach the hop, rows
    still alive after it) for each hop."""
    dev = aux.device
    hop_of = spec.chain.hop_of
    pair = {i: c for i, c in cols.items() if hop_of.get(i, -1) < 0}
    rows = torch.ones(n, dtype=torch.bool, device=dev)
    if spec.chain.ppred is not None:
        d, v = evaluate(spec.chain.ppred, pair, aux, n)
        rows &= (d != 0) & v
    for hop in spec.chain.hops:
        brow, slot = _lookup_plain(hop, pair, aux, n)
        found = brow >= 0
        if hop.mfilter is not None:
            found &= _mmx_exists_plain(hop, pair, aux, n, slot)
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
    return rows, pair


def chain_rows_plain(spec: ChainRowsSpec, cols: Columns, aux: torch.Tensor,
                     n_rows: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The plain PyTorch version: the walk over whole tensors
    (`_walk_plain`), the residual, then each output program over the pair
    space, kept by `nonzero` in spine order."""
    dev = aux.device
    if n_rows == 0:
        return [(torch.empty(0, dtype=d, device=dev),
                 torch.empty(0, dtype=torch.bool, device=dev))
                for d in spec.output_dtypes()]
    rows, pair = _walk_plain(spec, cols, aux, n_rows)
    if spec.pred is not None:
        d, v = evaluate(spec.pred, pair, aux, n_rows)
        rows &= (d != 0) & v
    keep = rows.nonzero().squeeze(1)
    outs = []
    for prog, dtype in zip(spec.outputs, spec.output_dtypes()):
        d, v = evaluate(prog, pair, aux, n_rows)
        d, v = d[keep], v[keep]
        outs.append((torch.where(v, d, 0).to(dtype), v))
    return outs


def _lookup_plain(hop: Hop, pair: Columns, aux: torch.Tensor, n: int):
    """(the build row each row finds in `hop`'s table, -1 for none; the
    table slot it was found at)."""
    t = hop.table
    dev = aux.device
    miss = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if t.kind == TAB_EMPTY:
        return miss, torch.zeros_like(miss)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    packed = torch.zeros(n, dtype=torch.int64, device=dev)
    for prog, lo, hi, shift in zip(hop.probe_keys, t.los, t.his, t.shifts):
        d, v = evaluate(prog, pair, aux, n)
        inside = v & (d >= lo) & (d <= hi)
        ok &= inside
        packed |= torch.where(inside, d - lo, 0) << shift
    if t.kind == TAB_DIRECT:
        slot = packed.clamp(0, t.size - 1)
        brow = t.rows[slot].to(torch.int64)
    else:
        slot, hit = _sorted_slots(t.keys, packed)
        brow = torch.where(hit, t.rows[slot].to(torch.int64), -1)
    return torch.where(ok, brow, miss), slot


def _mmx_exists_plain(hop: Hop, pair: Columns, aux: torch.Tensor, n: int,
                      slot: torch.Tensor) -> torch.Tensor:
    """The min/max membership test of `hop` at each row's slot."""
    op, prog = hop.mfilter
    x, xv = evaluate(prog, pair, aux, n)
    mn, mx = hop.table.mn[slot], hop.table.mx[slot]
    exists = {CMP_NE: (mn != x) | (mx != x), CMP_LT: mn < x,
              CMP_LE: mn <= x, CMP_GT: mx > x, CMP_GE: mx >= x}[op]
    return exists & xv


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
    rows, pair = _walk_plain(spec, cols, aux, n, hop_rows)
    if isinstance(spec, AggregateSpec):
        return dense_group_aggregate_plain(spec, pair, aux, n, table, rows)
    return hash_group_aggregate_plain(spec, pair, aux, n, table, overflow,
                                      rows)
