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
found, so no joined column is materialised. The kernel walks a warp's
tile of admitted spine rows at a time (`LIST_CAP` entries), compacting
the survivors between hops; the probe predicate reaches it split into
conjuncts (`Chain.conjuncts`), its one-column tests and one-column hop
keys read without the interpreter. The walk feeds the grouped fold of
`device/groupby.py` (dense slots or a hash table), whose output table
`compact_groups` and the host emit take as they are.

The row-returning walk (`chain_rows`, kernel `csrc/chain_rows.cu`).
Counterpart of `DeviceJoinChainRowsExec`'s mask program (`:2312`, jit
`:2339`) and emit program (`:2352`, jit `:2377`). The aggregate walk's
tile walk with no fold: a block takes tiles of ROWS_WARPS x ROWS_TILE
spine rows in spine order by ticket, walks each through the probe
predicate, the hops and the residual, takes its survivors' output slots
by a decoupled look-back over the tiles, and leaves each survivor's spine
row and hop handles in a scratch of an entry a spine row; the wrapper
reads the count (one synchronisation a spine batch, as `:2347`), and the
emit runs every output program over
the survivors through their stored handles and writes its value and
validity at the survivor's slot. The output is in spine order, as the
reference's `searchsorted` compaction gives it.

Staging-time composition and folding (`chain_stage`, kernels
`chain_compose` and `chain_fold` in `csrc/chain_compose.cu`).
Counterpart of `_compose_staged_hops` (`:786`, its program
`_make_compose_prog` `:926`, jit `:887`) and `_fold_lut_pmat` (`:719`,
jit `:756`). A hop whose probe keys are all payload columns of one
earlier INNER hop, its owner (or of hops already composed into it), is
probed once for each of the owner's build rows when the chain is staged;
the results sit in the owner's composed words (`Compose`), and the walk
reads them at the row it found for the owner (`TAB_COMPOSED`) and runs
no probe-key program for the hop. A folded hop (`Fold`) has one record a
table slot: the build row, the composed words of its own composed hops
at that row and the payload words the walk's programs read, so a spine
row resolves the hop and all that hangs on it from adjacent words; its
payload columns then load from the record as int64 columns whose row is
the record's first word. A chain stages all its compositions in one
launch and all its folds in another, from one descriptor (`StageSpec`).

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
from torch.profiler import record_function

from .. import kernels
from .groupby import (_DTYPE_CODE, _NP_TO_TORCH, EMPTY, H_OFF_CHAIN,
                      H_OFF_COLS, H_OFF_KEYS, LANE_MIN_I64, MAX_LANES,
                      SMEM_BYTES, AggregateSpec,
                      Columns, DistinctSet, HashSpec, _check_dset, _cuda,
                      _next_pow2, _ProgramSpec, _stream,
                      dense_group_aggregate_plain, hash_group_aggregate_plain,
                      splitmix64)
from .lower import (CJ_PROG, CMP_EQ, CMP_GE, CMP_GT, CMP_LE, CMP_LT, CMP_NE,
                    OP_COL, LoweringError, Pools, Program, conjunct_form,
                    evaluate, split_conjuncts)

chain_build_kernel = kernels.register(kernels.Kernel(
    "chain_build", "datafusion_tpu_torch/csrc/chain_build.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:177"))
chain_aggregate_kernel = kernels.register(kernels.Kernel(
    "chain_aggregate", "datafusion_tpu_torch/csrc/chain_aggregate.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:1597"))
chain_rows_kernel = kernels.register(kernels.Kernel(
    "chain_rows", "datafusion_tpu_torch/csrc/chain_rows.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:2312"))
chain_compose_kernel = kernels.register(kernels.Kernel(
    "chain_compose", "datafusion_tpu_torch/csrc/chain_compose.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:926"))
chain_fold_kernel = kernels.register(kernels.Kernel(
    "chain_fold", "datafusion_tpu_torch/csrc/chain_compose.cu",
    "datafusion_tpu/physical/plan/device_join_chain.py:719"))

# build table kinds (a composed hop reads its owner's composed words) and
# hop join types (mirrored in csrc/program.cuh)
TAB_DIRECT, TAB_HASH, TAB_EMPTY, TAB_COMPOSED = range(4)
JT_INNER, JT_SEMI, JT_ANTI = range(3)
JOIN_TYPES = {"INNER": JT_INNER, "LEFTSEMI": JT_SEMI, "LEFTANTI": JT_ANTI}

# the chain section of a descriptor: a head, a record per hop, the hop of
# every pair-space column (-1: spine), then the probe predicate's
# conjuncts (four words each: a direct form of `lower.conjunct_form`, or
# (CJ_PROG, program)). HOP_TABLE is read at byte HOP_STRIDE a slot (4: an
# int32 table; a folded hop's record size); a composed hop's HOP_TABLE is
# its first word at the owner's row handle 0, HOP_STRIDE the bytes a unit
# of that handle moves, HOP_OWNER the owner. A probe key's program is
# -2 - c when it is column c alone (loaded without the interpreter).
C_NSPINE, C_NHOPS, C_PPRED, C_OFF_HOPOF, C_NCONJ, C_OFF_CONJ, C_HOPS = \
    range(7)
(HOP_KIND, HOP_JTYPE, HOP_TABLE, HOP_KEYS, HOP_SIZE, HOP_NKEYS, HOP_MOP,
 HOP_MPROG, HOP_MN, HOP_MX, HOP_STRIDE, HOP_OWNER, HOP_FOLD,
 HOP_KEY0) = range(14)
MAX_HOPS = 8
MAX_HOP_KEYS = 4
HOP_WORDS = HOP_KEY0 + 4 * MAX_HOP_KEYS    # (prog, lo, hi, shift) per key

LIST_CAP = 128            # entries of a warp's lists (chain_aggregate.cu)
ROWS_TILE = 256           # spine rows a warp walks of a block's tile,
ROWS_WARPS = 8            # of this many warps (chain_rows.cu kWarps)
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
            # a SEMI or ANTI build keeps any one row of a key: no flag
            dup = torch.zeros(1, dtype=torch.int32, device=dev) \
                if unique else None
            meta = spec.packed_meta(los, shifts)
            meta_d = spec.device_meta(cols, dev, meta)
            kernels.check(lib.dft_chain_build_insert(
                meta_d.data_ptr(), len(meta), aux.data_ptr(), n_rows, kind,
                size, rows.data_ptr(),
                None if keys is None else keys.data_ptr(),
                None if mn is None else mn.data_ptr(),
                None if mx is None else mx.data_ptr(),
                None if dup is None else dup.data_ptr(), int(spec.full),
                stream), chain_build_kernel)
            chain_build_kernel.launches += 1
            flag = int(dup.item()) if unique else 0
            if flag == 2:
                raise RuntimeError("chain build table overflowed")
            duplicate = flag == 1
    return BuildTable(kind, los, his, shifts, size, rows, keys, live,
                      duplicate, mn, mx)


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

class Compose:
    """A hop resolved at staging time through the build rows of an earlier
    INNER hop, its `owner`. `words` (int64 [owner build rows, width],
    shared by every hop composed into that owner, in chain order) holds at
    column `word` the build row this hop finds for each owner row (-1:
    none) and, for a min/max hop, the member's min and max of the key found
    at `word + 1` and `word + 2` (0 where none). `tag` is the reference's
    marker (`:813-839`): "inner" for an INNER hop with payload, "mmx" for a
    filtered SEMI/ANTI, "member" otherwise."""

    def __init__(self, owner: int, tag: str, words: torch.Tensor, word: int):
        self.owner = owner
        self.tag = tag
        self.words = words
        self.word = word

    @property
    def width(self) -> int:
        return 3 if self.tag == "mmx" else 1


class Fold:
    """The record table of a folded hop: `records`, int64 [table slots,
    `words`], one record a slot of the hop's table. Word 0 is the build
    row (-1: none), words 1 to `n_comp` the owner's composed words at that
    row, then one word for each payload column the walk reads (`columns`:
    pair index -> (word, whether it has NULLs)), the value as the
    interpreter loads it (a float32 widened to float64). `valid`, uint8
    laid out as `records`, holds the validity byte of each such word when
    a column has NULLs (else None). A record takes a power of two of words
    up to four (one 32-byte sector), else a multiple of four. `span` and
    `width`: the reference's budget for the fold (its direct-address span
    and int32 lanes, `:736`)."""

    def __init__(self, n_comp: int, columns: Sequence[Tuple[int, bool]],
                 span: int, width: int):
        self.n_comp = n_comp
        self.span, self.width = span, width
        self.columns: Dict[int, Tuple[int, bool]] = {
            idx: (1 + n_comp + k, nullable)
            for k, (idx, nullable) in enumerate(columns)}
        words = 1 + n_comp + len(columns)
        self.words = _next_pow2(words) if words <= 4 else -(-words // 4) * 4
        self.nullable = any(n for _i, n in columns)
        self.records: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None


class Hop:
    """One hop of the walk: its build table, join type, probe-key programs
    (over the pair space), the pair-space indices of its payload and, for
    a filtered SEMI/ANTI over a min/max table, `mfilter`: (comparison code
    of `member OP x`, the program of x over the pair space). A composed
    hop (`compose`) runs no probe-key program; a folded one (`fold`) reads
    its row and payload from its record table."""

    def __init__(self, table: BuildTable, join_type: str,
                 probe_keys: Sequence[Program], payload: Sequence[int],
                 mfilter: Optional[Tuple[int, Program]] = None,
                 compose: Optional[Compose] = None,
                 fold: Optional[Fold] = None):
        if join_type not in JOIN_TYPES:
            raise LoweringError(f"{join_type} join in a chain")
        if compose is None and len(probe_keys) != len(table.los):
            raise ValueError("one probe key per build key")
        if any(k.is_float for k in probe_keys):
            raise LoweringError("float join key")
        if mfilter is not None and (table.mn is None or
                                    join_type == "INNER"):
            raise ValueError("a min/max test needs a SEMI/ANTI min/max table")
        if mfilter is not None and (mfilter[0] == CMP_EQ or
                                    mfilter[1].is_float):
            raise LoweringError("min/max test of an int `<>, <, <=, >, >=`")
        if compose is not None and fold is not None:
            raise ValueError("a composed hop has no table to fold")
        self.table = table
        self.jtype = JOIN_TYPES[join_type]
        self.probe_keys = list(probe_keys)
        self.payload = list(payload)
        self.mfilter = mfilter
        self.compose = compose
        self.fold = fold

    def tensors(self) -> List[torch.Tensor]:
        out = self.table.tensors()
        if self.compose is not None:
            out.append(self.compose.words)
        if self.fold is not None:
            out += [t for t in (self.fold.records, self.fold.valid)
                    if t is not None]
        return out


class Chain:
    """The walk of one chain: spine width, probe predicate and hops. The
    predicate's top-level AND is split into its conjuncts
    (`split_conjuncts`): `conjuncts` holds each as (direct form or None,
    its program), the direct ones first, which the kernels test straight
    from their columns (`lower.conjunct_form`); the others run as programs
    of their own."""

    def __init__(self, n_spine: int, ppred: Optional[Program],
                 hops: Sequence[Hop]):
        if len(hops) > MAX_HOPS:
            raise LoweringError(f"{len(hops)} hops > {MAX_HOPS}")
        self.n_spine = n_spine
        self.ppred = ppred
        parts = [] if ppred is None else [
            (conjunct_form(c), c) for c in split_conjuncts(ppred)]
        self.conjuncts = [p for p in parts if p[0] is not None] + \
            [p for p in parts if p[0] is None]
        self.hops = list(hops)
        self.hop_of: Dict[int, int] = {}
        for h, hop in enumerate(self.hops):
            for p in hop.payload:
                self.hop_of[p] = h

    def programs(self) -> List[Program]:
        out = [self.ppred] if self.ppred is not None else []
        out += [c for form, c in self.conjuncts if form is None]
        for hop in self.hops:
            if hop.compose is None:
                out += hop.probe_keys
            if hop.mfilter is not None:
                out.append(hop.mfilter[1])
        return out

    def _record(self, hop: Hop, index: Dict[int, int]) -> np.ndarray:
        rec = np.zeros(HOP_WORDS, np.int64)
        mop, mprog = hop.mfilter or (-1, None)
        rec[[HOP_JTYPE, HOP_MOP, HOP_MPROG, HOP_OWNER]] = [
            hop.jtype, mop, -1 if mprog is None else index[id(mprog)], -1]
        c = hop.compose
        if c is not None:
            owner = self.hops[c.owner].fold
            if owner is not None:     # the owner's row handle: its record
                base = owner.records.data_ptr() + 8 * (1 + c.word)
                stride = 1
            else:                     # the owner's row handle: a build row
                base = c.words.data_ptr() + 8 * c.word
                stride = c.words.shape[1]
            rec[[HOP_KIND, HOP_TABLE, HOP_STRIDE, HOP_OWNER]] = [
                TAB_COMPOSED, base, stride, c.owner]
            if hop.mfilter is not None:
                rec[[HOP_MN, HOP_MX]] = [base + 8, base + 16]
            return rec
        t, f = hop.table, hop.fold
        rec[[HOP_KIND, HOP_TABLE, HOP_KEYS, HOP_SIZE, HOP_NKEYS, HOP_MN,
             HOP_MX, HOP_STRIDE, HOP_FOLD]] = [
            t.kind, (t.rows if f is None else f.records).data_ptr(),
            0 if t.keys is None else t.keys.data_ptr(), t.size,
            len(hop.probe_keys), 0 if t.mn is None else t.mn.data_ptr(),
            0 if t.mx is None else t.mx.data_ptr(),
            4 if f is None else 8 * f.words, 0 if f is None else f.words]
        for k, prog in enumerate(hop.probe_keys):
            direct = len(prog.code) == 1 and prog.code[0][0] == OP_COL
            rec[HOP_KEY0 + 4 * k:HOP_KEY0 + 4 * k + 4] = [
                -2 - prog.code[0][1] if direct else index[id(prog)],
                t.los[k], t.his[k], t.shifts[k]]
        return rec

    def section(self, index: Dict[int, int], ncols: int) -> np.ndarray:
        off_hopof = C_HOPS + HOP_WORDS * len(self.hops)
        head = [self.n_spine, len(self.hops),
                -1 if self.ppred is None else index[id(self.ppred)],
                off_hopof, len(self.conjuncts), off_hopof + ncols]
        recs = [self._record(hop, index) for hop in self.hops]
        hop_of = [self.hop_of.get(i, -1) for i in range(ncols)]
        conj = [form if form is not None else (CJ_PROG, index[id(c)], 0, 0)
                for form, c in self.conjuncts]
        return np.concatenate([np.asarray(head, np.int64), *recs,
                               np.asarray(hop_of, np.int64),
                               np.asarray(conj, np.int64).reshape(-1)])

    def record_columns(self) -> Dict[int, Tuple[int, int]]:
        """{pair index: (its word's address in record 0, its validity
        byte's or 0)} of every payload column a folded hop's records
        hold."""
        out = {}
        for hop in self.hops:
            f = hop.fold
            if f is not None:
                for idx, (word, nullable) in f.columns.items():
                    out[idx] = (f.records.data_ptr() + 8 * word,
                                f.valid.data_ptr() + word if nullable else 0)
        return out


class _ChainSpec:
    """A grouped fold (dense or hash) whose rows come through a join chain:
    the chain's programs join the descriptor's program list, and its
    section follows the lanes."""

    def _init_chain(self, chain: Chain):
        self.chain = chain

    def _pass_programs(self, lanes) -> List[Program]:
        return super()._pass_programs(lanes) + self.chain.programs()

    @property
    def full(self) -> bool:
        """A min/max hop's test is in the full variant too."""
        return super().full or \
            any(hop.mfilter is not None for hop in self.chain.hops)

    @property
    def variant(self) -> int:
        """The walk kernel's instantiation: bit 0 the full interpreter, bit
        1 a staged chain (composed or folded hops)."""
        staged = any(h.compose is not None or h.fold is not None
                     for h in self.chain.hops)
        return int(self.full) | int(staged) << 1

    def _chain_section(self, index: Dict[int, int]) -> np.ndarray:
        return self.chain.section(index, self.ncols)

    def _patch_columns(self, meta: np.ndarray) -> None:
        """A folded hop's payload columns load from its records, as int64
        columns whose row is the record's first word."""
        base = int(meta[H_OFF_COLS])
        for idx, (data, valid) in self.chain.record_columns().items():
            if idx in self.pools.columns:
                meta[base + 3 * idx:base + 3 * idx + 3] = [
                    data, valid, _DTYPE_CODE[torch.int64]]


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
        for t in hop.tensors():
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
                    overflow: Optional[torch.Tensor] = None,
                    dset: Optional[DistinctSet] = None) -> torch.Tensor:
    """Walk the chain for the first `n_rows` spine rows and fold the rows
    that survive it into `table` in place: a dense `[lanes + 1, G]` table
    for a ChainDenseSpec, a hash table `[lanes + 2, cap]` and its int32
    `overflow` flag for a ChainHashSpec. `cols` maps pair-space indices to
    (data, validity): spine columns of the batch, payload columns of whole
    build batches. The distinct lanes' pairs go to `dset`.

    On CPU tensors this runs `chain_aggregate_plain`; on CUDA tensors it
    launches the `chain_aggregate` kernel (the tile walk) once a pass of
    lanes, or raises."""
    _check_chain(spec, cols, aux, n_rows, table)
    if n_rows >= 1 << 31:
        raise ValueError("a spine batch holds at most 2^31 - 1 rows")
    _check_dset(spec, dset, table.device)
    dense = isinstance(spec, AggregateSpec)
    if not dense and (overflow is None or overflow.device != table.device):
        raise ValueError("a hash fold needs its overflow flag")
    if not _cuda(table):
        return chain_aggregate_plain(spec, cols, aux, n_rows, table,
                                     overflow, dset=dset)
    if n_rows == 0:
        return table
    lib = kernels.library()
    with torch.cuda.device(table.device):
        for meta, (_at, lanes) in zip(spec.metas, spec.passes):
            meta_d = spec.device_meta(cols, table.device, meta, dset)
            rc = lib.dft_chain_aggregate(
                meta_d.data_ptr(), len(meta), len(lanes),
                spec.groups if dense else 0, aux.data_ptr(), n_rows,
                0 if dense else spec.cap,
                0 if dense else (1 if spec.identity_slots else 2),
                table.data_ptr(), None if dense else overflow.data_ptr(),
                spec.variant, len(spec.chain.hops), LIST_CAP,
                _stream(table.device))
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
        if len(outs) > MAX_LANES:
            raise LoweringError(f"{len(outs)} outputs > {MAX_LANES}")
        super().__init__(pools, residual, [], outs)
        self.meta = self._layout(0)
        if len(self.meta) * 8 > SMEM_BYTES:
            raise LoweringError("join program too large for the kernel")

    @property
    def outputs(self) -> List[Program]:
        return [p for p, _code in self.lanes]

    def output_dtypes(self) -> List[torch.dtype]:
        return [_NP_TO_TORCH[p.out_dtype] for p in self.outputs]


def upload(words: np.ndarray, dev: torch.device) -> torch.Tensor:
    """int64 `words` on the card by one copy from pinned memory that does
    not wait for the stream. The buffer is fresh from PyTorch's caching
    host allocator, which records the copy on the stream and reuses the
    block only once the copy has finished, so nothing rewrites it early."""
    host = torch.empty(len(words), dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = words
    return host.to(dev, non_blocking=True)


def chain_rows(spec: ChainRowsSpec, cols: Columns, aux: torch.Tensor,
               n_rows: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Walk the chain for the first `n_rows` spine rows and return, for
    each output program, (data, validity) of the rows that survive, in
    spine order. `cols` maps pair-space indices to (data, validity):
    spine columns of the batch, payload columns of whole build batches.
    Data under a NULL is 0.

    On CPU tensors this runs `chain_rows_plain`; on CUDA tensors it zero
    fills the walk's state words (a ticket, the total, a status word a
    tile), launches the `chain_rows` kernel's tile walk, which leaves each
    survivor's spine row and hop handles in a scratch of an entry a spine
    row (no count overflows it), then its emit over the survivors when
    any survive: two kernel launches and the fill. It reads the number of
    survivors back between them: one synchronisation."""
    dev = aux.device
    _check_pair(spec, cols, aux, n_rows, dev)
    if n_rows >= 1 << 31:
        raise ValueError("a spine batch holds at most 2^31 - 1 rows")
    if not _cuda(aux):
        return chain_rows_plain(spec, cols, aux, n_rows)
    dtypes = spec.output_dtypes()
    if n_rows == 0:
        return [(torch.empty(0, dtype=d, device=dev),
                 torch.empty(0, dtype=torch.bool, device=dev))
                for d in dtypes]
    lib = kernels.library()
    n_hops = len(spec.chain.hops)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        meta_d = upload(spec.host_meta(cols), dev)
        tiles = -(-n_rows // (ROWS_WARPS * ROWS_TILE))
        # the ticket, the total, then a look-back status word a tile
        state = torch.zeros(2 + tiles, dtype=torch.int64, device=dev)
        rows = torch.empty(n_rows, dtype=torch.int32, device=dev)
        handles = torch.empty(n_hops * n_rows, dtype=torch.int32, device=dev)
        kernels.check(lib.dft_chain_rows_walk(
            meta_d.data_ptr(), len(spec.meta), aux.data_ptr(), n_rows,
            n_hops, ROWS_TILE, state.data_ptr(), rows.data_ptr(),
            handles.data_ptr(), spec.variant, stream), chain_rows_kernel)
        chain_rows_kernel.launches += 1
        total = int(state[1].item())
        outs = [(torch.empty(total, dtype=d, device=dev),
                 torch.empty(total, dtype=torch.bool, device=dev))
                for d in dtypes]
        if total:
            # the outputs' pointers go by value, in the launch itself
            ptrs = np.asarray([p for d, v in outs
                               for p in (d.data_ptr(), v.data_ptr())],
                              np.int64)
            kernels.check(lib.dft_chain_rows_emit(
                meta_d.data_ptr(), len(spec.meta), aux.data_ptr(), total,
                rows.data_ptr(), handles.data_ptr(), n_rows, ptrs.ctypes.data,
                len(outs), spec.variant, stream), chain_rows_kernel)
            chain_rows_kernel.launches += 1
    return outs


def _walk_plain(spec, cols: Columns, aux: torch.Tensor, n: int,
                hop_rows: Optional[list] = None):
    """The plain walk: (rows that survive the probe predicate and every
    hop, the pair space with each payload column gathered at the row its
    hop found). A composed hop reads its owner's composed words (from the
    owner's records when the owner is folded), a folded hop its records.
    With `hop_rows`, appends (rows that reach the hop, rows still alive
    after it) for each hop."""
    dev = aux.device
    hop_of = spec.chain.hop_of
    pair = {i: c for i, c in cols.items() if hop_of.get(i, -1) < 0}
    rows = torch.ones(n, dtype=torch.bool, device=dev)
    if spec.chain.ppred is not None:
        d, v = evaluate(spec.chain.ppred, pair, aux, n)
        rows &= (d != 0) & v
    found_at = []   # per hop: (build row, its records' rows or None)
    for hop in spec.chain.hops:
        rec = mn = mx = None
        c = hop.compose
        if c is not None:
            ob, orec = found_at[c.owner]
            if orec is not None:
                words = orec[0][:, 1 + c.word:1 + c.word + c.width]
            elif c.words.shape[0]:
                words = c.words[ob.clamp(min=0), c.word:c.word + c.width]
            else:
                words = torch.zeros((n, c.width), dtype=torch.int64,
                                    device=dev)
            brow = torch.where(ob >= 0, words[:, 0], -1)
            if c.tag == "mmx":
                mn, mx = words[:, 1], words[:, 2]
        else:
            brow, slot = _lookup_plain(hop, pair, aux, n)
            if hop.fold is not None:
                f = hop.fold
                rec = (f.records[slot],
                       None if f.valid is None else f.valid[slot])
            if hop.mfilter is not None:
                mn, mx = hop.table.mn[slot], hop.table.mx[slot]
        found = brow >= 0
        if hop.mfilter is not None:
            found &= _mmx_exists_plain(hop, pair, aux, n, mn, mx)
        reach = int(rows.sum()) if hop_rows is not None else 0
        rows &= ~found if hop.jtype == JT_ANTI else found
        if hop_rows is not None:
            hop_rows.append((reach, int(rows.sum())))
        found_at.append((brow, rec))
        at = brow.clamp(min=0)
        for p in hop.payload:
            if p not in cols:
                continue
            data, valid = cols[p]
            if rec is not None and p in hop.fold.columns:
                word, nullable = hop.fold.columns[p]
                ok = found & (rec[1][:, word] != 0) if nullable else found
                pair[p] = (_from_word(rec[0][:, word], data.dtype), ok)
                continue
            if data.numel() == 0:       # an empty build finds nothing
                pair[p] = (torch.zeros(n, dtype=data.dtype, device=dev),
                           torch.zeros(n, dtype=torch.bool, device=dev))
                continue
            ok = found if valid is None else found & valid[at]
            pair[p] = (data[at], ok)
    return rows, pair


def _to_word(data: torch.Tensor) -> torch.Tensor:
    """Column values as the interpreter loads them: int64, or float64
    bits (a float32 widened)."""
    if data.dtype == torch.float32:
        data = data.to(torch.float64)
    if data.dtype == torch.float64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def _from_word(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`_to_word`'s inverse, back to a column of `dtype`."""
    if dtype in (torch.float32, torch.float64):
        return words.view(torch.float64).to(dtype)
    if dtype == torch.bool:
        return words != 0
    return words.to(dtype)


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
    """(the build row each row finds in `hop`'s table, -1 for none, read
    from the hop's records when it is folded; the table slot it was found
    at)."""
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
        hit = ok
    else:
        slot, hit = _sorted_slots(t.keys, packed)
        hit &= ok
    brow = t.rows[slot].to(torch.int64) if hop.fold is None else \
        hop.fold.records[slot, 0]
    return torch.where(hit, brow, miss), slot


def _mmx_exists_plain(hop: Hop, pair: Columns, aux: torch.Tensor, n: int,
                      mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """The min/max membership test of `hop` over the member's min `mn`
    and max `mx` of each row's key."""
    op, prog = hop.mfilter
    x, xv = evaluate(prog, pair, aux, n)
    exists = {CMP_NE: (mn != x) | (mx != x), CMP_LT: mn < x,
              CMP_LE: mn <= x, CMP_GT: mx > x, CMP_GE: mx >= x}[op]
    return exists & xv


def chain_aggregate_plain(spec, cols: Columns, aux: torch.Tensor,
                          n_rows: int, table: torch.Tensor,
                          overflow: Optional[torch.Tensor] = None,
                          hop_rows: Optional[list] = None,
                          dset: Optional[DistinctSet] = None
                          ) -> torch.Tensor:
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
        return dense_group_aggregate_plain(spec, pair, aux, n, table, rows,
                                           dset)
    return hash_group_aggregate_plain(spec, pair, aux, n, table, overflow,
                                      rows, dset)


# --- staging-time composition and folding -------------------------------------

# the compose table (csrc/chain_compose.cu): 3 words an owner, 5 a
# composed hop; the fold table: 10 words a folded table, 4 a column
COMPOSE_OWNER_WORDS, COMPOSE_HOP_WORDS = 3, 5
FOLD_WORDS, FOLD_COL_WORDS = 10, 4


class StageSpec(_ProgramSpec):
    """The staging of one chain: its compositions and its folds, in one
    descriptor.

    `chain` holds every hop of the chain: each composed hop with its own
    table and probe-key programs (over the pair space, on `pools`), every
    other hop a stub that names its payload columns (`stub_hop`).
    `composed` maps each composed hop, in chain order, to (owner, its first
    word in the owner's words, its `Compose` tag: a min/max hop, "mmx",
    writes three words, any other one);
    `rows` maps each owner to its build rows. `folds` lists each folded
    hop as (hop, its table, its `Fold`, whose `columns` name the payload
    columns its records hold). The descriptor is the programs' with the
    chain section, the compose table after it; the fold table follows the
    descriptor. Owners' words and folds' records are given at the call
    (`chain_stage`)."""

    def __init__(self, pools: Pools, chain: Chain,
                 composed: Dict[int, Tuple[int, int, str]],
                 rows: Dict[int, int],
                 folds: Sequence[Tuple[int, BuildTable, "Fold"]]):
        self.chain = chain
        self.composed = dict(composed)
        self.rows = dict(rows)
        self.folds = list(folds)
        super().__init__(pools, None, [], [])
        self.meta = self._layout(0)
        if len(self.meta) * 8 > SMEM_BYTES:
            raise LoweringError("compose program too large for the kernel")

    def _pass_programs(self, lanes) -> List[Program]:
        return [p for h in self.composed
                for p in self.chain.hops[h].probe_keys]

    def _chain_section(self, index: Dict[int, int]) -> np.ndarray:
        owners = list(self.rows)
        first = np.cumsum([0] + [self.rows[o] for o in owners])[:-1]
        table = [len(owners)]
        for o, f in zip(owners, first):
            table += [o, self.rows[o], int(f)]
        table.append(len(self.composed))
        for h, (owner, _word, tag) in self.composed.items():
            table += [h, owner, 0, 0, int(tag == "mmx")]  # out, stride later
        return np.concatenate([self.chain.section(index, self.ncols),
                               np.asarray(table, np.int64)])

    @property
    def compose_threads(self) -> int:
        return sum(self.rows.values()) if self.composed else 0

    @property
    def fold_threads(self) -> int:
        return sum(t.size for _h, t, _f in self.folds)

    def host_words(self, cols: Columns, words: Dict[int, torch.Tensor],
                   folds: Sequence[Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]]
                   ) -> np.ndarray:
        """The descriptor with the column pointers, each composed hop's
        output address and row stride in its owner's `words`, then the fold
        table over the records and validity bytes `folds` (one pair a
        folded hop, in `self.folds` order)."""
        meta = self.host_meta(cols)
        ch = int(meta[H_OFF_CHAIN])
        ct = ch + int(meta[ch + C_OFF_CONJ])
        at = ct + 1 + COMPOSE_OWNER_WORDS * len(self.rows) + 1
        for k, (h, (owner, word, _w)) in enumerate(self.composed.items()):
            w = words[owner]
            meta[at + COMPOSE_HOP_WORDS * k + 2] = w.data_ptr() + 8 * word
            meta[at + COMPOSE_HOP_WORDS * k + 3] = w.shape[1]
        head, col_words, first = [len(self.folds)], [], 0
        off = 1 + FOLD_WORDS * len(self.folds)
        for (h, table, fold), (rec, valid) in zip(self.folds, folds):
            comp = words.get(h)
            head += [first, table.size, table.rows.data_ptr(),
                     0 if comp is None else comp.data_ptr(), fold.n_comp,
                     rec.data_ptr(), 0 if valid is None else valid.data_ptr(),
                     fold.words, len(fold.columns),
                     off + len(col_words)]
            for idx, (word, _nullable) in fold.columns.items():
                data, v = cols[idx]
                col_words += [data.data_ptr(),
                              0 if v is None else v.data_ptr(),
                              _DTYPE_CODE[data.dtype], word]
            first += table.size
        return np.concatenate([meta, np.asarray(head + col_words, np.int64)])


def stub_hop(payload: Sequence[int], rows: torch.Tensor) -> Hop:
    """A hop of a staging chain that the kernel never probes (an empty
    table over `rows`, any int32 tensor on the device, never read): it
    names the hop of its payload columns."""
    return Hop(BuildTable(TAB_EMPTY, [], [], [], 1, rows, None, 0, False),
               "INNER", [], payload)


def new_stage_outputs(spec: StageSpec, device: torch.device):
    """Outputs for `chain_stage`, left uninitialised: each owner's words
    (int64 [build rows, words]) and each fold's (records, validity bytes or
    None)."""
    width: Dict[int, int] = {}
    for owner, word, tag in spec.composed.values():
        width[owner] = max(width.get(owner, 0),
                           word + (3 if tag == "mmx" else 1))
    words = {o: torch.empty((spec.rows[o], w), dtype=torch.int64,
                            device=device) for o, w in width.items()}
    folds = [(torch.empty((t.size, f.words), dtype=torch.int64,
                          device=device),
              torch.empty((t.size, f.words), dtype=torch.uint8,
                          device=device) if f.nullable else None)
             for _h, t, f in spec.folds]
    return words, folds


def chain_stage(spec: StageSpec, cols: Columns, aux: torch.Tensor,
                words: Dict[int, torch.Tensor],
                folds: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
                ) -> None:
    """Stage a chain's compositions and folds.

    For each composed hop, each of its owner's build rows is probed once:
    the probe keys over the owner's columns at the row (and the columns of
    hops composed into the owner before it, at the rows they found there),
    NULL or outside [lo, hi] finding nothing. The build row found (-1:
    none) goes to the hop's first word in `words[owner]` (int64 [rows,
    width]) and, for a min/max hop, the key's member min and max to the
    next two (0 where none). Then each folded hop's records (int64 [table
    slots, fold.words]) get, for each slot, the build row it holds, the
    owner's composed words at that row and each payload column the fold
    holds at that row, and their validity bytes (uint8, the same shape, or
    None): a slot with no row holds -1 and zeros. `cols` maps the pair-space
    indices that the programs and the folds read to whole build columns.
    Every word of the outputs is written; none needs zeroing first.

    On CPU tensors this runs `chain_stage_plain`; on CUDA tensors it
    uploads one descriptor (pinned, without a wait; span
    `dft.stage.upload`) and launches the
    `chain_compose` kernel once (when a hop composes) and the `chain_fold`
    kernel once (when a hop folds), or raises."""
    dev = aux.device
    _check_stage(spec, cols, aux, words, folds)
    if not _cuda(aux):
        return chain_stage_plain(spec, cols, aux, words, folds)
    n_comp, n_fold = spec.compose_threads, spec.fold_threads
    if not n_comp and not n_fold:
        return None
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        with record_function("dft.stage.upload"):
            desc = upload(spec.host_words(cols, words, folds), dev)
        if n_comp:
            kernels.check(lib.dft_chain_compose(
                desc.data_ptr(), len(spec.meta), aux.data_ptr(), n_comp,
                int(spec.full), stream), chain_compose_kernel)
            chain_compose_kernel.launches += 1
        if n_fold:
            kernels.check(lib.dft_chain_fold(
                desc.data_ptr() + 8 * len(spec.meta), n_fold, stream),
                chain_fold_kernel)
            chain_fold_kernel.launches += 1
    return None


def _check_stage(spec: StageSpec, cols: Columns, aux: torch.Tensor,
                 words: Dict[int, torch.Tensor],
                 folds: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
                 ) -> None:
    dev = aux.device
    if aux.dtype != torch.int64 or not aux.is_contiguous():
        raise ValueError("aux must be a contiguous int64 tensor")
    for owner, word, tag in spec.composed.values():
        width = 3 if tag == "mmx" else 1
        w = words.get(owner)
        if w is None or w.device != dev or w.dtype != torch.int64 or \
                not w.is_contiguous() or w.dim() != 2 or \
                w.shape[0] != spec.rows[owner] or \
                not 0 <= word <= w.shape[1] - width:
            raise ValueError("words must be a contiguous int64 [owner rows, "
                             "width] on the device with each hop inside")
    if len(folds) != len(spec.folds):
        raise ValueError("one (records, validity) a folded hop")
    for (h, table, fold), (rec, valid) in zip(spec.folds, folds):
        comp = words.get(h)
        shape = (table.size, fold.words)
        if rec.device != dev or rec.dtype != torch.int64 or \
                not rec.is_contiguous() or tuple(rec.shape) != shape or \
                (valid is None) != (not fold.nullable) or \
                (valid is not None and (
                    valid.device != dev or valid.dtype != torch.uint8 or
                    not valid.is_contiguous() or
                    tuple(valid.shape) != shape)) or \
                (comp is None) != (fold.n_comp == 0) or \
                (comp is not None and comp.shape[1] != fold.n_comp):
            raise ValueError("records, validity and composed words must "
                             "match the fold's layout")
        if table.rows.device != dev:
            raise ValueError("a build table lies on another device")
        for idx, (_word, nullable) in fold.columns.items():
            data, v = cols[idx]
            if data.device != dev or not data.is_contiguous() or \
                    data.dtype not in _DTYPE_CODE or \
                    (v is not None) != nullable or \
                    (v is not None and v.device != dev):
                raise ValueError("fold columns: contiguous 1-D tensors on "
                                 "the table's device, NULLs as the layout "
                                 "says")
    for hop in spec.chain.hops:
        for t in hop.tensors():
            if t.device != dev:
                raise ValueError("a build table lies on another device")
    for idx in spec.pools.columns:
        if idx not in cols:
            raise ValueError(f"column {idx} is read but not given")
        data, valid = cols[idx]
        if data.device != dev or not data.is_contiguous() or \
                data.dim() != 1 or data.dtype != spec.column_dtype(idx):
            raise ValueError(f"column {idx}: contiguous 1-D "
                             f"{spec.column_dtype(idx)} on {dev} expected")
        if valid is not None and (valid.device != dev or
                                  valid.dtype != torch.bool or
                                  valid.shape[0] < data.shape[0]):
            raise ValueError(f"column {idx}: bad validity")


def chain_stage_plain(spec: StageSpec, cols: Columns, aux: torch.Tensor,
                      words: Dict[int, torch.Tensor],
                      folds: Sequence[Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]]
                      ) -> None:
    """The plain PyTorch version: for each composed hop in chain order, the
    owner's rows as a whole tensor, each earlier hop composed into the same
    owner at the rows it found, the hop's lookup (`_lookup_plain`) over the
    pair space at those rows; then each fold's records by indexing
    (`chain_fold_plain`)."""
    dev = aux.device
    found: Dict[int, torch.Tensor] = {}
    for h, (owner, word, tag) in spec.composed.items():
        n = spec.rows[owner]
        if owner not in found:
            found[owner] = torch.arange(n, device=dev)
        hop = spec.chain.hops[h]
        pair = {}
        for idx in {i for p in hop.probe_keys for op, i, _b in p.code
                    if op == OP_COL}:
            at = found[spec.chain.hop_of[idx]]
            data, valid = cols[idx]
            ok = at >= 0
            at = at.clamp(min=0)
            if data.numel() == 0:
                pair[idx] = (torch.zeros(n, dtype=data.dtype, device=dev),
                             torch.zeros(n, dtype=torch.bool, device=dev))
                continue
            pair[idx] = (data[at], ok if valid is None else ok & valid[at])
        brow, slot = _lookup_plain(hop, pair, aux, n)
        out = words[owner]
        out[:, word] = brow
        if tag == "mmx":
            t = hop.table
            out[:, word + 1] = torch.where(brow >= 0, t.mn[slot], 0)
            out[:, word + 2] = torch.where(brow >= 0, t.mx[slot], 0)
        found[h] = brow
    for (h, table, fold), (rec, valid) in zip(spec.folds, folds):
        r, v = chain_fold_plain(table, words.get(h),
                                [cols[i] for i in fold.columns], fold)
        rec.copy_(r)
        if valid is not None:
            valid.copy_(v)
    return None


def chain_fold_plain(table: BuildTable, comp: Optional[torch.Tensor],
                     columns: Sequence[Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]],
                     fold: Fold) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """The records of a folded hop (int64 [table.size, fold.words], laid out
    by `fold`) and their validity bytes (uint8, the same shape, or None),
    by indexing: for each slot of `table`, the build row it holds, the
    owner's composed words `comp` (int64 [build rows, fold.n_comp], or
    None) at that row and, in the order of `fold.columns`, each of
    `columns` ((data, validity) of a whole build column) at that row. A
    slot with no row holds -1 and zeros."""
    dev = table.rows.device
    shape = (table.size, fold.words)
    records = torch.zeros(shape, dtype=torch.int64, device=dev)
    valid = torch.zeros(shape, dtype=torch.uint8, device=dev) \
        if fold.nullable else None
    rows = table.rows.to(torch.int64)
    records[:, 0] = rows
    ok = rows >= 0
    if not bool(ok.any()):
        return records, valid
    at = rows.clamp(min=0)
    if comp is not None:
        records[:, 1:1 + fold.n_comp] = torch.where(ok[:, None], comp[at], 0)
    for (data, v), (word, nullable) in zip(columns, fold.columns.values()):
        records[:, word] = torch.where(ok, _to_word(data)[at], 0)
        if nullable:
            valid[:, word] = (ok & v[at]).to(torch.uint8)
    return records, valid
