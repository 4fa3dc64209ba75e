"""A fanout-N INNER hash join fused with grouped aggregation: the build
multi-map and the probe-and-fold.

Counterpart of the device half of
`datafusion_tpu/physical/plan/device_join_agg.py` (`DeviceJoinAggregateExec`).
The reference hashes the build keys (`_hash_keys` `:404`) and argsorts the
hashes (`build_prog` `:267`), or takes a direct LUT for unique dense keys
(`lut_prog` `:240`, `dense_prog` `:530`); per probe row it finds the match
range by searchsorted and counts the pairs (`count_prog` `:573`), expands
them into a speculative bucketed capacity with a poison retry
(`expand_prog` `:615`, `_CAP_CACHE` `:68`), checks exact key equality and
runs the residual, key packing and `device_group_aggregate` over the pairs
(`pair_tail` `:475`). The port never materialises the pairs.

Build (`join_build`, kernel `csrc/join_build.cu`). The build predicate and
key programs run over the build batch; a row lives when it passes the
predicate and every key has a word: an integer key (dates, decimals and
booleans too) is its int64 value, a float key its float64 bits with -0.0
read as 0.0 and NaN never matching, a string key its dictionary code. The
key words hash (splitmix64 of the first, each further word XORed in and
mixed by splitmix64, the top bit dropped) into nb = next_pow2(live)
buckets; the live rows are laid out in bucket order as a CSR: `start[nb +
1]` (int32: a build holds fewer than 2^31 rows) and each entry's record
`records` ([live, width] int64: the key words, then the payload, the build columns the probe's programs read,
`JoinBuildSpec.payload`, as the interpreter loads them), with `valid`
([live, width] uint8) where a payload column has NULLs. A unique key is a
bucket of one entry: the reference's LUT route needs no second design.

Probe (`join_aggregate`, kernel `csrc/join_aggregate.cu`). Per probe row:
the probe predicate, the probe key words (a string key's probe code
remapped into the build's dictionary by `_remap_lut`'s rule, an absent
string matching nothing), the row's bucket, and each entry with equal key
words is a pair. The pair space is the reference's: build columns
`0..n_build-1`, then probe columns; the build columns are read from the
pair's record (their descriptors point into the records). For each pair
the residual, the packed group key and the lanes run over the pair row,
and the pair folds into the grouped aggregate of `device/groupby.py`
(dense slots or the hash table), whose table `compact_groups`, top-k and
the emit take as they are. On the card a warp probes 32 rows at once and
walks their buckets' entries together, 32 a step.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors, or raises. The plain versions expand the pairs
with `repeat_interleave`, read the build columns from the records and reuse
the grouped fold's plain versions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .groupby import (_DTYPE_CODE, _NP_TO_TORCH, H_OFF_COLS, AggregateSpec,
                      Columns, HashSpec, _check_overflow, _cuda, _next_pow2,
                      _ProgramSpec, _srl, _stream,
                      dense_group_aggregate_plain, hash_group_aggregate_plain,
                      splitmix64)
from .lower import LoweringError, Pools, Program, evaluate

join_build_kernel = kernels.register(kernels.Kernel(
    "join_build", "datafusion_tpu_torch/csrc/join_build.cu",
    "datafusion_tpu/physical/plan/device_join_agg.py:267"))
join_aggregate_kernel = kernels.register(kernels.Kernel(
    "join_aggregate", "datafusion_tpu_torch/csrc/join_aggregate.cu",
    "datafusion_tpu/physical/plan/device_join_agg.py:615"))

# join key kinds (mirrored in csrc/program.cuh)
JK_INT, JK_FLOAT, JK_CODE = range(3)
MAX_JOIN_KEYS = 4

# the join section of a JoinAggSpec descriptor (csrc/join_aggregate.cu)
(J_NBUILD, J_PPRED, J_NKEYS, J_BUCKETS, J_START, J_REC, J_WIDTH, J_LIVE,
 J_KEY0) = range(9)
SCAN_TILE = 8192          # words a block of csrc/scan.cuh scans


def key_kind(t) -> int:
    """The join key kind of a key column of type `t`."""
    if t.is_string:
        return JK_CODE
    return JK_FLOAT if t.is_float else JK_INT


def _check_keys(keys: Sequence[Tuple[Program, int]]) -> None:
    if not 1 <= len(keys) <= MAX_JOIN_KEYS:
        raise LoweringError(f"{len(keys)} join keys")
    for prog, kind in keys:
        if prog.is_float != (kind == JK_FLOAT):
            raise LoweringError("a float join key against a non-float one")


def payload_of(pair_pools: Pools, n_build: int) -> Dict[int, np.dtype]:
    """{build column: dtype} of the build columns (pair-space indices below
    `n_build`) that the pair programs of `pair_pools` read: the payload a
    build table's records carry."""
    return {i: d for i, d in sorted(pair_pools.columns.items())
            if i < n_build}


class JoinBuildSpec(_ProgramSpec):
    """The build predicate and key programs of the build side, over its
    batch's columns, and the payload columns ({index: dtype}, in the same
    index space) whose values each entry's record carries for the probe.
    The kernel reads the keys from the descriptor's key section as
    (program, key kind)."""

    def __init__(self, pools: Pools, pred: Optional[Program],
                 keys: Sequence[Tuple[Program, int]],
                 payload: Optional[Dict[int, np.dtype]] = None):
        _check_keys(keys)
        super().__init__(pools, pred, [], [])
        self.keys = [(prog, kind, 0) for prog, kind in keys]
        self.payload = dict(sorted((payload or {}).items()))
        self.meta = self._layout(0)

    def key_programs(self) -> List[Tuple[Program, int]]:
        return [(p, k) for p, k, _s in self.keys]

    def column_dtype(self, idx: int) -> torch.dtype:
        if idx in self.payload and idx not in self.pools.columns:
            return _NP_TO_TORCH[np.dtype(self.payload[idx])]
        return super().column_dtype(idx)

    def record_words(self) -> Dict[int, int]:
        """{payload column: its word in a record}: after the key words."""
        return {idx: len(self.keys) + j for j, idx in enumerate(self.payload)}


class JoinTable:
    """The staged build side: `nb` buckets (a power of two), `live` entries
    in bucket order, `start` (int32 [nb + 1]: bucket b holds entries
    start[b]..start[b+1]-1) and each entry's record `records` (int64
    [live, width]: the `n_keys` key words,
    then the payload columns at their words `payload` ({column: word})),
    with `valid` (uint8 [live, width], a byte a word) when a payload column
    in `nullable` has NULLs, else None."""

    def __init__(self, nb: int, live: int, start: torch.Tensor,
                 records: torch.Tensor, n_keys: int,
                 payload: Dict[int, int], valid: Optional[torch.Tensor],
                 nullable: Sequence[int] = ()):
        self.nb = int(nb)
        self.live = int(live)
        self.start = start
        self.records = records
        self.n_keys = int(n_keys)
        self.payload = dict(payload)
        self.valid = valid
        self.nullable = set(nullable)

    @property
    def width(self) -> int:
        return self.records.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.start, self.records, self.valid)
                   if t is not None)

    def entries(self) -> Tuple[np.ndarray, ...]:
        """(bucket, records [live, width], validity bytes or None) of
        every entry, ordered by bucket, then by record words, then by
        validity bytes: the multiset each bucket holds."""
        counts = (self.start[1:] - self.start[:-1]).cpu().numpy()
        bucket = np.repeat(np.arange(self.nb), counts)
        rec = self.records.cpu().numpy()
        valid = None if self.valid is None else self.valid.cpu().numpy()
        keys = [bucket] + list(rec.T) + ([] if valid is None
                                         else list(valid.T))
        order = np.lexsort(keys[::-1])
        return (bucket[order], rec[order],
                None if valid is None else valid[order])

    def column(self, idx: int, entry: torch.Tensor, dtype: torch.dtype):
        """(data, validity) of payload column `idx` at the entries
        `entry`, at its dtype, read from the records."""
        word = self.payload.get(idx)
        if word is None:
            raise ValueError(f"build column {idx} is not in the table's "
                             f"records")
        return (_from_word(self.records[entry, word], dtype),
                self.valid[entry, word].bool() if idx in self.nullable
                else None)


def _to_word(data: torch.Tensor) -> torch.Tensor:
    """Column values as the interpreter loads them: int64, or float64
    bits (a float32 widened)."""
    if data.dtype == torch.float32:
        data = data.to(torch.float64)
    if data.dtype == torch.float64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def _from_word(word: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A column of `dtype` from its record words (`_to_word` undone)."""
    if dtype.is_floating_point:
        return word.view(torch.float64).to(dtype)
    if dtype == torch.bool:
        return word != 0
    return word.to(dtype)


def key_words(kind: int, d: torch.Tensor, v: torch.Tensor):
    """(int64 key word, whether the row can match) of one join key's values
    (`join_key_word` in csrc/program.cuh)."""
    if kind == JK_FLOAT:
        d = d.to(torch.float64)
        ok = v & ~d.isnan()
        return torch.where(d == 0, 0.0, d).view(torch.int64), ok
    d = d.to(torch.int64)
    return d, (v & (d >= 0)) if kind == JK_CODE else v


def join_hash(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """The non-negative hash of each row's key words (`join_hash`)."""
    h = splitmix64(words[0])
    for w in words[1:]:
        h = splitmix64(h ^ w)
    return _srl(h, 1)


def _check_build(spec: JoinBuildSpec, cols: Columns, aux: torch.Tensor,
                 n_rows: int) -> None:
    dev = aux.device
    if aux.dtype != torch.int64 or not aux.is_contiguous():
        raise ValueError("aux must be a contiguous int64 tensor")
    if n_rows >= 1 << 31:
        raise ValueError("a build side holds at most 2^31 - 1 rows")
    for idx in sorted(set(spec.pools.columns) | set(spec.payload)):
        if idx not in cols:
            raise ValueError(f"build column {idx} is read but not given")
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


def new_join_table(spec: JoinBuildSpec, cols: Columns, nb: int, live: int,
               dev) -> JoinTable:
    """An empty table of `live` entries: records zeroed, and the validity
    bytes where a payload column has NULLs."""
    words = spec.record_words()
    nullable = [i for i in spec.payload if cols[i][1] is not None]
    width = len(spec.keys) + len(spec.payload)
    return JoinTable(
        nb, live, torch.zeros(nb + 1, dtype=torch.int32, device=dev),
        torch.zeros((live, width), dtype=torch.int64, device=dev),
        len(spec.keys), words,
        torch.zeros((live, width), dtype=torch.uint8, device=dev)
        if nullable else None, nullable)


def payload_columns(table: JoinTable, cols: Columns) -> torch.Tensor:
    """The scatter kernel's payload descriptors (host int64, four words a
    column): data and validity addresses (0: none), dtype code, and the
    column's word in a record."""
    return torch.tensor(
        [w for idx, word in table.payload.items()
         for w in (cols[idx][0].data_ptr(),
                   0 if cols[idx][1] is None else cols[idx][1].data_ptr(),
                   _DTYPE_CODE[cols[idx][0].dtype], word)],
        dtype=torch.int64)


def join_build(spec: JoinBuildSpec, cols: Columns, aux: torch.Tensor,
               n_rows: int) -> JoinTable:
    """Stage the first `n_rows` rows of `cols` as the join's multi-map,
    each entry's record carrying its key words and the payload columns
    `spec.payload` of `cols`.

    On CPU tensors this runs `join_build_plain`; on CUDA tensors it
    launches the `join_build` kernels (hash, count, the scan's three,
    scatter) or raises. It reads the live row count back to size the
    buckets: one synchronisation."""
    _check_build(spec, cols, aux, n_rows)
    dev = aux.device
    if not _cuda(aux):
        return join_build_plain(spec, cols, aux, n_rows)
    n_keys = len(spec.keys)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        live_d = torch.zeros(1, dtype=torch.int64, device=dev)
        hashes = torch.empty(max(n_rows, 1), dtype=torch.int64, device=dev)
        words = torch.empty(max(n_keys * n_rows, 1), dtype=torch.int64,
                            device=dev)
        if n_rows:
            meta_d = spec.device_meta(cols, dev)
            kernels.check(lib.dft_join_build_hash(
                meta_d.data_ptr(), len(spec.meta), aux.data_ptr(), n_rows,
                hashes.data_ptr(), words.data_ptr(), live_d.data_ptr(),
                int(spec.full), stream), join_build_kernel)
            join_build_kernel.launches += 1
        live = int(live_d.item())
        nb = _next_pow2(max(live, 1))
        table = new_join_table(spec, cols, nb, live, dev)
        if live:
            start = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
            sums = torch.empty(-(-(nb + 1) // SCAN_TILE), dtype=torch.int64,
                               device=dev)
            kernels.check(lib.dft_join_build_offsets(
                hashes.data_ptr(), n_rows, nb, start.data_ptr(),
                sums.data_ptr(), stream), join_build_kernel)
            cursor = torch.zeros(nb, dtype=torch.int64, device=dev)
            pay = payload_columns(table, cols).to(dev)
            kernels.check(lib.dft_join_build_scatter(
                hashes.data_ptr(), words.data_ptr(), n_keys, n_rows, nb,
                start.data_ptr(), cursor.data_ptr(), pay.data_ptr(),
                len(table.payload), table.width, table.start.data_ptr(),
                table.records.data_ptr(),
                None if table.valid is None else table.valid.data_ptr(),
                stream), join_build_kernel)
            join_build_kernel.launches += 5   # count, the scan's three, scatter
    return table


def join_build_plain(spec: JoinBuildSpec, cols: Columns, aux: torch.Tensor,
                     n_rows: int) -> JoinTable:
    """The plain PyTorch version: the programs interpreted over whole
    tensors, the hashes as the kernel computes them, the live rows sorted
    by (bucket, row), the bucket starts by `bincount` and `cumsum`, and the
    records by indexing."""
    dev = aux.device
    n = n_rows
    live = torch.ones(n, dtype=torch.bool, device=dev)
    if spec.pred is not None:
        d, v = evaluate(spec.pred, cols, aux, n)
        live &= (d != 0) & v
    words = []
    for prog, kind in spec.key_programs():
        d, v = evaluate(prog, cols, aux, n)
        w, ok = key_words(kind, d, v)
        live &= ok
        words.append(w)
    ids = live.nonzero().squeeze(1)
    n_live = ids.numel()
    nb = _next_pow2(max(n_live, 1))
    table = new_join_table(spec, cols, nb, n_live, dev)
    if n_live == 0:
        return table
    words = [w[ids] for w in words]
    bucket = join_hash(words) & (nb - 1)
    order = torch.argsort(bucket * (1 << 31) + ids)
    at = ids[order]
    table.start[1:] = torch.cumsum(torch.bincount(bucket, minlength=nb), 0)
    for k, w in enumerate(words):
        table.records[:, k] = w[order]
    for idx, word in table.payload.items():
        data, valid = cols[idx]
        table.records[:, word] = _to_word(data[:n])[at]
        if valid is not None:
            table.valid[:, word] = valid[at].to(torch.uint8)
    return table


# --- the probe ----------------------------------------------------------------

class Join:
    """The probe side of a join-aggregate: the number of build columns at
    the start of the pair space, the probe predicate and the probe key
    programs (with their key kinds) over the pair space, and the staged
    build table."""

    def __init__(self, n_build: int, ppred: Optional[Program],
                 probe_keys: Sequence[Tuple[Program, int]],
                 table: JoinTable):
        _check_keys(probe_keys)
        if len(probe_keys) != table.n_keys:
            raise ValueError("one probe key per build key")
        self.n_build = int(n_build)
        self.ppred = ppred
        self.probe_keys = list(probe_keys)
        self.table = table

    def programs(self) -> List[Program]:
        out = [self.ppred] if self.ppred is not None else []
        return out + [p for p, _k in self.probe_keys]

    def section(self, index: Dict[int, int]) -> np.ndarray:
        t = self.table
        head = [self.n_build,
                -1 if self.ppred is None else index[id(self.ppred)],
                len(self.probe_keys), t.nb, t.start.data_ptr(),
                t.records.data_ptr(), t.width, t.live]
        keys = [w for p, k in self.probe_keys for w in (index[id(p)], k)]
        return np.asarray(head + keys, np.int64)


class _JoinSpec:
    """A grouped fold (dense or hash) whose rows are the pairs of a join:
    the join's programs join the descriptor's program list, and its
    section follows the lanes."""

    def _init_join(self, join: Join):
        self.join = join

    def _pass_programs(self, lanes) -> List[Program]:
        return super()._pass_programs(lanes) + self.join.programs()

    def _chain_section(self, index: Dict[int, int]) -> np.ndarray:
        return self.join.section(index)

    def _patch_columns(self, meta: np.ndarray) -> None:
        """The build columns load from the pair's record (the loader's row
        handle is entry x width): each an int64 column at its word of
        record 0, its validity at the records' validity bytes."""
        t = self.join.table
        base = int(meta[H_OFF_COLS])
        for idx in self.pools.columns:
            if idx >= self.join.n_build:
                continue
            word = t.payload.get(idx)
            if word is None:
                raise ValueError(f"build column {idx} is not in the "
                                 f"table's records")
            meta[base + 3 * idx:base + 3 * idx + 3] = [
                t.records.data_ptr() + 8 * word,
                t.valid.data_ptr() + word if idx in t.nullable else 0,
                _DTYPE_CODE[torch.int64]]


class JoinDenseSpec(_JoinSpec, AggregateSpec):
    def __init__(self, pools, pred, keys, lanes, join: Join):
        self._init_join(join)
        super().__init__(pools, pred, keys, lanes)


class JoinHashSpec(_JoinSpec, HashSpec):
    def __init__(self, pools, pred, keys, lanes, rows: int, join: Join):
        self._init_join(join)
        super().__init__(pools, pred, keys, lanes, rows)


def _check_pair(spec, cols: Columns, aux: torch.Tensor, n_probe: int,
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
    t = spec.join.table
    for x in (t.start, t.records):
        if x.device != dev:
            raise ValueError("the build table lies on another device")
    for idx in spec.pools.columns:
        if idx < spec.join.n_build:   # read from the build table's records
            if idx not in t.payload:
                raise ValueError(f"build column {idx} is not in the "
                                 f"table's records")
            continue
        if idx not in cols:
            raise ValueError(f"column {idx} is read but not given")
        data, valid = cols[idx]
        if data.device != dev or not data.is_contiguous() or \
                data.dim() != 1 or data.dtype != spec.column_dtype(idx):
            raise ValueError(f"column {idx}: contiguous 1-D "
                             f"{spec.column_dtype(idx)} on {dev} expected")
        if data.shape[0] < n_probe:
            raise ValueError(f"probe column {idx} shorter than {n_probe} rows")
        if valid is not None and (valid.device != dev or
                                  valid.dtype != torch.bool or
                                  valid.shape[0] < data.shape[0]):
            raise ValueError(f"column {idx}: bad validity")


def join_aggregate(spec, cols: Columns, aux: torch.Tensor, n_probe: int,
                   table: torch.Tensor,
                   overflow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Probe the join's build table with the first `n_probe` probe rows and
    fold every pair into `table` in place: a dense `[lanes + 1, G]` table
    for a JoinDenseSpec, a hash table `[lanes + 2, cap]` and its int32
    `overflow` flag for a JoinHashSpec. `cols` maps pair-space indices to
    (data, validity): the probe columns of the batch (build columns come
    from the table's records; any given are not read).

    On CPU tensors this runs `join_aggregate_plain`; on CUDA tensors it
    launches the `join_aggregate` kernel once a pass of lanes, or raises."""
    _check_pair(spec, cols, aux, n_probe, table)
    dense = isinstance(spec, AggregateSpec)
    if not dense:
        if overflow is None:
            raise ValueError("a hash fold needs its overflow flag")
        _check_overflow(overflow, table.device)
    if spec.distinct_lanes:
        raise ValueError("the join-aggregate has no distinct lane")
    if not _cuda(table):
        return join_aggregate_plain(spec, cols, aux, n_probe, table,
                                    overflow)
    if n_probe == 0 or spec.join.table.live == 0:
        return table
    lib = kernels.library()
    with torch.cuda.device(table.device):
        for meta, (_at, lanes) in zip(spec.metas, spec.passes):
            meta_d = spec.device_meta(cols, table.device, meta)
            rc = lib.dft_join_aggregate(
                meta_d.data_ptr(), len(meta), len(lanes),
                spec.groups if dense else 0, aux.data_ptr(), n_probe,
                0 if dense else spec.cap,
                0 if dense else (1 if spec.identity_slots else 2),
                table.data_ptr(), None if dense else overflow.data_ptr(),
                int(spec.full), _stream(table.device))
            kernels.check(rc, join_aggregate_kernel)
            join_aggregate_kernel.launches += 1
    return table


def join_pairs_plain(spec, cols: Columns, aux: torch.Tensor, n_probe: int):
    """(probe row, entry) of every pair: the probe predicate and key words
    over the probe rows, each row's bucket range expanded with
    `repeat_interleave`, the entries with equal key words kept."""
    j, t = spec.join, spec.join.table
    dev = aux.device
    n = n_probe
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    if j.ppred is not None:
        d, v = evaluate(j.ppred, cols, aux, n)
        ok &= (d != 0) & v
    words = []
    for prog, kind in j.probe_keys:
        d, v = evaluate(prog, cols, aux, n)
        w, good = key_words(kind, d, v)
        ok &= good
        words.append(w)
    b = join_hash(words) & (t.nb - 1)
    start = t.start.to(torch.int64)
    lo = start[b]
    cnt = torch.where(ok, start[b + 1] - lo, 0)
    prow = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    e = lo[prow] + torch.arange(prow.numel(), device=dev) - first[prow]
    match = torch.ones_like(prow, dtype=torch.bool)
    for k, w in enumerate(words):
        match &= t.records[e, k] == w[prow]
    return prow[match], e[match]


def join_aggregate_plain(spec, cols: Columns, aux: torch.Tensor,
                         n_probe: int, table: torch.Tensor,
                         overflow: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The plain PyTorch version: the pairs (`join_pairs_plain`), every
    pair-space column gathered at its side's row (a build column from the
    pair's record), then the grouped fold's plain version over the pairs
    (the residual is its predicate)."""
    if n_probe == 0 or spec.join.table.live == 0:
        return table
    prow, entry = join_pairs_plain(spec, cols, aux, n_probe)
    t = spec.join.table
    pair = {}
    for idx in spec.pools.columns:
        if idx < spec.join.n_build:
            pair[idx] = t.column(idx, entry, spec.column_dtype(idx))
        else:
            data, valid = cols[idx]
            pair[idx] = (data[prow], None if valid is None else valid[prow])
    m = prow.numel()
    if isinstance(spec, AggregateSpec):
        return dense_group_aggregate_plain(spec, pair, aux, m, table)
    return hash_group_aggregate_plain(spec, pair, aux, m, table, overflow)
