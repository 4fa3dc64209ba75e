"""A numpy replay of the aggregate's hash fold (`csrc/program.cuh`
`hash_fold_warps`, `cache_entry`, `cache_merge`) for warps of 32 lanes,
which the one-thread build of `test_torch_csrc_cpu.py` cannot exercise:
there a warp has one lane and never meets a peer.

The model runs the kernel's arithmetic a warp step at a time, with the CUDA
intrinsics at their warp-wide meaning (`test_torch_join_walk`'s `shfl`,
`ballot`, `match_any`, `popc`, `ffs`): the rows of a step find their peers
by their packed key, the lowest admitted peer counts them by a popcount and
finds the group in its block's cache (a Fibonacci hash, kCacheProbes
linear probes, a claim of an EMPTY entry) or in the table (the key itself
in identity mode, writing the key word when the count was 0; linear
probing from splitmix64 otherwise), each lane reduces over the peers (a
ballot for counts, the `reduce_peers` tree for the rest) and the lowest
peer folds once; a row not admitted is a set of its own. A block stops
matching once its match debt reaches kMatchGiveUp (each step adds 1, each
row that joins another's set takes 2), and every row is then a set of its
own. It stops probing its cache once its debt reaches kCacheGiveUp (each set that claims
an entry or misses adds 1, each that hits takes kCacheHitCredit); every
block's cache is merged into the table at the end. The warps of a block
take their steps in turns, as warps on one SM interleave. The table that comes out is
held to `hash_group_aggregate_plain`'s, group by group.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_join_walk import LANE, W, ballot, ffs, match_any, popc, shfl

CPU = torch.device("cpu")
_CUH = (Path(__file__).resolve().parent.parent / "datafusion_tpu_torch" /
        "csrc" / "program.cuh").read_text()
PROBES = int(re.search(r"kCacheProbes = (\d+);", _CUH).group(1))
GIVE_UP = int(re.search(r"kCacheGiveUp = (\d+);", _CUH).group(1))
CREDIT = int(re.search(r"kCacheHitCredit = (\d+);", _CUH).group(1))
MATCH_GIVE_UP = int(re.search(r"kMatchGiveUp = (\d+);", _CUH).group(1))
M64 = (1 << 64) - 1


def splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


# --- lane arithmetic: values in numpy arrays of the lane's type ---------------

def _kinds():
    from datafusion_tpu_torch.device import groupby as G
    return G


def _dtype(kind):
    G = _kinds()
    if kind == G.LANE_SUM_F32:
        return np.float32
    if kind in (G.LANE_SUM_F64, G.LANE_MIN_F64, G.LANE_MAX_F64):
        return np.float64
    return np.int64


def _identity(kind):
    G = _kinds()
    return {G.LANE_MIN_I64: np.iinfo(np.int64).max,
            G.LANE_MAX_I64: np.iinfo(np.int64).min,
            G.LANE_MIN_F64: np.inf, G.LANE_MAX_F64: -np.inf}.get(kind, 0)


def _combine(kind, a, b):
    G = _kinds()
    if kind in (G.LANE_MIN_I64, G.LANE_MIN_F64):
        return np.where(b < a, b, a)
    if kind in (G.LANE_MAX_I64, G.LANE_MAX_F64):
        return np.where(b > a, b, a)
    with np.errstate(over="ignore"):
        return a + b           # int64 wraps; float32 adds in float32


def _counts_kind(kind):
    G = _kinds()
    return kind in (G.LANE_ROWS, G.LANE_CNT, G.LANE_NANCNT) + \
        G._DISTINCT_LANES


def reduce_peers(kind, peers, x):
    """`reduce_peers` with the lane kind's combine: each set's value in its
    lowest lane."""
    x = np.asarray(x).copy()
    peers = np.asarray(peers, np.int64) & 0xFFFFFFFF
    rank = popc(peers & ((1 << LANE) - 1))
    peers = peers & ~((2 << LANE) - 1) & 0xFFFFFFFF
    while (peers != 0).any():
        nxt = ffs(peers)
        t = shfl(x, (nxt - 1) & 31)
        x = np.where(nxt != 0, _combine(kind, x, t), x)
        peers = peers & ~ballot((rank & 1) == 1)
        rank = rank >> 1
    return x


class Cells:
    """An int64 table `[rows][cols]` (float lanes hold float64 bits, SUM_F32
    lanes a float32 in the low word) read and folded by lane kind."""

    def __init__(self, words):
        self.w = words

    def get(self, r, c, kind):
        G = _kinds()
        if kind == G.LANE_SUM_F32:
            return self.w[r].view(np.float32)[2 * c]
        if _dtype(kind) == np.float64:
            return self.w[r].view(np.float64)[c]
        return self.w[r, c]

    def fold(self, r, c, kind, v):
        G = _kinds()
        if kind == G.LANE_SUM_F32:
            row = self.w[r].view(np.float32)
            row[2 * c] = _combine(kind, row[2 * c], np.float32(v))
        elif _dtype(kind) == np.float64:
            row = self.w[r].view(np.float64)
            row[c] = _combine(kind, row[c], np.float64(v))
        else:
            self.w[r, c] = _combine(kind, self.w[r, c], np.int64(v))


# --- the kernel, a pass at a time ---------------------------------------------

class Fold:
    """The table of one spec and the statistics of the replay."""

    def __init__(self, spec, table):
        self.spec = spec
        self.t = Cells(table)
        self.overflow = False
        self.cap = spec.cap
        self.pairs = set()        # the distinct set: (group word, value)
        self.gave_up = 0          # blocks that stopped probing their cache
        self.unmatched = 0        # blocks that stopped matching peers
        self.cache_rows = 0       # rows folded through a cache

    def slot(self, key):
        """`group_slot`: the key, or its probed and claimed slot."""
        if self.spec.identity_slots:
            return key
        keys = self.t.w[0]
        h = splitmix64(key) & (self.cap - 1)
        for _ in range(self.cap):
            if keys[h] == key:
                return h
            if keys[h] == -1:
                keys[h] = key
                return h
            h = (h + 1) & (self.cap - 1)
        return -1

    def count_rows(self, lane0, slot, key, n):
        if lane0 != 0:
            return
        old = self.t.w[1, slot]
        self.t.w[1, slot] = old + n
        if self.spec.identity_slots and old == 0:
            self.t.w[0, slot] = key


def cache_entry(keys, key):
    """(entry or -1, whether the call claimed it)."""
    mask = len(keys) - 1
    e = (((key * 0x9E3779B97F4A7C15) & M64) >> 40) & mask
    for _ in range(PROBES):
        if keys[e] == key:
            return e, False
        if keys[e] == -1:
            keys[e] = key
            return e, True
        e = (e + 1) & mask
    return -1, True


def lane_inputs(spec, cols, aux, n, lanes):
    """Each lane's (valid, value) a row: what `lane_value` reads before its
    kind's rules."""
    from datafusion_tpu_torch.device.lower import evaluate
    out = []
    for prog, _kind in lanes:
        if prog is None:
            out.append((np.ones(n, bool), np.ones(n, np.int64)))
            continue
        d, v = evaluate(prog, cols, aux, n)
        out.append((v.numpy(), d.numpy()))
    return out


def lane_value(fold, kind, l, lane0, valid, d, slot):
    """`lane_value` for the rows of a step: (adds, value)."""
    G = _kinds()
    if kind in (G.LANE_ROWS, G.LANE_CNT):
        return valid, np.ones(len(valid), np.int64)
    if kind == G.LANE_NANCNT:
        return valid & np.isnan(d), np.ones(len(valid), np.int64)
    if kind in (G.LANE_MIN_F64, G.LANE_MAX_F64):
        return valid & ~np.isnan(d), d.astype(np.float64)
    if kind in G._DISTINCT_LANES:
        adds = np.zeros(len(valid), bool)
        for i in np.flatnonzero(valid):
            v = d[i]
            if kind == G.LANE_DISTINCT_F64:
                v = 0 if v == 0 else int(np.float64(v).view(np.int64))
            pair = ((int(slot[i]) << 12) | (lane0 + l), int(v))
            if pair not in fold.pairs:
                fold.pairs.add(pair)
                adds[i] = True
        return adds, np.ones(len(valid), np.int64)
    return valid, d.astype(_dtype(kind))


def run_pass(fold, spec, cols, aux, n, at, lanes, entries, blocks, per_block):
    from datafusion_tpu_torch.device.groupby import _rows_and_keys
    G = _kinds()
    row_valid, packed = (t.numpy() for t in _rows_and_keys(spec, cols, aux, n))
    inputs = lane_inputs(spec, cols, aux, n, lanes)
    kinds = [k for _p, k in lanes]
    distinct = any(k in G._DISTINCT_LANES for k in kinds)
    if distinct:      # the launch wrapper gives such a pass no cache
        entries = 0
    lane0, L, cap = at, len(lanes), fold.cap
    caches = []
    for _b in range(blocks):
        c = np.zeros((L + 2, entries), np.int64)
        c[0] = -1
        for i, k in enumerate(kinds):
            c[2 + i] = np.array([_identity(k)], _dtype(k)).view(np.int64)[0] \
                if _dtype(k) != np.float32 else 0
        caches.append(Cells(c))
    warps = blocks * per_block
    debt = [0 if entries > 0 else GIVE_UP] * blocks   # each block's
    unmatched = [0] * blocks
    steps = (n + warps * W - 1) // (warps * W)
    for s in range(steps):
        for w in range(warps):
            cache = caches[w // per_block]
            rows = (w + s * warps) * W + LANE
            inb = rows < n
            r = np.minimum(rows, n - 1)
            adm = inb & row_valid[r]
            key = np.where(adm, packed[r], -1)
            bad = adm & ((key < 0) | (spec.identity_slots & (key >= cap)))
            fold.overflow |= bool(bad.any())
            adm &= ~bad
            key = np.where(adm, key, -1)
            if not adm.any():
                continue
            b = w // per_block
            peers = 1 << LANE
            if unmatched[b] < MATCH_GIVE_UP:
                peers = np.where(adm, match_any(key), peers)
                joined = int(adm.sum()) - int(
                    (adm & (LANE == ffs(peers) - 1)).sum())
                unmatched[b] += 1 - 2 * joined
                fold.unmatched += unmatched[b] >= MATCH_GIVE_UP
            first = ffs(peers) - 1
            cached = debt[b] < GIVE_UP
            owes = 0
            lead = adm & (LANE == first)
            where = np.zeros(W, np.int64)
            e = np.full(W, -1)
            slot = np.full(W, -1)
            for ln in np.flatnonzero(lead):
                k, cnt = int(key[ln]), int(popc(peers[ln])[0])
                fresh = True
                if cached:
                    e[ln], fresh = cache_entry(cache.w[0], k)
                owes += 1 if fresh else -CREDIT
                if e[ln] >= 0:
                    if lane0 == 0:
                        cache.w[1, e[ln]] += cnt
                    where[ln] = 1
                    continue
                slot[ln] = fold.slot(k)
                if slot[ln] < 0:
                    fold.overflow = True
                    continue
                fold.count_rows(lane0, slot[ln], k, cnt)
                where[ln] = 2
            where = shfl(where, first)
            slot = shfl(slot, first)
            if cached:
                debt[b] += owes
                fold.gave_up += debt[b] >= GIVE_UP
            fold.cache_rows += int((where == 1).sum())
            live = where != 0
            for l, kind in enumerate(kinds):
                valid, d = inputs[l]
                adds, x = lane_value(fold, kind, l, lane0, live & valid[r],
                                     d[r], slot)
                x = np.where(adds, x, np.array(_identity(kind), x.dtype))
                if _counts_kind(kind):
                    red = popc(ballot(x != 0) & peers)
                else:
                    red = reduce_peers(kind, peers, x)
                for ln in np.flatnonzero(lead):
                    if red[ln] == _identity(kind):
                        continue
                    if where[ln] == 1:
                        cache.fold(l + 2, e[ln], kind, red[ln])
                    elif where[ln] == 2:
                        fold.t.fold(l + 2 + lane0, slot[ln], kind, red[ln])
    for cache in caches:          # cache_merge
        for ent in np.flatnonzero(cache.w[0] != -1):
            k = int(cache.w[0, ent])
            sl = fold.slot(k)
            if sl < 0:
                fold.overflow = True
                continue
            fold.count_rows(lane0, sl, k, int(cache.w[1, ent]))
            for l, kind in enumerate(kinds):
                v = cache.get(l + 2, ent, kind)
                if v != _identity(kind):
                    fold.t.fold(l + 2 + lane0, sl, kind, v)


def replay(spec, cols, aux, n, entries, blocks, per_block):
    """The kernel's table after one launch a pass, and its statistics."""
    fold = Fold(spec, spec.new_table(CPU).numpy().copy())
    for at, lanes in spec.passes:
        run_pass(fold, spec, cols, aux, n, at, lanes, entries, blocks,
                 per_block)
    return fold


# --- the cases ----------------------------------------------------------------

def _batch(x, seed):
    """A key x beside a float64 v (NULLs, NaNs), an int64 i, a float32 f,
    a low-cardinality int64 u and a predicate b."""
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.batch import Batch
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.common.schema import Field, Schema
    rng = np.random.default_rng(seed)
    n = len(x)
    v = rng.normal(size=n) * 100
    v[rng.random(n) < 0.03] = np.nan
    cols = [("x", Column(dt.INT64, np.asarray(x, np.int64))),
            ("v", Column(dt.FLOAT64, v, rng.random(n) > 0.05)),
            ("i", Column(dt.INT64, rng.integers(-10**12, 10**12, n))),
            ("f", Column(dt.FLOAT32, (rng.normal(size=n) * 10)
                         .astype(np.float32))),
            ("u", Column(dt.INT64, rng.integers(0, 7, n))),
            ("b", Column(dt.BOOL, rng.random(n) < 0.6))]
    schema = Schema([Field(nm, c.dtype, nm == "v") for nm, c in cols])
    return Batch(schema, [c for _n, c in cols], n)


LANES = ("count(*), count(v), sum(v), min(v), max(v), sum(i), min(i), "
         "max(i), sum(f)")


def _keys(case, n, rng):
    if case == "one_key":
        return np.full(n, 7)
    if case == "uniform":
        return rng.integers(0, 3000, n)
    if case == "sorted":
        return np.sort(rng.integers(0, n // 4, n))
    return rng.zipf(1.3, n) % 3000


# (name, keys, query, key bits forced or None, rows, cache entries,
# blocks, warps a block)
CASES = [
    ("one key", "one_key", f"SELECT x, {LANES} FROM t GROUP BY x", 12,
     4096, 64, 2, 2),
    ("one key, hashed", "one_key", f"SELECT x, {LANES} FROM t GROUP BY x",
     40, 4096, 64, 2, 2),
    ("zipf", "zipf", f"SELECT x, {LANES} FROM t GROUP BY x", None, 8192,
     64, 2, 2),
    ("zipf, hashed", "zipf", f"SELECT x, {LANES} FROM t GROUP BY x", 40,
     8192, 64, 2, 2),
    ("more keys than entries", "uniform",
     f"SELECT x, {LANES} FROM t GROUP BY x", None, 8192, 16, 1, 2),
    ("one entry", "zipf", f"SELECT x, {LANES} FROM t GROUP BY x", None,
     4096, 1, 2, 2),
    ("sorted", "sorted", f"SELECT x, {LANES} FROM t GROUP BY x", None, 4096,
     64, 2, 2),
    ("inadmissible peers", "zipf",
     f"SELECT x, {LANES} FROM t WHERE b GROUP BY x", None, 4096, 64, 2, 2),
    ("40 lanes, two passes", "zipf", "SELECT x, count(*), " +
     ", ".join(f"sum(i + {k})" for k in range(38)) + " FROM t GROUP BY x",
     None, 2048, 16, 2, 2),
    ("distinct", "zipf", "SELECT x, count(DISTINCT u), sum(i), count(*) "
     "FROM t GROUP BY x", None, 4096, 64, 2, 2),
]


def _spec(batch, sql, bits):
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import HashSpec
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    ctx = dft.SessionContext(CPU)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = ctx.sql(sql).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    if bits is not None:
        spec = HashSpec(spec.pools, spec.pred,
                        [(p, o, bits) for p, o, _s in spec.keys], spec.lanes,
                        src.num_rows)
    assert isinstance(spec, HashSpec)
    cols, aux = node.stage(spec, src)
    return spec, cols, aux, src.num_rows


def _groups(spec, table):
    """{key: (count, lane values)} of a `[lanes + 2, slots]` int64 table."""
    cells = Cells(table)
    out = {}
    for s in np.flatnonzero(table[0] != -1):
        out[int(table[0, s])] = (int(table[1, s]), [
            cells.get(2 + i, s, k) for i, (_p, k) in enumerate(spec.lanes)])
    return out


@pytest.mark.parametrize("name,keys,sql,bits,n,entries,blocks,per_block",
                         CASES, ids=[c[0] for c in CASES])
def test_replay_matches_plain(name, keys, sql, bits, n, entries, blocks,
                              per_block):
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F32, LANE_SUM_F64, hash_group_aggregate_plain)
    rng = np.random.default_rng(len(name))
    spec, cols, aux, n = _spec(_batch(_keys(keys, n, rng), 3), sql, bits)
    if bits is not None:
        assert spec.identity_slots == (bits < 40)
    fold = replay(spec, cols, aux, n, entries, blocks, per_block)
    want = spec.new_table(CPU)
    dset = spec.distinct_set(n, CPU)
    hash_group_aggregate_plain(spec, cols, aux, n, want,
                               torch.zeros(1, dtype=torch.int32), dset=dset)
    assert not fold.overflow
    g, w = _groups(spec, fold.t.w), _groups(spec, want.numpy())
    assert g.keys() == w.keys() and g
    for key, (count, lanes) in g.items():
        assert count == w[key][0], key
        for (_p, kind), a, b in zip(spec.lanes, lanes, w[key][1]):
            if kind == LANE_SUM_F64:
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True)
            elif kind == LANE_SUM_F32:
                # float32 sums in another order: within a few ulps of the
                # largest partial sum
                assert a == pytest.approx(b, rel=1e-5, abs=1e-3)
            else:
                assert a == b, (key, kind)
    # what each case is there to exercise
    if name == "more keys than entries":
        assert fold.gave_up == blocks and fold.unmatched == blocks
    if name in ("one key", "zipf", "sorted"):
        assert fold.unmatched == 0
    if name in ("one key", "zipf", "40 lanes, two passes"):
        assert fold.cache_rows > n // 4
    if name == "one entry":
        assert 0 < fold.cache_rows < n // 2
    if name == "distinct":
        assert fold.cache_rows == 0 and fold.pairs
