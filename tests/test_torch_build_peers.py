"""A numpy replay of the chain build's insert (`csrc/chain_build.cu`
`chain_build_insert_kernel`) for warps of 32 lanes, which the one-thread
build of `test_torch_csrc_cpu.py` cannot exercise: there a warp has one
lane and never meets a peer.

The model runs the kernel a warp step at a time, with the CUDA intrinsics
at their warp-wide meaning (`test_torch_join_walk`'s `ballot`, `match_any`,
`popc`, `ffs`): the 32 consecutive rows of a step find their peers by
their packed key; the lowest admitted peer inserts for the set (a CAS from
-1 on a direct INNER table, a plain store of its row on a direct SEMI/ANTI
table, a linear-probe claim from splitmix64 on a hashed one); a set of two
or more, or a CAS or claim that finds the key there, marks an INNER
build's duplicate; a min/max build's member values reduce over the set
(`test_torch_hash_fold.reduce_peers`, the kernel's tree) before one min
and one max. A row not admitted is a set of its own. A block stops
matching once its match debt reaches kMatchGiveUp (each step adds 1, each
row that joins another's set takes 2), and every row then inserts for
itself. The warps of a block take their steps in turns. The table that
comes out is held to `chain_build_plain`'s key by key: the same keys,
extremes and duplicate flag, an INNER build of unique keys the same row,
and every other build a row of that key.
"""
import numpy as np
import pytest
import torch

from test_torch_hash_fold import MATCH_GIVE_UP, reduce_peers, splitmix64
from test_torch_join_walk import LANE, W, ffs, match_any, popc

CPU = torch.device("cpu")
I64_MAX, I64_MIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min


def _spec(n, keys, member=None, valid=None, wide=False, pred=True):
    """A BuildSpec over an int64 key column (NULLs where not `valid`), a
    filter column `f < 60` and, with `member`, a min/max member column
    with NULLs; and its columns on the CPU."""
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column, to_device
    from datafusion_tpu_torch.common.scalar import ScalarValue
    from datafusion_tpu_torch.device.join_chain import BuildSpec
    from datafusion_tpu_torch.device.lower import Pools, compile_expr
    from datafusion_tpu_torch.expr.operator import Op
    from datafusion_tpu_torch.physical.expressions import (
        BinaryPhysExpr, ColumnExpr, LiteralExpr)
    rng = np.random.default_rng(n)
    k = keys * ((1 << 30) + 1) if wide else keys
    f = rng.integers(0, 100, n).astype(np.int32)
    cols_h = [Column(dt.INT64, k, valid), Column(dt.INT32, f)]
    if member is not None:
        cols_h.append(Column(dt.INT64, member, rng.random(n) > 0.1))
    pools = Pools()
    p = compile_expr(BinaryPhysExpr(
        ColumnExpr(1, "f", dt.INT32), Op.LT,
        LiteralExpr(ScalarValue(dt.INT32, 60)), dt.BOOL), pools) \
        if pred else None
    spec = BuildSpec(pools, p, [compile_expr(ColumnExpr(0, "k", dt.INT64),
                                             pools)],
                     compile_expr(ColumnExpr(2, "m", dt.INT64), pools)
                     if member is not None else None)
    cols = {i: to_device(cols_h[i], CPU) for i in pools.columns}
    return spec, cols, torch.zeros(0, dtype=torch.int64)


def _admitted(spec, cols, aux, n, table):
    """Each row's admission, packed key and member value, as the kernel's
    `build_keys` finds them."""
    from datafusion_tpu_torch.device.lower import evaluate
    adm = np.ones(n, bool)
    if spec.pred is not None:
        d, v = evaluate(spec.pred, cols, aux, n)
        adm &= (d.numpy() != 0) & v.numpy()
    packed = np.zeros(n, np.int64)
    for prog, lo, shift in zip(spec.key_programs(), table.los, table.shifts):
        d, v = evaluate(prog, cols, aux, n)
        adm &= v.numpy()
        packed |= (d.numpy() - lo) << shift
    member = np.zeros(n, np.int64)
    if spec.member is not None:
        d, v = evaluate(spec.member, cols, aux, n)
        adm &= v.numpy()
        member = d.numpy()
    return adm, packed, member


class Insert:
    """The insert pass's table, flag and statistics."""

    def __init__(self, table, unique, mmx):
        from datafusion_tpu_torch.device.join_chain import TAB_HASH
        self.hashed = table.kind == TAB_HASH
        self.size = table.size
        self.rows = np.full(self.size, -1, np.int64)
        self.keys = np.full(self.size, -1, np.int64) if self.hashed else None
        self.mn = np.full(self.size, I64_MAX) if mmx else None
        self.mx = np.full(self.size, I64_MIN) if mmx else None
        self.dup = 0 if unique else None
        self.stopped = 0          # blocks that stopped matching
        self.sets = 0             # inserts made

    def claim(self, key):
        """`claim_slot`: (slot, fresh)."""
        h = splitmix64(key) & (self.size - 1)
        for _ in range(self.size):
            if self.keys[h] == key:
                return h, False
            if self.keys[h] == -1:
                self.keys[h] = key
                return h, True
            h = (h + 1) & (self.size - 1)
        return -1, False

    def insert(self, row, key, n_peers, lo, hi):
        """The lowest peer's insert for its set."""
        self.sets += 1
        if self.dup is not None and n_peers > 1:
            self.dup = 1
        slot = key
        if not self.hashed:
            if self.dup is None:
                self.rows[key] = row
            elif self.rows[key] == -1:
                self.rows[key] = row
            else:
                self.dup = 1
        else:
            slot, fresh = self.claim(key)
            if fresh:
                self.rows[slot] = row
            elif self.dup is not None:
                self.dup = 1
        if self.mn is not None:
            self.mn[slot] = min(self.mn[slot], lo)
            self.mx[slot] = max(self.mx[slot], hi)


def replay(spec, cols, aux, n, table, unique, blocks=3, per_block=2):
    """The kernel's insert pass over a table laid out as `table` (the
    plain version's), one launch of `blocks` x `per_block` warps."""
    from datafusion_tpu_torch.device.groupby import LANE_MAX_I64, LANE_MIN_I64
    adm_all, packed, member = _admitted(spec, cols, aux, n, table)
    out = Insert(table, unique, spec.member is not None)
    warps = blocks * per_block
    unmatched = [0] * blocks
    steps = (n + warps * W - 1) // (warps * W)
    for s in range(steps):
        for w in range(warps):
            b = w // per_block
            rows = (w + s * warps) * W + LANE
            r = np.minimum(rows, n - 1)
            adm = (rows < n) & adm_all[r]
            if not adm.any():
                continue
            key = np.where(adm, packed[r], -1)
            peers = np.zeros(W, np.int64)
            if unmatched[b] < MATCH_GIVE_UP:
                peers = np.where(adm, match_any(key), 1 << LANE)
                joined = int(adm.sum()) - int(
                    (adm & (LANE == ffs(peers) - 1)).sum())
                unmatched[b] += 1 - 2 * joined
                out.stopped += unmatched[b] >= MATCH_GIVE_UP
                if joined == 0:
                    peers = np.zeros(W, np.int64)
            lo = hi = member[r]
            if out.mn is not None and peers.any():
                lo = reduce_peers(LANE_MIN_I64, peers, member[r])
                hi = reduce_peers(LANE_MAX_I64, peers, member[r])
            lead = adm & ((peers == 0) | (LANE == ffs(peers) - 1))
            count = popc(peers)
            for ln in np.flatnonzero(lead):
                out.insert(int(rows[ln]), int(key[ln]), int(count[ln]),
                           int(lo[ln]), int(hi[ln]))
    return out, adm_all, packed


def _keys(case, n, rng):
    """`sorted`: runs of 1-7 rows a key, as lineitem's orders;
    `shuffled`: the same keys in random order; `unique`: a permutation."""
    if case == "unique":
        return rng.permutation(n).astype(np.int64) * 3 + 7
    keys = np.repeat(np.arange(n), rng.integers(1, 8, n))[:n].astype(
        np.int64) * 4 + 1
    return rng.permutation(keys) if case == "shuffled" else keys


@pytest.mark.parametrize("wide", [False, True], ids=["direct", "hashed"])
@pytest.mark.parametrize("case", ["sorted", "shuffled", "unique"])
@pytest.mark.parametrize("build", ["inner", "presence", "minmax"])
def test_insert_replay_matches_plain(build, case, wide):
    from datafusion_tpu_torch.device.join_chain import (
        TAB_DIRECT, TAB_HASH, chain_build_plain)
    n = 20_000
    rng = np.random.default_rng(len(case) + 10 * wide)
    keys = _keys(case, n, rng)
    valid = rng.random(n) > 0.05
    member = rng.integers(-1000, 1000, n) if build == "minmax" else None
    spec, cols, aux = _spec(n, keys, member, valid, wide)
    unique = build == "inner"
    want = chain_build_plain(spec, cols, aux, n, unique)
    assert want.kind == (TAB_HASH if wide else TAB_DIRECT)
    got, adm, packed = replay(spec, cols, aux, n, want, unique)
    if want.kind == TAB_HASH:
        slots = np.flatnonzero(got.keys != -1)
        gk = got.keys[slots]
    else:
        slots = gk = np.flatnonzero(got.rows >= 0)
    order = np.argsort(gk)
    gk, slots = gk[order], slots[order]
    wk, wr = want.entries()
    np.testing.assert_array_equal(gk, wk)
    rows = got.rows[slots]
    # each kept row is an admitted row of its key
    assert adm[rows].all() and np.array_equal(packed[rows], gk)
    if unique:
        assert got.dup == int(want.duplicate) == int(case != "unique")
        if case == "unique":
            np.testing.assert_array_equal(rows, wr)
    if build == "minmax":
        for a, b in zip((got.mn[slots], got.mx[slots]), want.extremes()):
            np.testing.assert_array_equal(a, b)
    live = int(adm.sum())
    if case == "sorted":
        # about 4 rows a key: the blocks keep matching, and the peers make
        # about one insert a key where the row-at-a-time insert made one a
        # row
        assert got.stopped == 0 and got.sets < 0.45 * live
    elif case == "unique":
        # no key meets another: every block stops matching
        assert got.stopped >= 3


def test_a_key_in_two_warps_and_in_one():
    """A key whose rows straddle two warps' steps takes one insert from
    each (its duplicate found by the second CAS); a key inside one warp
    takes one insert (its duplicate found by the set)."""
    from datafusion_tpu_torch.device.join_chain import chain_build_plain
    n = 4 * W
    keys = np.arange(n, dtype=np.int64)
    keys[W - 2:W + 2] = 200          # rows 30-33: two warps
    keys[70:74] = 300                # rows 70-73: one warp
    spec, cols, aux = _spec(n, keys, pred=False)
    want = chain_build_plain(spec, cols, aux, n, True)
    for build in ("inner", "presence"):
        got, _adm, _p = replay(spec, cols, aux, n, want, build == "inner",
                               blocks=1, per_block=4)
        assert got.sets == n - 3 - 2    # 4 warps' sets
        if build == "inner":
            assert got.dup == 1 and want.duplicate
        kept = got.rows[[200 - want.los[0], 300 - want.los[0]]]
        assert set(kept[:1]) <= {30, 32} and set(kept[1:]) == {70}
