"""A numpy replay of the join-chain aggregate's tile walk
(`csrc/chain_aggregate.cu`) and the probe predicate's conjunct split.

The tile walk: a warp tests the probe predicate on steps of
`kRowsPerStep` x 32 spine rows and appends the admitted rows, in spine
order, to its list of `cap` entries (`warp_append`: a round's rows after
the round before, a lane's after the lanes below it); before a step whose
rows the list might not take it walks the list, hop after hop, its lanes
taking the entries densely (so a round's active lanes are the first ones:
full warps but for the last round), each entry's row handle written to
handles[hop][entry] and the survivors appended, in order, to the next
list; the survivors fold. `replay` does what a grid of such warps does
over one spine (`block` lanes each: 32 on the card, 1 in the one-thread
CPU build) and checks, for several tile sizes,
on chains where no row of a tile survives, where every row survives and
where hops drop nearly every row, that every surviving row folds exactly
once, in spine order within a tile, with each hop's handle read back from
its first-list entry equal to the row the hop found, and that every tile
but a warp's last is more than full less a step.

The conjunct split (`lower.split_conjuncts`, `lower.conjunct_form`): the
probe predicate's top-level AND is cut into conjuncts, the one-column tests
among them laid out for the kernel to test directly. Evaluated here as the
kernel evaluates them (`chain_aggregate.cu` `admit_rows`: a NULL fails, the
comparison by the interpreter's rules, NaN and -0.0 included), the
conjuncts together pass exactly the rows `evaluate` passes for the whole
predicate, over NULLs, NaN, -0.0, decimals and dictionary codes; the
one-thread CPU build of the kernel's own evaluator is held to `run` in
`test_torch_csrc_cpu.py`.
"""
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
ROWS_PER_STEP = 2          # csrc/chain_aggregate.cu kRowsPerStep
JT_INNER, JT_SEMI, JT_ANTI = range(3)


def append(keep, values, n, out):
    """`warp_append` over rounds: keep and values [rounds, lanes]; returns
    the new count."""
    for r in range(keep.shape[0]):
        for t in range(keep.shape[1]):
            if keep[r, t]:
                out[n] = values[r, t]
                n += 1
    return n


def walk_tile(rows, n, hops, block, cap, log):
    """`walk_tile` over rows[:n]: returns the surviving entries (indices
    into rows) and checks the handles they read."""
    handles = np.full((len(hops), cap), -7, np.int64)
    cur = np.arange(n)
    for h, (found, jtype) in enumerate(hops):
        out = np.zeros(cap, np.int64)
        kept = 0
        m = len(cur)
        for i0 in range(0, m, block):
            active = np.arange(i0, i0 + block) < m
            # a round's active lanes are its first ones
            assert active[:active.sum()].all()
            e = np.where(active, cur[np.minimum(np.arange(i0, i0 + block),
                                                m - 1)], 0)
            b = np.where(active, found[rows[e]], -1)
            keep = active & ((b < 0) if jtype == JT_ANTI else (b >= 0))
            handles[h, e[active]] = b[active]
            kept = append(keep[None, :], e[None, :], kept, out)
        cur = out[:kept]
        log["reach"].append(m)
        if kept == 0:
            break
    for h, (found, _jt) in enumerate(hops):
        if len(cur):
            np.testing.assert_array_equal(handles[h, cur], found[rows[cur]])
    return cur


def replay(n_rows, admitted, hops, block, grid, cap):
    """The surviving spine rows of each tile walked by a grid of `grid`
    warps of `block` lanes (tiles in walk order, warp by warp): the list is
    walked before a step whose rows it might not take."""
    step = block * ROWS_PER_STEP
    assert cap >= step
    tiles, log = [], {"reach": [], "sizes": []}
    for b in range(grid):
        rows = np.zeros(cap, np.int64)
        n = 0
        sizes = []
        for base in range(b * step, n_rows, grid * step):
            if n > cap - step:
                sizes.append(n)
                tiles.append(rows[walk_tile(rows, n, hops, block, cap, log)])
                n = 0
            idx = base + np.arange(ROWS_PER_STEP)[:, None] * block + \
                np.arange(block)[None, :]
            inside = idx < n_rows
            keep = inside & admitted[np.minimum(idx, n_rows - 1)]
            n = append(keep, idx, n, rows)
        if n > 0:
            sizes.append(n)
            tiles.append(rows[walk_tile(rows, n, hops, block, cap, log)])
        # every tile but the warp's last is more than full less a step
        assert all(s > cap - step for s in sizes[:-1])
        assert all(s <= cap for s in sizes)
        log["sizes"] += sizes
    return tiles, log


def plain_survivors(admitted, hops):
    alive = admitted.copy()
    for found, jtype in hops:
        alive &= (found < 0) if jtype == JT_ANTI else (found >= 0)
    return np.flatnonzero(alive)


def _chain(case, n, rng):
    """(admitted, hops) of a synthetic chain over n spine rows: each hop a
    found row a spine row (-1: none) and a join type."""
    admitted = np.ones(n, bool)
    if case == "all_survive":
        return admitted, [(rng.integers(0, 50, n), JT_INNER),
                          (rng.integers(0, 9, n), JT_SEMI)]
    if case == "empty_tiles":
        admitted[n // 5:3 * n // 5] = False      # whole tiles admit nothing
        found = np.where(rng.random(n) < 0.7, rng.integers(0, 40, n), -1)
        return admitted, [(found, JT_INNER)]
    if case == "nothing":
        return np.zeros(n, bool), [(rng.integers(0, 5, n), JT_INNER)]
    if case == "sieve":                           # hops drop nearly every row
        admitted = rng.random(n) < 0.5
        f1 = np.where(rng.random(n) < 0.002, rng.integers(0, 9, n), -1)
        f2 = np.where(rng.random(n) < 0.5, rng.integers(0, 9, n), -1)
        return admitted, [(rng.integers(0, 99, n), JT_INNER), (f1, JT_INNER),
                          (f2, JT_ANTI), (rng.integers(0, 3, n), JT_SEMI)]
    if case == "eight_hops":
        hops = [(np.where(rng.random(n) < 0.97, rng.integers(0, 30, n), -1),
                 JT_INNER if h % 3 else JT_SEMI) for h in range(7)]
        hops.append((np.where(rng.random(n) < 0.1, 1, -1), JT_ANTI))
        return rng.random(n) < 0.9, hops
    raise ValueError(case)


CASES = ["all_survive", "empty_tiles", "nothing", "sieve", "eight_hops"]
# (lanes, warps, list entries): one lane as the CPU build runs the kernel,
# a warp at several list sizes, the card's 128
GEOMETRIES = [(1, 1, 2), (1, 3, 7), (32, 2, 64), (32, 5, 200),
              (32, 24, 128)]


@pytest.mark.parametrize("block,grid,cap", GEOMETRIES)
@pytest.mark.parametrize("case", CASES)
def test_tile_walk_folds_every_survivor_once(case, block, grid, cap):
    rng = np.random.default_rng(len(case) * 31 + block)
    n = 9_000 if block > 1 else 1_500
    admitted, hops = _chain(case, n, rng)
    tiles, log = replay(n, admitted, hops, block, grid, cap)
    got = np.concatenate(tiles) if tiles else np.zeros(0, np.int64)
    want = plain_survivors(admitted, hops)
    assert len(got) == len(set(got.tolist()))
    np.testing.assert_array_equal(np.sort(got), want)
    for t in tiles:                 # spine order within a tile
        assert (np.diff(t) > 0).all()
    if case == "nothing":
        assert not log["sizes"] and not tiles
    if case == "all_survive":
        assert sum(log["sizes"]) == n


def test_tile_walk_fills_warps_where_the_row_walk_idled():
    """Warp steps that make lookups: the row walk steps a warp over 32
    consecutive spine rows at every hop that any of them reaches, however
    few do; the tile walk steps a warp over 32 entries of a tile's list of
    the rows that reach the hop. Where the predicate keeps half the rows
    and a hop then keeps 1 in 500, the tile walk takes fewer than half the
    row walk's steps."""
    rng = np.random.default_rng(3)
    n = 200_000
    admitted = rng.random(n) < 0.1
    hops = [(rng.integers(0, 99, n), JT_INNER),
            (np.where(rng.random(n) < 0.02, 4, -1), JT_INNER),
            (rng.integers(0, 3, n), JT_SEMI)]
    _tiles, log = replay(n, admitted, hops, 32, 16, 128)
    tile_steps = sum(-(-m // 32) for m in log["reach"])
    alive, row_steps = admitted.copy(), 0
    for found, jtype in hops:
        row_steps += int(alive.reshape(-1, 32).any(1).sum())
        alive &= (found < 0) if jtype == JT_ANTI else (found >= 0)
    assert tile_steps < 0.2 * row_steps


def eight_hop_ctx(device, n=50_000):
    """A spine f of `n` rows with eight keys, each into a dimension d1..d8
    that lacks a few of its keys (INNER hops that drop rows), two of them
    filtered: a chain of eight hops (EIGHT_HOP_SQL)."""
    import datafusion_tpu_torch as dft
    rng = np.random.default_rng(8)
    ctx = dft.SessionContext(device)
    f = {f"k{h}": rng.integers(0, 30 + h, n) for h in range(1, 9)}
    f["v"] = rng.integers(0, 100, n)
    ctx.register_arrays("f", f)
    for h in range(1, 9):
        ctx.register_arrays(f"d{h}", {"id": np.arange(28 + h),
                                      "w": rng.integers(0, 5, 28 + h)})
    return ctx


EIGHT_HOP_SQL = ("SELECT d8.w, count(*) c, sum(f.v) s FROM f " +
                 " ".join(f"JOIN d{h} ON f.k{h} = d{h}.id"
                          for h in range(1, 9)) +
                 " WHERE d2.w > 0 AND d5.w < 4 AND f.v < 90 GROUP BY d8.w")


# --- the conjunct split ---------------------------------------------------------

def _conj_ctx():
    """A spine f (NULLs, NaN and -0.0 in its floats, a decimal, a
    dictionary string with NULLs, dates) and a dimension d."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.batch import Batch
    from datafusion_tpu_torch.common.column import Column, Dictionary
    from datafusion_tpu_torch.common.schema import Field, Schema
    rng = np.random.default_rng(5)
    n = 4000
    x = rng.choice([0.0, -0.0, 1.5, -2.0, np.nan, 2.5, 7.0], n)
    y = rng.choice([0.0, -0.0, 1.5, np.nan, 2.5], n)
    dic = Dictionary(np.array(["a", "b", "c", "e"], object))
    fields = [Field("k", dt.INT64, False), Field("i", dt.INT32, True),
              Field("j", dt.INT64, False), Field("x", dt.FLOAT64, True),
              Field("y", dt.FLOAT64, False), Field("day", dt.DATE, False),
              Field("dec", dt.decimal(12, 2), False),
              Field("s", dt.STRING, True)]
    cols = [Column(dt.INT64, rng.integers(0, 20, n)),
            Column(dt.INT32, rng.integers(-3, 9, n).astype(np.int32),
                   rng.random(n) > 0.2),
            Column(dt.INT64, rng.integers(-3, 9, n)),
            Column(dt.FLOAT64, x, rng.random(n) > 0.1),
            Column(dt.FLOAT64, y),
            Column(dt.DATE, rng.integers(9000, 10000, n).astype(np.int32)),
            Column(dt.decimal(12, 2), rng.integers(-500, 500, n)),
            Column(dt.STRING, rng.integers(0, 4, n).astype(np.int32),
                   rng.random(n) > 0.15, dictionary=dic)]
    ctx = dft.SessionContext(CPU)
    ctx.register_table("f", dft.MemTable.from_batches(
        [Batch(Schema(fields), cols, n)]))
    ctx.register_arrays("d", {"id": np.arange(20),
                              "w": rng.integers(0, 4, 20)})
    return ctx


# (predicate over f, the conjuncts' forms: a direct form's name or "prog")
PREDICATES = [
    ("f.x > -0.0 AND f.i < 5", ["CMP_F", "CMP_I"]),
    ("f.x = 0.0 AND f.i IS NOT NULL", ["CMP_F", "prog"]),
    ("f.x <> f.y AND f.s IN ('a', 'c')", ["CMPC_F", "LUT"]),
    ("f.s < 'b' AND f.dec > 1.5", ["STRCMP", "prog"]),
    ("f.s >= 'b' AND f.s <> 'e' AND f.dec <= -1.25", ["STRCMP", "STRCMP",
                                                      "prog"]),
    ("f.i IN (1, 3, 5) AND 3 > f.i", ["IN_I", "CMP_I"]),
    ("f.x IN (0.0, 2.5) AND (f.i > 2 OR f.x < 0)", ["IN_F", "prog"]),
    ("f.day >= DATE '1995-01-01' AND f.day < DATE '1996-06-01' AND "
     "f.j > f.i", ["CMP_I", "CMP_I", "CMPC_I"]),
    ("f.x < f.y OR f.i = 2", ["prog"]),
    ("NOT (f.x >= 1.5) AND -0.0 <= f.y", ["CMP_F", "prog"]),
]
FORM_NAMES = ["prog", "CMP_I", "CMP_F", "CMPC_I", "CMPC_F", "IN_I", "IN_F",
              "LUT", "STRCMP"]


def conj_chain(ctx, pred):
    """The chain spec, pair-space columns and aux of the query that groups
    f JOIN d under `pred`."""
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    sql = ("SELECT d.w, count(*) c FROM f JOIN d ON f.k = d.id WHERE " +
           pred + " GROUP BY d.w")
    todo = [ctx.sql(sql).create_physical_plan()]
    while not isinstance(todo[-1], TorchJoinChainAggregateExec):
        node = todo.pop()
        todo += node.children()[::-1]
    spec, _p, _n, _s, inputs, _staged = todo[-1].prepare(ctx.task_context())
    ((cols, aux, n),) = inputs
    return spec, cols, aux, n


def _aux_slot(aux, j):
    a = aux.numpy()
    return a[a[2 * j]:a[2 * j] + a[2 * j + 1]]


def _cmp(code, a, b):
    return [a == b, a != b, a < b, a <= b, a > b, a >= b][code]


def conjunct_numpy(form, pools, cols, aux, n):
    """`conjunct_test` of one direct form over n rows (its first column
    loaded, a NULL failing), in numpy."""
    from datafusion_tpu_torch.device import lower as L
    f, col, a, b = form
    data, valid = cols[col]
    x = data.numpy()[:n]
    ok = np.ones(n, bool) if valid is None else valid.numpy()[:n].copy()
    if f in (L.CJ_CMP_F, L.CJ_CMPC_F, L.CJ_IN_F):
        x = x.astype(np.float64)
    else:
        x = x.astype(np.int64)
    with np.errstate(invalid="ignore"):
        if f == L.CJ_CMP_I:
            return ok & _cmp(a, x, np.int64(b))
        if f == L.CJ_CMP_F:
            return ok & _cmp(a, x, np.int64(b).view(np.float64))
        if f in (L.CJ_CMPC_I, L.CJ_CMPC_F):
            d2, v2 = cols[b]
            y = d2.numpy()[:n].astype(x.dtype)
            ok &= np.ones(n, bool) if v2 is None else v2.numpy()[:n]
            return ok & _cmp(a, x, y)
        if f == L.CJ_IN_I:
            return ok & np.isin(x, np.asarray(pools.iconst[a:a + b]))
        if f == L.CJ_IN_F:
            return ok & (x[:, None] == np.asarray(
                pools.fconst[a:a + b])[None, :]).any(1)
        if f == L.CJ_LUT:
            lut = _aux_slot(aux, a)
            return ok & (lut[np.clip(x, 0, len(lut) - 1)] != 0)
        pos, exact = _aux_slot(aux, b)[:2]          # CJ_STRCMP
        return ok & [x == exact, x != exact, x < pos, (x < pos) | (x == exact),
                     (x >= pos) & (x != exact), x >= pos][a]


@pytest.mark.parametrize("pred,forms", PREDICATES)
def test_conjunct_split_passes_what_the_predicate_passes(pred, forms):
    from datafusion_tpu_torch.device.lower import evaluate
    spec, cols, aux, n = conj_chain(_conj_ctx(), pred)
    chain = spec.chain
    names = [FORM_NAMES[0] if f is None else FORM_NAMES[f[0]]
             for f, _c in chain.conjuncts]
    assert names == sorted(forms, key=lambda f: f == "prog")
    d, v = evaluate(chain.ppred, cols, aux, n)
    want = ((d != 0) & v).numpy()
    got = np.ones(n, bool)
    for form, c in chain.conjuncts:
        if form is None:
            cd, cv = evaluate(c, cols, aux, n)
            got &= ((cd != 0) & cv).numpy()
        else:
            got &= conjunct_numpy(form, spec.pools, cols, aux, n)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n or pred.startswith("f.x = 0.0")


def test_split_conjuncts_cuts_nested_ands_left_to_right():
    """((a AND b) AND (c AND d)) AND e gives a, b, c, d, e; an OR or NOT is
    one conjunct; each conjunct's code is a slice of the whole's."""
    from datafusion_tpu_torch.device import lower as L
    col = lambda i: (L.OP_COL, i, 0)
    lt = (L.OP_CMP_I, L.CMP_LT, 0)
    code = [col(0), (L.OP_ICONST, 0, 0), lt, col(1), (L.OP_ICONST, 1, 0), lt,
            (L.OP_AND, 0, 0), col(2), (L.OP_LUT, 0, 0), col(3), col(4),
            (L.OP_OR, 0, 0), (L.OP_NOT, 0, 0), (L.OP_AND, 0, 0),
            (L.OP_AND, 0, 0), col(5), (L.OP_IN_I, 2, 3), (L.OP_AND, 0, 0)]
    pools = L.Pools()
    pools.i(10, -4, 1, 2, 3)
    parts = L.split_conjuncts(L.Program(code, pools, np.bool_))
    assert [p.code for p in parts] == [code[0:3], code[3:6], code[7:9],
                                       code[9:13], code[15:17]]
    assert [L.conjunct_form(p) for p in parts] == [
        (L.CJ_CMP_I, 0, L.CMP_LT, 10), (L.CJ_CMP_I, 1, L.CMP_LT, -4),
        (L.CJ_LUT, 2, 0, 0), None, (L.CJ_IN_I, 5, 2, 3)]
