"""Sorting through the port on the CPU against the JAX package.

The port's `device_lexsort` runs `radix_sort`'s plain PyTorch version on
CPU tensors; the JAX package's `device_sort.device_lexsort` runs its
`lax.sort` program on the CPU backend. Both must give `np.lexsort`'s
permutation exactly, ties and limits included (the cases of
`tests/test_device_sort.py`, plus n = 4097 and the full uint64 range).
`reorder_rows` (kernel 8's wrapper) must equal numpy's fancy indexing on
every lane dtype. Then SQL: SortExec with DESC, NULLS FIRST/LAST, floats
with NaN, dictionary strings and a LIMIT over several batches, and
ClickBench Q25-Q27 at 400,000 rows, through both packages with their
device-sort thresholds at 1: equal rows, and the port's device path taken.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu_torch.clickbench.workload import QUERIES as CB
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu.physical.plan import device_sort as jax_sort
from datafusion_tpu_torch.device.groupby import reorder_rows
from datafusion_tpu_torch.physical.plan import device_sort as port_sort
from torch_twin import register_hits_both, twin

CPU = torch.device("cpu")
HITS_ROWS = 400_000


def _keys(n, seed):
    """Two sort expressions as [rank u8, key u64] x 2 with duplicates (ties
    keep row order), the second key over the whole uint64 range."""
    rng = np.random.default_rng(seed)
    k2 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    k2[rng.random(n) < 0.5] = np.uint64(7)
    k2[:1] = np.uint64(2**64 - 1)
    k2[1:2] = np.uint64(0)
    return [rng.integers(0, 2, n).astype(np.uint8),
            rng.integers(0, 50, n).astype(np.uint64),
            np.zeros(n, np.uint8), k2]


@pytest.mark.parametrize("n", [1, 7, 1000, 5000, 4097])
@pytest.mark.parametrize("limit", [None, 1, 10])
def test_lexsort_matches_jax_and_numpy(n, limit):
    keys = _keys(n, 42 + n)
    want = np.lexsort(tuple(reversed(keys)))[:limit]
    port = port_sort.device_lexsort(keys, n, limit, CPU)
    ref = jax_sort.device_lexsort(keys, n, limit=limit)
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(ref, want)
    assert port.dtype == np.int64 and len(port) == min(n, limit or n)


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int16, np.int32,
                                   np.int64, np.float32, np.float64])
def test_reorder_rows_matches_numpy(dtype):
    rng = np.random.default_rng(8)
    n = 10_001
    lanes = [(rng.normal(size=n) * 100).astype(dtype) for _ in range(3)]
    for order in (rng.permutation(n), rng.integers(0, n, 777)):
        got = reorder_rows(torch.from_numpy(order),
                           [torch.from_numpy(a) for a in lanes])
        for g, a in zip(got, lanes):
            assert g.numpy().dtype == a.dtype
            np.testing.assert_array_equal(g.numpy(), a[order])


def _sort_table(n=60_000, seed=3, parts=4):
    """Ints with NULLs, floats with NaN and NULLs, dictionary strings with
    NULLs, in `parts` batches."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 100, n).astype(np.int64)
    av = rng.random(n) > 0.05
    x = rng.normal(size=n).round(2)
    x[rng.random(n) < 0.02] = np.nan
    xv = rng.random(n) > 0.05
    words = np.array(sorted(["apple", "b", "banana", "cherry", "date", "é"]),
                     dtype=object)
    s = rng.integers(0, len(words), n).astype(np.int32)
    sv = rng.random(n) > 0.1
    schema = Schema([Field("a", dt.INT64, True), Field("x", dt.FLOAT64, True),
                     Field("s", dt.STRING, True), Field("i", dt.INT64, False)])
    cuts = np.linspace(0, n, parts + 1).astype(int)
    batches = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sl = slice(lo, hi)
        batches.append(Batch(schema, [
            Column(dt.INT64, a[sl], av[sl]), Column(dt.FLOAT64, x[sl], xv[sl]),
            Column(dt.STRING, s[sl], sv[sl], Dictionary(words)),
            Column(dt.INT64, np.arange(lo, hi, dtype=np.int64))], hi - lo))
    return schema, batches


SORT_SQL = [
    "SELECT a, x, i FROM t ORDER BY a DESC, x LIMIT 500",
    "SELECT a, i FROM t ORDER BY a NULLS FIRST, i DESC",
    "SELECT x, i FROM t ORDER BY x DESC NULLS LAST, i LIMIT 2000",
    "SELECT x, i FROM t ORDER BY x NULLS FIRST LIMIT 300",
    "SELECT s, a, i FROM t ORDER BY s, a DESC NULLS LAST, i LIMIT 1000",
    "SELECT s, i FROM t ORDER BY s DESC NULLS FIRST, i",
]


@pytest.fixture(scope="module")
def sort_pair():
    schema, batches = _sort_table()
    ref = df.SessionContext()
    ref.register_table("t", df.MemTable(schema, [batches]))
    port = dft.SessionContext(CPU)
    pb = twin(batches)
    port.register_table("t", dft.MemTable(pb[0].schema, [pb]))
    port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    return port, ref


def _count_device_sorts(monkeypatch):
    calls = []
    real = port_sort.device_lexsort

    def counted(words, n, limit, device):
        calls.append(n)
        return real(words, n, limit, device)
    monkeypatch.setattr(port_sort, "device_lexsort", counted)
    return calls


@pytest.mark.parametrize("sql", SORT_SQL)
def test_sort_exec_matches_jax(sort_pair, sql, monkeypatch):
    port, ref = sort_pair
    monkeypatch.setattr(jax_sort, "DEFAULT_MIN_ROWS", 1)
    calls = _count_device_sorts(monkeypatch)
    got = port.sql(sql).to_pydict()
    want = ref.sql(sql).to_pydict()
    assert got.keys() == want.keys()
    for k in want:   # NaN != NaN: compare through repr
        assert [repr(v) for v in got[k]] == [repr(v) for v in want[k]], k
    # LIMIT over four batches sorts each batch, then the survivors
    assert len(calls) == (5 if "LIMIT" in sql else 1)


def test_sort_threshold_keeps_small_sorts_on_the_host(sort_pair, monkeypatch):
    port, _ref = sort_pair
    calls = _count_device_sorts(monkeypatch)
    port.sql("SET datafusion.tpu.device_sort_min_rows = 100000")
    try:
        port.sql("SELECT a FROM t ORDER BY a LIMIT 5").collect()
    finally:
        port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    assert calls == []


@pytest.fixture(scope="module")
def hits():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_hits_both(port, ref, n=HITS_ROWS)
    port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    return port, ref


@pytest.mark.parametrize("q", [25, 26, 27])
def test_clickbench_sorts_match_jax(hits, q, monkeypatch):
    """Q25-Q27: SortExec(fetch=10) over the host filter SearchPhrase <> '':
    one device sort over the filtered rows."""
    port, ref = hits
    monkeypatch.setattr(jax_sort, "DEFAULT_MIN_ROWS", 1)
    calls = _count_device_sorts(monkeypatch)
    got = port.sql(CB[q]).to_pydict()
    want = ref.sql(CB[q]).to_pydict()
    assert got == want
    assert len(got["SearchPhrase"]) == 10
    assert len(calls) == 1 and calls[0] > HITS_ROWS // 3


# --- the radix sort's bookkeeping and a numpy model of its byte pass --------
#
# `csrc/radix_sort.cu` cannot run here. Its host side (`byte_passes`,
# `status_words`, the tile size) is tested directly; its byte pass is
# rehearsed by `_onesweep_pass`, a numpy model of `onesweep_kernel`'s
# offset arithmetic: tiles of `threads * items` rows, row r of a tile as
# item r % (32 items) // 32 of lane r % 32 of warp r // (32 items), ranked
# item by item within its warp, then across warps; per-tile digit counts;
# the exclusive prefix over earlier tiles (the look-back) plus the digit's
# global base (word_hist's exclusive scan, which tile 0 publishes).

def _digits(keys, shift):
    return ((keys.astype(np.uint64) >> np.uint64(shift)) &
            np.uint64(255)).astype(np.int64)


def _word_hist(w):
    """word_hist_kernel: the digit counts of every byte of a word."""
    return np.stack([np.bincount(_digits(w, 8 * b), minlength=256)
                     for b in range(w.itemsize)])


def _onesweep_pass(keys, perm, shift, threads=256, items=16):
    """(keys, rows) after one stable pass on the byte at `shift`, placed
    as `onesweep_kernel` places them."""
    n, tile, warps = len(keys), threads * items, threads // 32
    d = _digits(keys, shift)
    hist = np.bincount(d, minlength=256)
    base = np.cumsum(hist) - hist
    n_tiles = -(-n // tile)
    counts = np.stack([np.bincount(d[t * tile:(t + 1) * tile], minlength=256)
                       for t in range(n_tiles)])
    look_back = base + np.cumsum(counts, axis=0) - counts
    out_keys, out_perm = np.empty_like(keys), np.full(n, -1, np.int64)
    for t in range(n_tiles):
        warp_hist = np.zeros((warps, 256), np.int64)
        rank = np.zeros(tile, np.int64)
        for w in range(warps):
            for j in range(items):
                r0 = w * 32 * items + 32 * j        # lane 0's tile row
                dl = d[t * tile + r0:min(n, t * tile + r0 + 32)]
                for lane, dig in enumerate(dl):     # peers below it
                    rank[r0 + lane] = warp_hist[w, dig] + \
                        int((dl[:lane] == dig).sum())
                np.add.at(warp_hist[w], dl, 1)
        warp_off = np.cumsum(warp_hist, axis=0) - warp_hist
        assert np.array_equal(warp_hist.sum(axis=0), counts[t])
        rows = np.arange(t * tile, min(n, (t + 1) * tile))
        local = rows - t * tile
        dig = d[rows]
        pos = look_back[t, dig] + warp_off[local // (32 * items), dig] + \
            rank[local]
        out_keys[pos] = keys[rows]
        out_perm[pos] = perm[rows]
    assert (out_perm >= 0).all()
    return out_keys, out_perm


def _model_sort(words, threads=256, items=16):
    """The whole sort as `radix_sort` launches it, each pass modelled."""
    n = len(words[0])
    passes = port_sort.byte_passes([_word_hist(w) for w in words], n)
    perm, keys = np.arange(n, dtype=np.int64), None
    for e, p in enumerate(passes):
        if p.gather:
            keys = words[p.word][perm]
        elif e == 0:
            keys = words[p.word]
        keys, perm = _onesweep_pass(keys, perm, 8 * p.byte, threads, items)
    return perm


@pytest.mark.parametrize("threads, items", [(256, 16), (64, 1), (32, 3),
                                            (128, 2)])
@pytest.mark.parametrize("n", [1, 31, 4096, 4097, 20_011])
def test_onesweep_model_matches_stable_argsort(threads, items, n):
    """One pass of the model equals np.argsort(kind="stable") of the byte,
    at several tile sizes, ragged last tiles and one-digit words."""
    rng = np.random.default_rng(n + threads)
    for keys in (rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                              endpoint=True),
                 rng.integers(0, 3, n).astype(np.uint8),
                 np.where(rng.random(n) < 0.999, np.uint64(5),
                          np.uint64(2**63 + 9))):
        perm = rng.permutation(n).astype(np.int64)
        for shift in (0, 8, 56) if keys.itemsize == 8 else (0,):
            out_keys, out_perm = _onesweep_pass(keys, perm, shift, threads,
                                                items)
            order = np.argsort(_digits(keys, shift), kind="stable")
            np.testing.assert_array_equal(out_perm, perm[order])
            np.testing.assert_array_equal(out_keys, keys[order])


@pytest.mark.parametrize("threads, items", [(256, 16), (32, 2)])
def test_model_sort_matches_lexsort(threads, items):
    """The model's passes in `byte_passes`' order, gathering each later
    word through the permutation, give np.lexsort's permutation."""
    for n in (5, 3000, 9000):
        keys = _keys(n, n)
        np.testing.assert_array_equal(_model_sort(keys, threads, items),
                                      np.lexsort(tuple(reversed(keys))))


def test_byte_passes_skip_the_bytes_that_do_not_vary():
    """Most significant word first: an all-zero rank is skipped whole, a
    key's constant high bytes are skipped, the first word sorted gathers
    nothing, each later word's first pass gathers, and a word's last pass
    carries no keys."""
    n = 1000
    rng = np.random.default_rng(3)
    rank = np.zeros(n, np.uint8)
    date = (19000 + rng.integers(0, 300, n)).astype(np.uint64)   # 2 bytes
    flag = rng.integers(0, 2, n).astype(np.uint8)
    passes = port_sort.byte_passes(
        [_word_hist(w) for w in (rank, date, flag)], n)
    assert passes == [
        port_sort.BytePass(2, 0, gather=False, keys_out=False),
        port_sort.BytePass(1, 0, gather=True, keys_out=True),
        port_sort.BytePass(1, 1, gather=False, keys_out=False)]
    # every byte of every word constant: no pass, the identity
    assert port_sort.byte_passes([_word_hist(np.full(n, 7, np.uint64))],
                                 n) == []
    # a uint64 word whose eight bytes all vary: eight passes, keys carried
    full = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    passes = port_sort.byte_passes([_word_hist(full)], n)
    assert [p.byte for p in passes] == list(range(8))
    assert [p.keys_out for p in passes] == [True] * 7 + [False]


def test_radix_scratch_matches_the_kernel():
    """The tile, status array and row limit the wrapper sizes are the
    kernel's: kThreads * kItems rows a tile, one status word a (tile,
    digit), counts of kCountBits bits; the sort's launches are a
    histogram a word, a pass a varying byte and a gather a later word."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(port_sort.__file__), os.pardir,
                        os.pardir, "csrc")
    # the status word's layout is the shared look-back header's
    src = "".join(open(os.path.join(csrc, f)).read()
                  for f in ("radix_sort.cu", "lookback.cuh"))
    const = {m[0]: int(m[1]) for m in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["kThreads"] * const["kItems"] == port_sort.TILE
    assert port_sort.MAX_ROWS == 1 << const["kCountBits"]
    assert port_sort.status_words(1) == 256
    assert port_sort.status_words(port_sort.TILE) == 256
    assert port_sort.status_words(39_995_647) == 9765 * 256
    # CB Q25's words: an all-zero rank and a time of 3 varying bytes
    n = 50_000
    rng = np.random.default_rng(25)
    words = [np.zeros(n, np.uint8),
             (1372636800 + rng.integers(0, 31 * 86400, n)).astype(np.uint64)]
    passes = port_sort.byte_passes([_word_hist(w) for w in words], n)
    assert len(words) + len(passes) + sum(p.gather for p in passes) == 5
    assert port_sort.sort_launch_count(words) == 5


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_sort_launch_count_follows_the_passes(n):
    """`sort_launch_count`: nothing for one row or fewer; else a
    histogram a word, a pass a varying byte of `byte_passes` and a gather
    before each later word's first pass; `digit_counts` counts as the
    histogram kernel does."""
    rng = np.random.default_rng(n)
    words = [rng.integers(0, 2, n).astype(np.uint8),
             np.zeros(n, np.uint8),
             rng.integers(0, 1 << 20, n).astype(np.uint64),
             rng.integers(0, 2, n).astype(bool)]
    for w in words:
        np.testing.assert_array_equal(port_sort.digit_counts(w),
                                      _word_hist(w))
    # 4 histograms; 5 passes (the bool, 3 bytes of the key, the rank);
    # 2 gathers (the key, the rank)
    want = 0 if n <= 1 else 4 + 5 + 2
    assert port_sort.sort_launch_count(words) == want
