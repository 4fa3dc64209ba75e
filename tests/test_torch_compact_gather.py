"""The layouts of `csrc/compact_groups.cu` and `csrc/gather_lanes.cu` as
numpy models, on the CPU.

Compaction (kernel row 2): the mark pass's keep words (with the 16-byte
loads' interleaved ballots), tile counts, the decoupled look-back of
`lookback.cuh` (the warp's walk, and the one-thread walk the radix sort
takes) under any order in which earlier tiles publish, ng, and the
copy pass's ranks must give `nonzero` order: a `cap` that is no multiple
of the tile, no live slot, every slot live, one live slot at each tile
edge, a HAVING mask and a slot list with -1 entries.

Gather (kernel row 8): `gather_plan`'s record layout (widest first,
naturally aligned fields, padding, groups of at most 128 B) packed,
gathered and unpacked with numpy must equal fancy indexing, for 1/2/4/8-B
mixes, records over 32 B and over 128 B, more than 32 lanes, m < n,
repeats and m = 0; and the mode it picks is the wrapper's.

Both wrappers also run their host side here against a fake kernel library
that does the kernels' work with these models through the same pointers,
so the scratch, the ng read-back and the launch counts are the wrappers'
own. Last, the port's `reorder_rows` against the JAX package's
`reorder_rows_packed` on W1-shaped lanes, exactly.
"""
import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.device.groupby import reorder_rows_packed
from datafusion_tpu_torch import kernels
from datafusion_tpu_torch.device import groupby as gb

TILE, WORDS, WARPS, THREADS = gb.COMPACT_TILE, gb.COMPACT_WORDS, 8, 256


# ---- compaction --------------------------------------------------------------

def _keep_entries(table, slots=None, having=None):
    """The keep test of each entry: occupied (and passing `having`, a mask
    over the slots); a list entry below 0 is not kept."""
    keys = table[0]
    s = np.arange(table.shape[1]) if slots is None else slots
    ok = s >= 0
    keep = np.zeros(len(s), bool)
    keep[ok] = keys[s[ok]] != -1
    if having is not None:
        keep[ok] &= having[s[ok]]
    return keep


def _keep_words(keep):
    """Bit b of word w is entry 32 w + b, over whole tiles."""
    nt = max(-(-len(keep) // TILE), 1)
    bits = np.zeros(nt * TILE, np.uint64)
    bits[:len(keep)] = keep
    return (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)


def _spread16(x):
    x = x & 0xFFFF
    x = (x | x << 8) & 0x00FF00FF
    x = (x | x << 4) & 0x0F0F0F0F
    x = (x | x << 2) & 0x33333333
    return (x | x << 1) & 0x55555555


def _vec_words(keep):
    """The mark pass's words from 16-byte loads: lane l of a warp holds
    entries base + 64 i + 2 l and + 1; an even and an odd ballot are
    interleaved into words 2 i and 2 i + 1."""
    nt = max(-(-len(keep) // TILE), 1)
    bits = np.zeros(nt * TILE, bool)
    bits[:len(keep)] = keep
    words = np.zeros(nt * WORDS, np.uint32)
    for wbase in range(0, nt * TILE, TILE // WARPS):
        for i in range(8):
            e = bits[wbase + 64 * i:wbase + 64 * i + 64]
            even = int((e[0::2].astype(np.uint64) <<
                        np.arange(32, dtype=np.uint64)).sum())
            odd = int((e[1::2].astype(np.uint64) <<
                       np.arange(32, dtype=np.uint64)).sum())
            w0 = wbase // 32 + 2 * i
            words[w0] = _spread16(even) | _spread16(odd) << 1
            words[w0 + 1] = _spread16(even >> 16) | _spread16(odd >> 16) << 1
    return words


def _look_back(read, tile, ahead):
    """lookback.cuh's look_back: read(t) is tile t's status word as
    (flag, count), flag 0 while it is not yet published."""
    excl, done, t = 0, False, tile - 1
    while not done:
        st = [read(t - q) if t - q >= 0 else (0, 0) for q in range(ahead)]
        q = 0
        for r in range(ahead):
            if done or q < r:
                continue
            if st[r][0] == 0:
                continue                       # not yet
            excl += st[r][1]
            done = st[r][0] == 2
            q = r + 1
        t -= q
    return excl


def _warp_look_back(read, tile):
    """lookback.cuh's warp_look_back: lane l reads tile t - l; the walk
    stops at the nearest inclusive word once every word before it is
    published, else sums all 32 and steps back 32 tiles."""
    excl, t = 0, tile - 1
    while True:
        while True:
            st = [read(t - lane) if t - lane >= 0 else (2, 0)
                  for lane in range(32)]
            incl = [lane for lane in range(32) if st[lane][0] == 2]
            stop = incl[0] if incl else 31
            if all(st[lane][0] != 0 for lane in range(stop + 1)):
                break
        excl += sum(st[lane][1] for lane in range(stop + 1))
        if incl:
            return excl
        t -= 32


def _mark(words, rng, ahead=None):
    """Tile counts, then each tile's exclusive offset by look-back (the
    warp's, or the one-thread walk of `ahead` words a step) with the
    earlier tiles in a random state: inclusive, an aggregate, or not yet
    published (then published at a later read). Returns (offsets, ng)."""
    counts = np.array([int(sum(bin(int(w)).count("1") for w in t))
                       for t in words.reshape(-1, WORDS)])
    nt = len(counts)
    offsets = np.zeros(nt, np.int64)
    for tile in range(nt):
        state = {}
        for t in range(tile):
            state[t] = 0 if t == 0 else int(rng.integers(0, 3))

        def read(t):
            s = state[t]
            if s == 0 and t > 0:
                state[t] = int(rng.integers(1, 3))   # published later
                return (0, 0)
            if s == 2 or t == 0:
                return (2, int(offsets[t] + counts[t]))
            return (1, int(counts[t]))
        offsets[tile] = 0 if tile == 0 else \
            _warp_look_back(read, tile) if ahead is None else \
            _look_back(read, tile, ahead)
    assert np.array_equal(offsets, np.cumsum(counts) - counts)
    return offsets, int(offsets[-1] + counts[-1])


def _copy(words, offsets, ng):
    """The copy pass: in each tile, thread t < 128 holds word t, takes its
    exclusive rank among the tile's kept entries and lists their tile
    positions; kept entry j of the tile goes to offsets[tile] + j.
    Returns the entry of each output column."""
    out = np.full(ng, -1, np.int64)
    for tile, tw in enumerate(words.reshape(-1, WORDS)):
        c = np.array([bin(int(w)).count("1") for w in tw])
        pos = np.cumsum(c) - c
        kept = np.zeros(c.sum(), np.int64)
        for t, w in enumerate(tw):
            bits = [b for b in range(32) if int(w) >> b & 1]
            kept[pos[t]:pos[t] + len(bits)] = [32 * t + b for b in bits]
        out[offsets[tile]:offsets[tile] + len(kept)] = tile * TILE + kept
    assert (out >= 0).all()
    return out


def _table(cap, live, seed, rows=3):
    rng = np.random.default_rng(seed)
    table = np.full((rows, cap), -1, np.int64)
    table[0, live] = rng.integers(0, 2**40, len(live))
    table[1:, live] = rng.integers(-1000, 1000, (rows - 1, len(live)))
    return table


CAP = 3 * TILE + 77
EDGES = [0, TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, 3 * TILE, CAP - 1]


def _cases():
    rng = np.random.default_rng(11)
    yield "none", _table(CAP, [], 0), None, None
    yield "all", _table(CAP, np.arange(CAP), 1), None, None
    for e in EDGES:
        yield f"slot {e}", _table(CAP, [e], e), None, None
    sparse = rng.choice(CAP, 700, replace=False)
    yield "sparse", _table(CAP, sparse, 2), None, None
    yield "having", _table(CAP, sparse, 3), rng.random(CAP) < 0.5, None
    slots = rng.choice(CAP, 300, replace=False)
    slots[rng.random(300) < 0.2] = -1
    yield "slot list", _table(CAP, sparse, 4), None, slots
    yield "small", _table(5, [1, 3], 5), None, None


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_compaction_model_gives_nonzero_order(case):
    _name, table, having, slots = case
    keep = _keep_entries(table, slots, having)
    words = _keep_words(keep)
    if slots is None:
        np.testing.assert_array_equal(_vec_words(keep), words)
    offsets, ng = _mark(words, np.random.default_rng(len(keep)))
    entries = _copy(words, offsets, ng)
    np.testing.assert_array_equal(entries, np.nonzero(keep)[0])
    picked = entries if slots is None else slots[entries]
    want = gb.compact_groups_plain(
        torch.from_numpy(table), None,
        None if slots is None else torch.from_numpy(slots)).numpy()
    if having is None:
        np.testing.assert_array_equal(table[:, picked], want)
    else:
        np.testing.assert_array_equal(picked, np.nonzero(
            (table[0] != -1) & having)[0])


@pytest.mark.parametrize("ahead", [None, 1, 4, 8])
def test_look_back_sums_any_publication_order(ahead):
    """Counts from 0 to 4,096 over 100 tiles, earlier tiles in every mix of
    states: each tile's offset is the exclusive prefix sum, by the warp's
    walk (the compaction's) and by the one-thread walk (the radix
    sort's)."""
    rng = np.random.default_rng(ahead or 32)
    counts = rng.integers(0, TILE + 1, 100)
    counts[rng.random(100) < 0.3] = 0
    words = np.zeros(100 * WORDS, np.uint32)
    for t, c in enumerate(counts):
        bits = np.zeros(TILE, np.uint64)
        bits[:c] = 1
        words[t * WORDS:(t + 1) * WORDS] = (
            bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(
                axis=1).astype(np.uint32)
    offsets, ng = _mark(words, rng, ahead)
    assert ng == counts.sum()


def _view(ptr, count, dtype):
    """A writable numpy view of `count` values at the address `ptr`."""
    ctype = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), (count,))


class _FakeLib:
    """The kernels' C entry points done by the numpy models through the
    wrappers' pointers (CPU tensors): each call is recorded."""

    def __init__(self, rows=0, having=None, n_rows=0):
        self.calls, self.rows, self.having, self.n = [], rows, having, n_rows

    def dft_compact_mark(self, meta, meta_len, having, table, cap, slots, n,
                         words, state, stream):
        self.calls.append("mark")
        assert bool(having) == (self.having is not None)
        keys = _view(table, cap, np.int64)
        s = None if slots is None else _view(slots, n, np.int64)
        keep = _keep_entries(keys[None], s, self.having)
        w = _keep_words(keep)
        nt = len(w) // WORDS
        offsets, ng = _mark(w, np.random.default_rng(0))
        _view(words, nt * WORDS, np.uint32)[:] = w
        st = _view(state, nt + 2, np.int64)
        assert not st.any(), "the state must start zeroed"
        ends = np.append(offsets[1:], ng).astype(np.uint64)
        st.view(np.uint64)[:nt] = np.uint64(2 << 62 | 1 << 40) | ends
        st[nt], st[nt + 1] = nt, ng
        return 0

    def dft_compact_copy(self, table, cap, nrows, slots, n, words, state,
                         out, ng, stream):
        self.calls.append("copy")
        assert ng > 0 and nrows == self.rows
        nt = max(-(-n // TILE), 1)
        t = _view(table, nrows * cap, np.int64).reshape(nrows, cap)
        w = _view(words, nt * WORDS, np.uint32)
        st = _view(state, nt + 2, np.int64)
        counts = np.array([sum(bin(int(x)).count("1") for x in tw)
                           for tw in w.reshape(-1, WORDS)])
        offsets = (st[:nt] & ((1 << 40) - 1)) - counts
        entries = _copy(w, offsets, ng)
        picked = entries if slots is None else \
            _view(slots, n, np.int64)[entries]
        _view(out, nrows * ng, np.int64)[:] = t[:, picked].ravel()
        return 0

    def _lanes(self, k, ptrs, widths, offs):
        widths, offs = list(widths[:k]), list(offs[:k])
        # the C side's lane_table: widths 8, 4, 2, 1 in that order, each
        # field aligned and inside the record
        assert widths == sorted(widths, reverse=True)
        assert all(o % w == 0 and o + w <= gb.GATHER_MAX_RECORD
                   for o, w in zip(offs, widths))
        return [(p, w, o) for p, w, o in zip(list(ptrs[:k]), widths, offs)]

    def dft_gather_direct(self, order, m, k, srcs, dsts, widths, offs,
                          stream):
        self.calls.append("direct")
        idx = _view(order, m, np.int64)
        for (src, w, _o), dst in zip(self._lanes(k, srcs, widths, offs),
                                     list(dsts[:k])):
            dt = np.dtype(f"u{w}")
            _view(dst, m, dt)[:] = _view(src, self.n, dt)[idx]
        return 0

    def dft_gather_pack(self, n, k, srcs, widths, offs, width, recs, stream):
        self.calls.append(("pack", width))
        rec = _view(recs, n * width, np.uint8).reshape(n, width)
        rec[:] = 0
        for src, w, o in self._lanes(k, srcs, widths, offs):
            rec[:, o:o + w] = _view(src, n * w, np.uint8).reshape(n, w)
        return 0

    def dft_gather_records(self, order, m, recs, width, k, dsts, widths,
                           offs, stream):
        self.calls.append(("gather", width))
        rec = _view(recs, self.n * width, np.uint8).reshape(self.n, width)
        got = rec[_view(order, m, np.int64)]
        for dst, w, o in self._lanes(k, dsts, widths, offs):
            _view(dst, m * w, np.uint8)[:] = got[:, o:o + w].ravel()
        return 0


@pytest.fixture()
def fake_card(monkeypatch):
    """The wrappers take their CUDA path on CPU tensors, into a _FakeLib."""
    lib = _FakeLib()
    monkeypatch.setattr(gb, "_cuda", lambda t: True)
    monkeypatch.setattr(gb, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "library", lambda: lib)
    return lib


class _MaskHaving:
    """A stand-in HavingSpec: a fixed mask over the slots."""

    def __init__(self, mask):
        self.keep, self.mode = mask, gb.HAVING_DIRECT

    def device_meta(self, device):
        return torch.zeros(1, dtype=torch.int64)

    def mask(self, table):
        return torch.from_numpy(self.keep)


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_compact_groups_host_side_against_the_model(fake_card, case):
    """compact_groups' own scratch, state read-back and launches: 2 a call,
    1 when nothing is kept."""
    _name, table, having, slots = case
    fake_card.rows, fake_card.having = table.shape[0], having
    hv = None if having is None else _MaskHaving(having)
    t = torch.from_numpy(table)
    s = None if slots is None else torch.from_numpy(slots)
    before = gb.compact_groups_kernel.launches
    got = gb.compact_groups(t, hv, s).numpy()
    want = gb.compact_groups_plain(t, hv, s).numpy()
    np.testing.assert_array_equal(got, want)
    launches = 2 if want.shape[1] else 1
    assert gb.compact_groups_kernel.launches - before == launches
    assert fake_card.calls == ["mark", "copy"][:launches]


# ---- gather -----------------------------------------------------------------

def _pack_gather_unpack(lanes, order, plan):
    """The packed and direct modes of the plan in numpy: records of each
    packed group built field by field, gathered whole and unpacked."""
    n = len(lanes[0]) if lanes else 0
    out = [None] * len(lanes)
    for g in plan:
        if not g.packed:
            for i in g.lanes:
                out[i] = lanes[i][order]
            continue
        rec = np.zeros((n, g.width), np.uint8)
        for i, o in zip(g.lanes, g.offsets):
            w = lanes[i].itemsize
            rec[:, o:o + w] = lanes[i].view(np.uint8).reshape(n, w)
        got = rec[order]
        for i, o in zip(g.lanes, g.offsets):
            w = lanes[i].itemsize
            out[i] = np.ascontiguousarray(got[:, o:o + w]).view(
                lanes[i].dtype).reshape(-1)
    return out


DTYPES = {1: [np.uint8, np.bool_], 2: [np.int16], 4: [np.int32, np.float32],
          8: [np.int64, np.float64, np.uint64]}


def _lanes(widths, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k, w in enumerate(widths):
        dt = DTYPES[w][k % len(DTYPES[w])]
        if dt == np.bool_:
            out.append(rng.random(n) < 0.5)
        elif np.issubdtype(dt, np.floating):
            out.append(rng.normal(size=n).astype(dt))
        else:
            out.append(rng.integers(0, 2**(8 * w - 1), n).astype(dt))
    return out


W1 = [1, 8, 1, 8]
MIXES = {
    "W1 words": W1,
    "1/2/4/8 mixed": [1, 2, 4, 8, 2, 1, 4],
    "over 32 B": [8, 8, 8, 8, 4, 1],
    "over 128 B": [8] * 17 + [4, 2, 1],
    "40 lanes": [1, 2, 4, 8] * 10,
    "bytes": [1, 1],
    "one lane": [4],
}
ORDERS = ["permutation", "m < n", "repeats", "empty"]


def _order(kind, n, rng):
    return {"permutation": rng.permutation(n),
            "m < n": rng.choice(n, n // 9, replace=False),
            "repeats": rng.integers(0, n, n + 13),
            "empty": np.zeros(0, np.int64)}[kind].astype(np.int64)


def test_record_layout():
    """Widest first, stable; fields naturally aligned and packed; records
    padded to a power of two up to 32 B, past that to a multiple of 32;
    groups cut at 128 B."""
    assert [gb.record_width(w) for w in (1, 2, 3, 5, 9, 17, 18, 32, 33, 65,
                                         97, 128)] == \
        [1, 2, 4, 8, 16, 32, 32, 32, 64, 96, 128, 128]
    (g,) = gb.gather_plan(W1, 100, 100)
    assert g.lanes == (1, 3, 0, 2) and g.offsets == (0, 8, 16, 17)
    assert (g.w, g.width, g.packed) == (18, 32, True)
    widths = [1, 2, 4, 8] * 10 + [8] * 9
    plan = gb.gather_plan(widths, 1000, 1000)
    assert [i for g in plan for i in g.lanes] == sorted(
        range(len(widths)), key=lambda i: -widths[i])
    for g in plan:
        assert g.w <= gb.GATHER_MAX_RECORD and g.width <= gb.GATHER_MAX_RECORD
        ws = [widths[i] for i in g.lanes]
        assert list(g.offsets) == list(np.cumsum([0] + ws)[:-1])
        assert all(o % w == 0 for o, w in zip(g.offsets, ws))
    assert [(g.w, g.width) for g in plan] == [(128, 128), (94, 96)]


def test_mode_follows_the_shape():
    """Packed iff m * 32 * (lanes - sectors) > n * (w + width): W1's m = n
    packs, a short index list and a single lane go direct."""
    n = 1_000_000
    assert gb.gather_plan(W1, n, n)[0].packed
    assert not gb.gather_plan(W1, n // 3, n)[0].packed     # 32 < 50
    assert gb.gather_plan(W1, int(n / 1.9), n)[0].packed    # 50.5 > 50
    assert not gb.gather_plan([8], n, n)[0].packed
    g = gb.gather_plan([8] * 16, n, n)[0]      # 128 B: 4 sectors, 16 lanes
    assert g.packed and g.width == 128         # 384 B saved > 256 moved
    assert not gb.gather_plan([8] * 16, n // 2, n)[0].packed
    assert not gb.gather_plan(W1, 0, n)[0].packed


@pytest.mark.parametrize("order_kind", ORDERS)
@pytest.mark.parametrize("mix", list(MIXES))
def test_record_model_equals_fancy_indexing(mix, order_kind):
    n = 3001
    rng = np.random.default_rng(len(mix) + len(order_kind))
    lanes = _lanes(MIXES[mix], n, 7)
    order = _order(order_kind, n, rng)
    plan = gb.gather_plan([a.itemsize for a in lanes], len(order), n)
    for got, a in zip(_pack_gather_unpack(lanes, order, plan), lanes):
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a[order])


@pytest.mark.parametrize("order_kind", ORDERS)
@pytest.mark.parametrize("mix", list(MIXES))
def test_reorder_rows_host_side_against_the_model(fake_card, mix,
                                                  order_kind):
    """reorder_rows' own groups, scratch and launches (as `gather_plan`
    predicts: 2 a packed group, 1 a direct one, none for m = 0)."""
    n = 3001
    rng = np.random.default_rng(len(mix) * 7 + len(order_kind))
    lanes = _lanes(MIXES[mix], n, 9)
    order = _order(order_kind, n, rng)
    fake_card.n = n
    before = gb.gather_lanes_kernel.launches
    got = gb.reorder_rows(torch.from_numpy(order),
                          [torch.from_numpy(a) for a in lanes])
    plan = gb.gather_plan([a.itemsize for a in lanes], len(order), n)
    want_calls = [] if len(order) == 0 else [
        c for g in plan for c in ([("pack", g.width), ("gather", g.width)]
                                  if g.packed else ["direct"])]
    assert fake_card.calls == want_calls
    assert gb.gather_lanes_kernel.launches - before == \
        (0 if len(order) == 0 else sum(g.launches for g in plan))
    for g, a in zip(got, lanes):
        np.testing.assert_array_equal(g.numpy(), a[order])


def test_reorder_rows_refuses_lanes_of_other_lengths():
    with pytest.raises(ValueError, match="row-aligned"):
        gb.reorder_rows(torch.zeros(3, dtype=torch.int64),
                        [torch.zeros(4), torch.zeros(5)])


def test_reorder_rows_matches_jax_reorder_rows_packed():
    """W1-shaped lanes (a uint8 null rank, int64 order words, a bool
    validity, float64 values) through one permutation and through an index
    list with repeats: the port's `reorder_rows` (its plain version on the
    CPU) equals the JAX package's packed row gather exactly."""
    n = 20_011
    rng = np.random.default_rng(2024)
    lanes = [(rng.random(n) < 0.05).astype(np.uint8),
             rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
             (rng.random(n) < 0.1).astype(np.uint8),
             rng.integers(0, 2**40, n).astype(np.int64),
             rng.random(n) > 0.2,
             rng.normal(size=n) * 1e6]
    for order in (rng.permutation(n), rng.integers(0, n, 5000)):
        order = order.astype(np.int64)
        port = gb.reorder_rows(torch.from_numpy(order),
                               [torch.from_numpy(a) for a in lanes])
        ref = reorder_rows_packed(jnp.asarray(order),
                                  [jnp.asarray(a) for a in lanes])
        for p, r, a in zip(port, ref, lanes):
            r = np.asarray(r)
            assert p.numpy().dtype == r.dtype == a.dtype
            np.testing.assert_array_equal(p.numpy(), r)
