"""Numpy replays of the warp-wide steps of the dense fold and the join
probe (`csrc/program.cuh` `warp_reduce`, `reduce_peers`, `dense_fold_warp`;
`csrc/join_aggregate.cu`'s bucket walk), which the one-thread build of
`test_torch_csrc_cpu.py` cannot exercise: there a warp has one lane.

Each model runs the kernel's arithmetic for a warp of 32 lanes at once,
with the CUDA intrinsics at their warp-wide meaning: `__shfl_sync` reads
the source lane's value, `__shfl_up_sync` the lane `o` below (its own
below lane `o`), `__shfl_xor_sync` lane `l ^ o`, `__ballot_sync` a bit a
lane, `__match_any_sync` the lanes of equal value. The walk must visit
every entry of every lane's bucket exactly once, with its owner's lane;
the reductions must leave each peer set's combined value in its lowest
lane.
"""
import numpy as np
import pytest

W = 32
LANE = np.arange(W)


def shfl(x, src):
    return x[np.asarray(src) & 31]


def shfl_up(x, o):
    return np.where(LANE >= o, x[np.maximum(LANE - o, 0)], x)


def ballot(pred):
    return int(np.sum(np.asarray(pred, np.int64) << LANE))


def match_any(v):
    return np.array([ballot(v == v[lane]) for lane in LANE], np.int64)


def popc(m):
    return np.array([bin(int(x) & 0xFFFFFFFF).count("1")
                     for x in np.broadcast_to(m, (W,))])


def ffs(m):
    """1-based index of the lowest set bit, 0 for none."""
    m = np.broadcast_to(m, (W,)).astype(np.int64) & 0xFFFFFFFF
    return np.array([(int(v) & -int(v)).bit_length() for v in m], np.int64)


# --- the join probe's bucket walk (join_aggregate.cu) -------------------------

def warp_walk(begin, length):
    """(owner lane, entry) of every item the kernel's step loop folds, in
    its order: the inclusive scan of the bucket lengths, the total from
    lane 31, then 32 items a step, each lane's owner by the binary search
    of the scan and its entry at i + (begin - exclusive offset) of the
    owner."""
    incl = np.asarray(length, np.int64).copy()
    o = 1
    while o < W:
        t = shfl_up(incl, o)
        incl = np.where(LANE >= o, incl + t, incl)
        o <<= 1
    total = int(shfl(incl, np.full(W, W - 1))[0])
    delta = np.asarray(begin, np.int64) - (incl - length)
    out = []
    for s in range(0, total, W):
        i = s + LANE
        owner = np.zeros(W, np.int64)
        for step in (16, 8, 4, 2, 1):
            owner = np.where(shfl(incl, owner + step - 1) <= i,
                             owner + step, owner)
        e = i + shfl(delta, owner)
        pair = i < total
        out += list(zip(owner[pair].tolist(), e[pair].tolist()))
    return out


def _lengths(rng, case):
    if case == "mixed":
        return rng.choice([0, 0, 1, 1, 2, 4, 7, 33, 64], W)
    if case == "hot_key":
        n = rng.choice([0, 1, 4], W)
        n[rng.integers(W)] = 100_000
        return n
    if case == "all_hot":
        return np.full(W, 1000)
    if case == "empty":
        return np.zeros(W, np.int64)
    if case == "last_only":
        n = np.zeros(W, np.int64)
        n[-1] = 70
        return n
    return rng.integers(0, 9, W)


@pytest.mark.parametrize("case", ["mixed", "hot_key", "all_hot", "empty",
                                  "last_only", "uniform"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_walk_folds_every_pair_once(case, seed):
    """Every entry of every lane's bucket is visited exactly once, by its
    owner's lane, over random fanouts, a hot key, every lane on one hot
    bucket (the same `begin`), no entries at all and only the last lane's."""
    rng = np.random.default_rng(seed)
    length = _lengths(rng, case)
    begin = rng.integers(0, 1 << 20, W)
    if case == "all_hot":
        begin[:] = begin[0]
    got = warp_walk(begin, length)
    want = [(lane, int(begin[lane]) + j) for lane in range(W)
            for j in range(int(length[lane]))]
    assert sorted(got) == sorted(want)
    assert len(got) == len(set(got)) == int(length.sum())


# --- the dense fold's reductions (program.cuh) --------------------------------

def combine(kind, a, b):
    return {"sum": a + b, "min": np.minimum(a, b),
            "max": np.maximum(a, b)}[kind]


def warp_reduce(kind, x, members=0xFFFFFFFF):
    """The butterfly of `warp_reduce`: five xor shuffles, a partner taken
    only when it is a member."""
    x = np.asarray(x).copy()
    o = 16
    while o:
        t = shfl(x, LANE ^ o)
        take = ((members >> (LANE ^ o)) & 1) == 1
        x = np.where(take, combine(kind, x, t), x)
        o >>= 1
    return x


def reduce_peers(kind, peers, x):
    """The tree of `reduce_peers`: each lane adds in the next peer still in
    play, the lanes whose rank bit is set drop out, log2(set size)
    rounds; the result is in each set's lowest lane."""
    x = np.asarray(x).copy()
    peers = np.asarray(peers, np.int64) & 0xFFFFFFFF
    rank = popc(peers & ((1 << LANE) - 1))
    peers = peers & ~((2 << LANE) - 1) & 0xFFFFFFFF
    while (peers != 0).any():
        nxt = ffs(peers)
        t = shfl(x, (nxt - 1) & 31)
        x = np.where(nxt != 0, combine(kind, x, t), x)
        peers = peers & ~ballot((rank & 1) == 1)
        rank = rank >> 1
    return x


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("groups", [1, 2, 4, 17, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_reduce_peers_leaves_each_set_in_its_lowest_lane(kind, groups, seed):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, groups, W)
    if groups == 64:
        slot[rng.random(W) < 0.8] = 5     # one hot slot
    x = rng.integers(-1000, 1000, W)
    peers = match_any(slot)
    got = reduce_peers(kind, peers, x)
    ident = {"sum": 0, "min": 1 << 40, "max": -(1 << 40)}[kind]
    for s in np.unique(slot):
        lanes = np.flatnonzero(slot == s)
        want = ident
        for v in x[lanes]:
            want = combine(kind, want, v)
        lead = ffs(ballot(slot == s))[0] - 1
        assert lead == lanes[0] and got[lead] == want


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_warp_reduce_combines_the_whole_warp(kind):
    rng = np.random.default_rng(3)
    x = rng.integers(-1000, 1000, W)
    got = warp_reduce(kind, x)
    want = {"sum": x.sum(), "min": x.min(), "max": x.max()}[kind]
    assert (got == want).all()


def test_dense_fold_warp_counts_by_ballot():
    """The count row and the count-like lanes: popc(ballot(x != 0) & peers)
    in each set's lowest admitted lane equals the set's admitted rows;
    rows not admitted form a set of their own (slot -1) that no lead
    writes."""
    rng = np.random.default_rng(4)
    adm = rng.random(W) < 0.7
    slot = np.where(adm, rng.integers(0, 3, W), -1)
    peers = match_any(slot)
    lead = adm & (LANE == ffs(peers) - 1)
    counts = popc(ballot(adm) & peers)
    for s in range(3):
        lanes = np.flatnonzero(slot == s)
        if len(lanes):
            assert lead[lanes[0]] and counts[lanes[0]] == len(lanes)
            assert not lead[lanes[1:]].any()
    assert not lead[slot == -1].any()
