"""A numpy replay of the mesh's row partition K1 (`csrc/exchange.cu`
`partition_count_kernel`, `partition_sweep_kernel`) against its plain
version, a stable sort on the destination (`partition_rows_plain`).

The sweep takes tiles in ticket order. A tile ranks its rows within their
destination, each warp over a contiguous run of the tile, 32 rows a step:
a row's peers come from ballots on the destination's bits where n_dest is
a power of two of at most 32, from `__match_any_sync` otherwise (replayed
here as both, which must agree), its rank from its warp's running count
and the lanes below it. The tile publishes each destination's count as an
aggregate status word and finds its offset by the decoupled look-back of
`lookback.cuh` (flag, epoch and count in one word; a reader waits for a
word of its own epoch and sums aggregates back to the first inclusive
word), with the earlier tiles' words in any state a concurrent run could
leave them: some inclusive, some still aggregates, some still holding the
previous pass's epoch until they are written. The replay stages each
tile's rows in destination order, writes those ranked below the cap and
clears their flags, round after round, with n_dest of 1, 3, 4 and 32, a
cap that forces rounds and a salt; its send buffers, splits and flags
equal the plain version's.
"""
import numpy as np
import pytest
import torch

from datafusion_tpu_torch.device.exchange import (partition_rows_plain,
                                                  shard_owner)

COUNT_BITS = 40
EPOCH_MASK = (1 << 22) - 1
AGGREGATE, INCLUSIVE = 1, 2


def word(flag, epoch, count):
    return (flag << 62) | (epoch << COUNT_BITS) | count


def look_back(status, t, n_dest, d, epoch, rng, publish_pending):
    """`look_back` of lookback.cuh for destination d of tile t: tiles
    t - 1, t - 2, ... summed while they are aggregates, up to the first
    inclusive word; a word of another epoch is not yet written, and the
    reader waits (here: the pending writes are made, in a random order,
    until it is)."""
    excl, s = 0, t - 1
    while True:
        st = status[s * n_dest + d]
        if (st >> COUNT_BITS) & EPOCH_MASK != epoch:
            publish_pending(rng)
            continue
        excl += st & ((1 << COUNT_BITS) - 1)
        if st >> 62 == INCLUSIVE:
            return excl
        s -= 1


def peers_of(dest, ok, n_dest):
    """Each lane's peer mask within a warp step (0 without a row), by
    ballots on the destination's bits for a power of two of at most 32,
    by matching otherwise; both ways agree."""
    lanes = len(dest)
    ballot = lambda p: sum(1 << l for l in range(lanes) if p[l])
    match = [sum(1 << m for m in range(lanes) if ok[m] and dest[m] == dest[l])
             if ok[l] else 0 for l in range(lanes)]
    if n_dest <= 32 and n_dest & (n_dest - 1) == 0:
        every = (1 << lanes) - 1
        masks = []
        for l in range(lanes):
            m = ballot(ok)
            for b in range(int(n_dest).bit_length() - 1):
                bit = ballot([(x >> b) & 1 for x in dest])
                m &= bit if (dest[l] >> b) & 1 else ~bit & every
            masks.append(m if ok[l] else 0)
        assert masks == match
        return masks
    return match


def replay(keys, pending, n_dest, cap, lanes, salt, mode, salt_r, tile,
           warps, width, rng, epoch=1):
    """One call of K1 (the count, then one sweep) in numpy. Returns (key_out,
    lane outputs, splits, rows left) and clears the sent rows' flags."""
    n = len(keys)
    k = torch.from_numpy(keys)
    if salt > 1:
        s = np.arange(n) % salt if mode == 1 else np.full(n, salt_r)
        own = shard_owner(k, n_dest, torch.from_numpy(s)).numpy()
        with np.errstate(over="ignore"):
            travel = (keys.astype(np.uint64) * np.uint64(salt) +
                      s.astype(np.uint64)).astype(np.int64)
    else:
        own, travel = shard_owner(k, n_dest).numpy(), keys
    totals = np.bincount(own[pending], minlength=n_dest)
    splits = np.minimum(totals, cap)
    send_off = np.concatenate([[0], np.cumsum(splits)[:-1]])
    m = int(splits.sum())
    key_out = np.full(m, -99, np.int64)
    outs = [np.zeros(m, x.dtype) for x in lanes]
    n_tiles = -(-n // tile)
    # words of an earlier pass, which this pass must not count
    status = np.array([word(INCLUSIVE, epoch - 1, 5)] * (n_tiles * n_dest),
                      dtype=object)
    pending_writes = []

    def publish(rng):
        if pending_writes:
            i, w = pending_writes.pop(rng.integers(len(pending_writes)))
            status[i] = w
    per_warp = tile // warps
    sent = np.zeros(n, bool)
    for t in range(n_tiles):                # the tickets' order
        base = t * tile
        wcount = np.zeros((warps, n_dest), np.int64)
        info = {}
        for w in range(warps):
            for s0 in range(0, per_warp, width):
                r = w * per_warp + s0 + np.arange(width)
                i = base + r
                ok = [bool(ii < n and pending[ii]) for ii in i]
                d = [int(own[ii]) if o else 0 for ii, o in zip(i, ok)]
                peers = peers_of(d, ok, n_dest)
                for lane in range(width):
                    if not ok[lane]:
                        continue
                    below = peers[lane] & ((1 << lane) - 1)
                    info[int(r[lane])] = (d[lane], int(wcount[w, d[lane]]) +
                                          bin(below).count("1"))
                for lane in range(width):
                    if ok[lane] and peers[lane] & ((1 << lane) - 1) == 0:
                        wcount[w, d[lane]] += bin(peers[lane]).count("1")
        count = wcount.sum(0)
        wbefore = np.cumsum(wcount, 0) - wcount
        prefix = np.zeros(n_dest, np.int64)
        for d in range(n_dest):
            i = t * n_dest + d
            if t == 0:
                status[i] = word(INCLUSIVE, epoch, int(count[d]))
                continue
            # the aggregate is seen at once or later; the inclusive word
            # after this tile's look-back
            pending_writes.append((i, word(AGGREGATE, epoch, int(count[d]))))
            if rng.random() < 0.5:
                publish(rng)
            prefix[d] = look_back(status, t, n_dest, d, epoch, rng, publish)
            pending_writes[:] = [(j, x) for j, x in pending_writes if j != i]
            done = word(INCLUSIVE, epoch, int(prefix[d] + count[d]))
            if rng.random() < 0.5:
                status[i] = done
            else:
                pending_writes.append((i, done))
        start = np.concatenate([[0], np.cumsum(count)])
        stage = {}
        for r, (d, rank) in info.items():
            stage[int(start[d] + wbefore[r // per_warp, d] + rank)] = (d, r)
        assert sorted(stage) == list(range(int(start[-1])))
        for p in range(int(start[-1])):
            d, r = stage[p]
            g = prefix[d] + p - start[d]
            if g >= cap:
                continue
            pos = send_off[d] + g
            i = base + r
            key_out[pos] = travel[i]
            for o, x in zip(outs, lanes):
                o[pos] = x[i]
            sent[i] = True
    pending &= ~sent
    return key_out, outs, splits.tolist(), bool((totals > cap).any())


@pytest.mark.parametrize("n,n_dest,cap,salt,mode,tile,warps", [
    (3000, 1, 700, 1, 1, 256, 8),
    (5000, 3, 400, 1, 1, 512, 8),
    (5000, 4, 5000, 1, 1, 256, 4),
    (4100, 4, 300, 3, 1, 2048, 8),
    (6000, 32, 90, 1, 1, 256, 8),
    (2500, 32, 60, 5, 2, 128, 4),
    (0, 4, 10, 1, 1, 256, 8)])
def test_sweep_replay_matches_plain(n, n_dest, cap, salt, mode, tile, warps):
    rng = np.random.default_rng(n + 7 * n_dest)
    keys = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    keys[rng.random(n) < 0.25] = 17                        # a hot key
    lanes = [rng.integers(0, 2**40, n), rng.integers(-9, 9, n).astype(np.int32),
             rng.random(n) < 0.5]
    pend = rng.random(n) < 0.9
    mine = pend.copy()
    for epoch in range(1, 200):
        # the plain call clears the sent rows' flags of `pend` in place
        want = partition_rows_plain(
            torch.from_numpy(keys), torch.from_numpy(pend), n_dest, cap,
            [torch.from_numpy(x) for x in lanes], salt, mode, 3)
        got = replay(keys, mine, n_dest, cap, lanes, salt, mode, 3, tile,
                     warps, 32, rng, epoch)
        np.testing.assert_array_equal(got[0], want.keys.numpy())
        for a, b in zip(got[1], want.lanes):
            np.testing.assert_array_equal(a, b.numpy())
        assert got[2] == want.splits and got[3] == want.left
        np.testing.assert_array_equal(mine, pend)
        if not want.left:
            break
    assert not mine.any()


def test_ballot_peers_match_match_any():
    """The ballots on a power-of-two destination's bits give each lane the
    same peers as matching on the destination, for every n_dest up to 32."""
    rng = np.random.default_rng(0)
    for n_dest in (1, 2, 4, 8, 16, 32):
        for _ in range(20):
            d = rng.integers(0, n_dest, 32).tolist()
            ok = (rng.random(32) < 0.8).tolist()
            peers_of(d, ok, n_dest)       # asserts the two agree


def test_look_back_ignores_another_epoch():
    """A status word of the previous pass is not yet this pass's: the
    look-back waits for it and sums only this epoch's words."""
    rng = np.random.default_rng(1)
    status = np.array([word(INCLUSIVE, 1, 10), word(AGGREGATE, 2, 3),
                       word(INCLUSIVE, 1, 999)], dtype=object)
    writes = [(2, word(AGGREGATE, 2, 4)), (0, word(INCLUSIVE, 2, 5))]

    def publish(_rng):
        i, w = writes.pop(0)
        status[i] = w
    assert look_back(status, 3, 1, 0, 2, rng, publish) == 4 + 3 + 5
