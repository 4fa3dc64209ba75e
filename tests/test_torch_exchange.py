"""The port's exchange (`datafusion_tpu_torch/parallel/`) against the JAX
package's (`datafusion_tpu/parallel/`) on the CPU.

Every case of `tests/test_exchange.py` runs the same seeded numpy inputs
through the JAX function on its 8-device CPU mesh (`tests/conftest.py`)
and the port's counterpart on an 8-shard `LocalMesh` on the CPU, whose
kernels run their plain versions there. Tolerance: the group tables are
compared exactly (integer sums, counts and keys); the float sums of the
group aggregate within rel 1e-9. Where the reference's static shapes show
(one compile a program shape), the port's counterpart is its rounds: a
tiny per-round cap costs rounds, with the same result.
"""
from collections import defaultdict

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from datafusion_tpu.parallel import exchange as jx  # noqa: E402
from datafusion_tpu.parallel.distributed import (  # noqa: E402
    distributed_group_aggregate as jax_group,
    distributed_join_aggregate as jax_join,
    distributed_join_group_aggregate as jax_join_group,
)
from datafusion_tpu_torch.parallel import exchange as tx  # noqa: E402
from datafusion_tpu_torch.parallel import (  # noqa: E402
    distributed_group_aggregate, distributed_join_aggregate,
    distributed_join_group_aggregate, make_mesh,
)


@pytest.fixture(scope="module")
def meshes():
    from datafusion_tpu.parallel.distributed import make_mesh as jax_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (xla_force_host_platform_device_count)")
    return jax_mesh(8), make_mesh(8, torch.device("cpu"))


def _table_to_dict(gk, gv, agg):
    gk, gv, agg = (np.asarray(x) for x in (gk, gv, agg))
    return {int(k): a.item() for k, v, a in zip(gk, gv, agg) if v}


def _oracle_group_sum(keys, valid, vals):
    out = {}
    for k, v in zip(keys[valid], vals[valid]):
        out[int(k)] = out.get(int(k), 0) + int(v)
    return out


def _shuffle_both(meshes, keys, valid, values, **kw):
    jm, tm = meshes
    a = jx.distributed_shuffle_group_aggregate(jm, keys, valid, values, **kw)
    b = tx.distributed_shuffle_group_aggregate(tm, keys, valid, values, **kw)
    return a, b


@pytest.mark.parametrize("case", ["high_cardinality", "skewed_keys"])
def test_shuffle_aggregate_matches_jax(meshes, case):
    """(a) 600 distinct keys over 8 x 128 owned slots; (c) zipf keys, the
    hot key collapsing to one partial slot a shard. Exact."""
    if case == "high_cardinality":
        rng = np.random.default_rng(7)
        n = 8 * 512
        keys = rng.integers(0, 600, n).astype(np.int64)
        vals = rng.integers(0, 100, n).astype(np.int64)
        valid = rng.random(n) > 0.05
        kw = dict(partial_groups=600, final_groups_per_shard=128)
    else:
        rng = np.random.default_rng(11)
        n = 8 * 512
        keys = np.minimum(rng.zipf(1.3, n), 400).astype(np.int64)
        vals = rng.integers(0, 10, n).astype(np.int64)
        valid = np.ones(n, bool)
        kw = dict(partial_groups=512, final_groups_per_shard=128)
    (jk, jv, ja, jo), (tk, tv, ta, to) = _shuffle_both(
        meshes, keys, valid, {"s": ("sum", vals)}, **kw)
    assert jo == 0 and to == 0
    want = _oracle_group_sum(keys, valid, vals)
    assert _table_to_dict(jk, jv, ja["s"]) == want
    assert _table_to_dict(tk, tv, ta["s"]) == want


def test_shuffle_aggregate_overflow_reported(meshes):
    """2000 distinct keys into 8 x 16 final slots: both report overflow."""
    rng = np.random.default_rng(3)
    n = 8 * 256
    keys = rng.integers(0, 2000, n).astype(np.int64)
    vals = np.ones(n, np.int64)
    (_jk, _jv, _ja, jo), (_tk, _tv, _ta, to) = _shuffle_both(
        meshes, keys, np.ones(n, bool), {"c": ("count", vals)},
        partial_groups=2048, final_groups_per_shard=16)
    assert jo > 0 and to > 0


def test_shuffle_partial_overflow_reported(meshes):
    """A partial table past `partial_groups` is reported too."""
    jm, tm = meshes
    keys = np.arange(8 * 64, dtype=np.int64)
    _gk, _gv, _a, ovf = tx.distributed_shuffle_group_aggregate(
        tm, keys, np.ones(len(keys), bool), {"c": ("count", keys)},
        partial_groups=16, final_groups_per_shard=1024)
    assert ovf > 0


def test_chained_shuffle_zipf_rounds(meshes):
    """zipf(1.05) keys through a per-round cap of 8 slots: the reference
    absorbs the skew with while_loop rounds of one compiled program; the
    port with more rounds of exact splits. Two data draws, both exact."""
    rng = np.random.default_rng(42)
    n = 8 * 512
    keys = np.minimum(rng.zipf(1.05, n), 300).astype(np.int64)
    valid = np.ones(n, bool)
    for seed in (1, 2):
        v2 = np.random.default_rng(seed).integers(0, 10, n).astype(np.int64)
        (jk, jv, ja, jo), (tk, tv, ta, to) = _shuffle_both(
            meshes, keys, valid, {"s": ("sum", v2)}, partial_groups=512,
            final_groups_per_shard=128, slot_cap=8)
        assert jo == 0 and to == 0
        want = _oracle_group_sum(keys, valid, v2)
        assert _table_to_dict(jk, jv, ja["s"]) == want
        assert _table_to_dict(tk, tv, ta["s"]) == want
        assert tx.ROUNDS["shuffle"] > 1


def _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals):
    build = defaultdict(list)
    for i in range(len(bk)):
        if bval[i]:
            build[int(bk[i])].append(i)
    sums = defaultdict(int)
    for j in range(len(pk)):
        if not pval[j]:
            continue
        for i in build.get(int(pk[j]), ()):
            sums[int(pg[j]) | int(bg[i])] += int(bpay[i]) + int(pvals[j])
    return dict(sums)


def _pjoin_sums(gk, gv, aggs):
    s = _table_to_dict(gk, gv, aggs["s"])
    t = _table_to_dict(gk, gv, aggs["t"])
    return {g: s.get(g, 0) + t.get(g, 0) for g in set(s) | set(t)}


def _pjoin_both(meshes, *args, **kw):
    jm, tm = meshes
    return (jx.distributed_partitioned_join_aggregate(jm, *args, **kw),
            tx.distributed_partitioned_join_aggregate(tm, *args, **kw))


def test_partitioned_join_large_both_sides(meshes):
    """(b) neither side fits a broadcast: 4096 x 4096 rows, 10% of each
    side invalid. Exact, against the oracle too."""
    rng = np.random.default_rng(5)
    nb = n = 8 * 512
    bk = rng.integers(0, 700, nb).astype(np.int64)
    bval = rng.random(nb) > 0.1
    bg = (rng.integers(0, 4, nb).astype(np.int64) << 8)
    bpay = rng.integers(0, 50, nb).astype(np.int64)
    pk = rng.integers(0, 700, n).astype(np.int64)
    pval = rng.random(n) > 0.1
    pg = rng.integers(0, 8, n).astype(np.int64)
    pvals = rng.integers(0, 50, n).astype(np.int64)
    (j, t) = _pjoin_both(
        meshes, bk, bval, bg, {"s": bpay}, pk, pval, pg, {"t": pvals},
        kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
        final_groups_per_shard=16, build_cap=2 * 512, probe_cap=2 * 512,
        fanout_cap=16)
    assert j[3] == 0 and t[3] == 0
    want = _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals)
    assert _pjoin_sums(*j[:3]) == want
    assert _pjoin_sums(*t[:3]) == want


@pytest.mark.parametrize("salt", [1, 4])
def test_partitioned_join_skewed_salted(meshes, salt):
    """Zipf-skewed probe keys, unsalted and salt = 4 (build rows replicate
    4 ways on (key, s)): exact either way."""
    rng = np.random.default_rng(17)
    nb, n = 8 * 64, 8 * 512
    bk = np.arange(nb).astype(np.int64) % 50
    bval = np.ones(nb, bool)
    bg = np.zeros(nb, np.int64)
    bpay = rng.integers(0, 5, nb).astype(np.int64)
    pk = np.minimum(rng.zipf(1.2, n), 50).astype(np.int64) - 1
    pval = np.ones(n, bool)
    pg = (pk % 8).astype(np.int64)
    pvals = rng.integers(0, 5, n).astype(np.int64)
    want = _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals)
    (j, t) = _pjoin_both(
        meshes, bk, bval, bg, {"s": bpay}, pk, pval, pg, {"t": pvals},
        kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
        final_groups_per_shard=16, build_cap=nb * salt, probe_cap=n,
        fanout_cap=nb, salt=salt)
    assert j[3] == 0 and t[3] == 0
    assert _pjoin_sums(*j[:3]) == want
    assert _pjoin_sums(*t[:3]) == want


def test_chained_partitioned_join_zipf_rounds(meshes):
    """zipf(1.05) probe keys, a probe cap of 16 rows a destination and an
    exact build cap from `host_owner`: the hot key's rows stream through
    more rounds; two data draws, both exact."""
    rng = np.random.default_rng(9)
    nb, n = 8 * 64, 8 * 512
    bk = (np.arange(nb) % 50).astype(np.int64)
    bval = np.ones(nb, bool)
    bg = np.zeros(nb, np.int64)
    bpay = rng.integers(0, 5, nb).astype(np.int64)
    pk = np.minimum(rng.zipf(1.05, n), 50).astype(np.int64) - 1
    pval = np.ones(n, bool)
    pg = (pk % 8).astype(np.int64)
    own = tx.host_owner(bk, 8)
    assert np.array_equal(own, jx.host_owner(bk, 8))
    senders = np.arange(nb) // (nb // 8)
    per = np.bincount(senders * 9 + own, minlength=8 * 9).reshape(8, 9)
    build_cap = int(per[:, :8].max()) + 8
    for seed in (1, 2):
        pvals = np.random.default_rng(seed).integers(0, 5, n).astype(np.int64)
        (j, t) = _pjoin_both(
            meshes, bk, bval, bg, {"s": bpay}, pk, pval, pg, {"t": pvals},
            kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
            final_groups_per_shard=16, build_cap=build_cap, probe_cap=16,
            fanout_cap=16, salt=1)
        assert j[3] == 0 and t[3] == 0
        want = _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals)
        assert _pjoin_sums(*j[:3]) == want
        assert _pjoin_sums(*t[:3]) == want
        assert tx.ROUNDS["probe"] > 1


@pytest.mark.parametrize("which", ["fanout", "build_cap"])
def test_partitioned_join_capacity_reported(meshes, which):
    """A build key past `fanout_cap`, or more build rows from one shard to
    one owner than `build_cap`: both packages report overflow."""
    rng = np.random.default_rng(21)
    nb, n = 8 * 64, 8 * 64
    bk = (np.arange(nb) % 16).astype(np.int64)        # 32 rows a key
    pk = rng.integers(0, 16, n).astype(np.int64)
    args = (bk, np.ones(nb, bool), np.zeros(nb, np.int64),
            {"s": np.ones(nb, np.int64)}, pk, np.ones(n, bool),
            np.zeros(n, np.int64), {"t": np.ones(n, np.int64)})
    kw = dict(kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
              final_groups_per_shard=16, probe_cap=n, salt=1)
    if which == "fanout":
        kw.update(build_cap=nb, fanout_cap=8)
    else:
        kw.update(build_cap=4, fanout_cap=64)
    (j, t) = _pjoin_both(meshes, *args, **kw)
    assert j[3] > 0 and t[3] > 0


def test_salting_spreads_hot_key(meshes):
    """The salted owner spreads one hot key over shards, bit for bit the
    JAX `_owner`."""
    import jax.numpy as jnp
    hot = np.full(64, 7, np.int64)
    salt = np.arange(64, dtype=np.uint64) % 4
    for s in (None, salt):
        want = np.asarray(jx._owner(jnp.asarray(hot), 8, None if s is None
                                    else jnp.asarray(s)))
        got = tx.shard_owner(torch.from_numpy(hot), 8, None if s is None
                             else torch.from_numpy(s.astype(np.int64)))
        assert np.array_equal(got.numpy(), want)
    assert len(np.unique(tx.shard_owner(torch.from_numpy(hot), 8).numpy())) \
        == 1
    assert len(np.unique(tx.shard_owner(
        torch.from_numpy(hot), 8,
        torch.from_numpy(salt.astype(np.int64))).numpy())) > 1


@pytest.mark.parametrize("n_shards", [3, 7, 8])
def test_owner_hash_bit63_matches_host(meshes, n_shards):
    """Keys whose splitmix64 has bit 63 set (negative as int64): the
    unsigned modulus of `shard_owner` equals `host_owner` (numpy uint64)
    and the JAX `_owner`, with and without salt."""
    import jax.numpy as jnp
    from datafusion_tpu.physical.hashing import _splitmix64
    rng = np.random.default_rng(n_shards)
    keys = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    assert (_splitmix64(keys.astype(np.uint64)) >> np.uint64(63)).any()
    salt = rng.integers(0, 8, 4096).astype(np.uint64)
    for s in (None, salt):
        host = tx.host_owner(keys, n_shards, s)
        assert np.array_equal(host, jx.host_owner(keys, n_shards, s))
        got = tx.shard_owner(torch.from_numpy(keys), n_shards,
                             None if s is None
                             else torch.from_numpy(s.astype(np.int64)))
        assert np.array_equal(got.numpy(), host)
        want = np.asarray(jx._owner(jnp.asarray(keys), n_shards,
                                    None if s is None else jnp.asarray(s)))
        assert np.array_equal(want, host)


def test_group_aggregate_matches_jax(meshes):
    """`distributed_group_aggregate` (the all_gather route): sums and
    counts exact, float sums within rel 1e-9, min and max exact."""
    jm, tm = meshes
    rng = np.random.default_rng(2)
    n = 8 * 600
    keys = rng.integers(0, 300, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    vals = {"s": ("sum", rng.integers(-50, 50, n).astype(np.int64)),
            "f": ("sum", rng.normal(size=n)),
            "c": ("count", np.zeros(n, np.int64)),
            "mn": ("min", rng.integers(-9, 9, n).astype(np.int64)),
            "mx": ("max", rng.normal(size=n))}
    jk, jv, ja = jax_group(jm, keys, valid, vals, 512)
    tk, tv, ta = distributed_group_aggregate(tm, keys, valid, vals, 512)
    for name in vals:
        want = _table_to_dict(jk, jv, ja[name])
        got = _table_to_dict(tk, tv, ta[name])
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9)


def test_join_group_aggregate_matches_jax(meshes):
    """`distributed_join_group_aggregate` (the broadcast join): a build
    side with duplicate keys, probe rows of which 10% are invalid. Exact."""
    jm, tm = meshes
    rng = np.random.default_rng(4)
    nb, n = 300, 8 * 400
    bk = np.sort(rng.integers(0, 200, nb).astype(np.int64))
    bg = (rng.integers(0, 3, nb).astype(np.int64) << 4)
    bpay = rng.integers(0, 50, nb).astype(np.int64)
    pk = rng.integers(0, 250, n).astype(np.int64)
    pv = rng.random(n) > 0.1
    pg = rng.integers(0, 8, n).astype(np.int64)
    pvals = rng.integers(0, 50, n).astype(np.int64)
    fan = int(np.bincount(bk).max())
    args = (bk, bg, {"s": bpay}, pk, pv, pg, {"t": pvals},
            {"s": "sum", "t": "sum"}, {"s": 0, "t": 0}, 64, fan)
    j = jax_join_group(jm, *args)
    t = distributed_join_group_aggregate(tm, *args)
    want = _join_oracle(bk, np.ones(nb, bool), bg, bpay, pk, pv, pg, pvals)
    assert _pjoin_sums(*j) == want
    assert _pjoin_sums(*t) == want


def test_join_aggregate_matches_jax(meshes):
    """`distributed_join_aggregate`: sum(build payload + probe value) and
    the pair count per group, exact; with every build key within the
    fanout cap, and with a cap of 1 under which both packages keep each
    key's first build row."""
    jm, tm = meshes
    rng = np.random.default_rng(6)
    nb, n = 200, 8 * 256
    bk = np.repeat(np.arange(100), 2).astype(np.int64)
    bp = rng.integers(0, 9, nb).astype(np.int64)
    pk = rng.integers(0, 150, n).astype(np.int64)
    pv = rng.integers(0, 9, n).astype(np.int64)
    g = rng.integers(0, 12, n).astype(np.int64)
    import jax.numpy as jnp
    for cap in (4, 1):
        jk, jv, ja = jax_join(jm, *map(jnp.asarray, (bk, bp, pk, pv, g)),
                              16, fanout_cap=cap)
        tk, tv, ta = distributed_join_aggregate(tm, bk, bp, pk, pv, g, 16,
                                                fanout_cap=cap)
        for name in ("s", "c"):
            assert _table_to_dict(tk, tv, ta[name]) == \
                _table_to_dict(jk, jv, ja[name])
