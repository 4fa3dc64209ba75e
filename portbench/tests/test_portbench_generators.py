"""The generators: the same seed gives the same tables, a column does not
depend on which others are made, and the data keeps the rules it copies."""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.datagen import Streams
from portbench.tests.common import BIG_SEED


def tpch(seed, columns, scale=1e-3):
    cell = harness.Cell("tpch-sf10-chains")
    return cell.generator.tables(cell.config, Streams(seed, "cpu"),
                                 set(columns), scale)


def test_the_same_seed_gives_the_same_tables():
    a = tpch(BIG_SEED, ["l_orderkey", "l_extendedprice", "p_type"])
    b = tpch(BIG_SEED, ["l_orderkey", "l_extendedprice", "p_type"])
    c = tpch(BIG_SEED + 1, ["l_extendedprice"])
    for t in a:
        for k in a[t]:
            assert torch.equal(a[t][k].data, b[t][k].data)
    assert not torch.equal(a["lineitem"]["l_extendedprice"].data,
                           c["lineitem"]["l_extendedprice"].data)


def test_a_column_does_not_depend_on_the_others_made():
    alone = tpch(7, ["l_shipdate"])
    many = tpch(7, ["l_shipdate", "o_orderstatus", "l_tax", "c_phone"])
    assert torch.equal(alone["lineitem"]["l_shipdate"].data,
                       many["lineitem"]["l_shipdate"].data)


def test_the_tpch_rules():
    names = ["o_orderkey", "o_orderdate", "o_orderstatus", "l_orderkey",
             "l_partkey", "l_suppkey", "l_shipdate", "l_receiptdate",
             "l_linestatus", "ps_partkey", "ps_suppkey", "p_type",
             "s_name", "l_extendedprice", "l_quantity"]
    t = tpch(3, names)
    o, li, ps = t["orders"], t["lineitem"], t["partsupp"]
    ok = o["o_orderkey"].data
    assert torch.equal(ok, torch.arange(1, len(ok) + 1) * 4 - 3)
    lok = li["l_orderkey"].data
    assert bool((lok[1:] >= lok[:-1]).all())
    per = torch.bincount((lok + 3) // 4 - 1)
    assert int(per.min()) >= 1 and int(per.max()) <= 7
    # l_suppkey is one of the part's 4 partsupp suppliers
    pairs = set(zip(ps["ps_partkey"].data.tolist(),
                    ps["ps_suppkey"].data.tolist()))
    assert all(p in pairs for p in zip(li["l_partkey"].data.tolist(),
                                       li["l_suppkey"].data.tolist()))
    assert bool((li["l_receiptdate"].data > li["l_shipdate"].data).all())
    for table in t.values():
        for col in table.values():
            if col.kind == "string":
                assert col.values == sorted(col.values)
                assert int(col.data.max()) < len(col.values)
    qty = li["l_quantity"].data // 100
    assert int(qty.min()) >= 1 and int(qty.max()) <= 50
    status = o["o_orderstatus"]
    assert set(status.values) == {"F", "O", "P"}


def test_the_zipf_draws_follow_numpy_s():
    ours = Streams(5, "cpu").zipf("z", 1.5, 200_000).numpy()
    theirs = np.random.default_rng(5).zipf(1.5, 200_000)
    for k in (1, 2, 3):
        assert abs((ours == k).mean() - (theirs == k).mean()) < 0.01


# the type ClickBench's create.sql gives each column (EventTime as
# hits.parquet's int64 seconds, SearchPhrase as dictionary codes)
HITS_TYPES = {"UserID": torch.int64, "SearchPhrase": torch.int32,
              "EventTime": torch.int64, "RegionID": torch.int32,
              "AdvEngineID": torch.int16, "ResolutionWidth": torch.int16}


@pytest.mark.parametrize("column", sorted(HITS_TYPES))
def test_the_hits_columns(column):
    cell = harness.Cell("clickbench-hits-sums")
    t = cell.generator.tables(cell.config, Streams(1, "cpu"), {column},
                              1e-4)["hits"][column]
    assert len(t.data) == 9999
    assert t.data.dtype == HITS_TYPES[column]
    if column == "ResolutionWidth":
        assert set(t.data.tolist()) <= {1024, 1280, 1366, 1440, 1536, 1600,
                                        1920, 2560}
    if column == "SearchPhrase":
        assert t.values[0] == "" and (t.data == 0).float().mean() > 0.5
