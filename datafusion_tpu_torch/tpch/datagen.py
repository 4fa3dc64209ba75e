"""Seeded TPC-H data generator.

Row counts follow the spec (per scale factor SF): supplier 10k, part
200k, partsupp 800k, customer 150k, orders 1.5M, lineitem ~6M, nation 25,
region 5. Distributions approximate dbgen (uniform foreign keys, 1-7
lineitems per order, spec date ranges, spec enumerated strings) with
deterministic numpy seeding.
"""
from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
_CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
           "dim", "dodger", "drab", "firebrick", "floral", "forest",
           "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
           "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
           "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
           "magenta", "maroon", "medium", "metallic", "midnight", "mint",
           "misty", "moccasin", "navajo", "navy", "olive", "orange",
           "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
           "powder", "puff", "purple", "red", "rose", "rosy", "royal",
           "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
           "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
           "tomato", "turquoise", "violet", "wheat", "white", "yellow"]


def _from_pool(pool, idx) -> np.ndarray:
    """Vectorized categorical strings: pool gather by index."""
    arr = np.asarray(pool, dtype=object)
    return arr[np.asarray(idx)]


def _numbered(prefix: str, nums: np.ndarray, pad: int) -> np.ndarray:
    """Vectorized '<prefix><number>' strings (zero-padded when pad > 0)."""
    nums = np.asarray(nums)
    digits = nums.astype(f"U{max(pad, 20)}")
    if pad:
        digits = np.char.zfill(nums.astype("U20"), pad)
    return np.char.add(prefix, digits).astype(object)


def _pair_pool(pool, idx_a, idx_b) -> np.ndarray:
    """Vectorized '<pool[a]> <pool[b]>' strings."""
    arr = np.asarray(pool, dtype="U24")
    return np.char.add(np.char.add(arr[np.asarray(idx_a)], " "),
                       arr[np.asarray(idx_b)]).astype(object)


def _phones(rng, nation, keys) -> np.ndarray:
    cc = (11 + np.asarray(nation)).astype("U2")
    a = (np.asarray(keys) % 900 + 100).astype("U3")
    b = (np.asarray(keys) % 9000 + 1000).astype("U4")
    return np.char.add(np.char.add(np.char.add(cc, "-"),
                                   np.char.add(a, "-")), b).astype(object)


def generate_tpch(sf: float = 0.01, seed: int = 0) -> Dict[str, dict]:
    """Returns {table_name: {column: np.ndarray}} for all 8 tables."""
    rng = np.random.default_rng(seed)
    n_supp = max(int(10_000 * sf), 20)
    n_part = max(int(200_000 * sf), 200)
    n_cust = max(int(150_000 * sf), 150)
    n_ord = max(int(1_500_000 * sf), 1500)
    n_ps_per_part = 4

    # ---- region / nation --------------------------------------------------
    region = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(_REGIONS, dtype=object),
        "r_comment": np.array([f"region comment {i}" for i in range(5)], dtype=object),
    }
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.array([n for n, _ in _NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in _NATIONS], dtype=np.int64),
        "n_comment": np.array([f"nation comment {i}" for i in range(25)], dtype=object),
    }

    # ---- supplier ----------------------------------------------------------
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    supp_nation = rng.integers(0, 25, n_supp)
    complaints = rng.random(n_supp) < 0.0005
    supplier = {
        "s_suppkey": sk,
        "s_name": _numbered("Supplier#", sk, 9),
        "s_address": _numbered("addr", sk, 0),
        "s_nationkey": supp_nation.astype(np.int64),
        "s_phone": _phones(rng, supp_nation, sk),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": np.where(complaints,
                              "Customer Complaints lie",
                              _numbered("supplier comment ", sk % 1000, 0)
                              ).astype(object),
    }

    # ---- part ----------------------------------------------------------------
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    t1 = rng.integers(0, len(_TYPE_S1), n_part)
    t2 = rng.integers(0, len(_TYPE_S2), n_part)
    t3 = rng.integers(0, len(_TYPE_S3), n_part)
    c1 = rng.integers(0, len(_CONTAINER_S1), n_part)
    c2 = rng.integers(0, len(_CONTAINER_S2), n_part)
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    colors = rng.integers(0, len(_COLORS), (n_part, 2))
    part = {
        "p_partkey": pk,
        "p_name": _pair_pool(_COLORS, colors[:, 0], colors[:, 1]),
        "p_mfgr": _from_pool([f"Manufacturer#{m}" for m in range(1, 6)],
                             brand_m - 1),
        "p_brand": _from_pool([f"Brand#{m}{n}" for m in range(1, 6)
                               for n in range(1, 6)],
                              (brand_m - 1) * 5 + (brand_n - 1)),
        "p_type": _from_pool([f"{a} {b} {c}" for a in _TYPE_S1
                              for b in _TYPE_S2 for c in _TYPE_S3],
                             (t1 * len(_TYPE_S2) + t2) * len(_TYPE_S3) + t3),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": _from_pool([f"{a} {b}" for a in _CONTAINER_S1
                                   for b in _CONTAINER_S2],
                                  c1 * len(_CONTAINER_S2) + c2),
        "p_retailprice": np.round(
            (90000 + (pk % 20001) / 10 + 100 * (pk % 1000)) / 100, 2),
        "p_comment": _numbered("part comment ", pk % 1000, 0),
    }

    # ---- partsupp ----------------------------------------------------------
    ps_part = np.repeat(pk, n_ps_per_part)
    n_ps = len(ps_part)
    ps_supp = ((ps_part - 1 + (np.arange(n_ps) % n_ps_per_part) *
                (n_supp // n_ps_per_part + 1)) % n_supp) + 1
    partsupp = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp.astype(np.int64),
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int32),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
        "ps_comment": _numbered("ps comment ", np.arange(n_ps) % 1000, 0),
    }

    # ---- customer ----------------------------------------------------------
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    cust_nation = rng.integers(0, 25, n_cust)
    customer = {
        "c_custkey": ck,
        "c_name": _numbered("Customer#", ck, 9),
        "c_address": _numbered("caddr", ck, 0),
        "c_nationkey": cust_nation.astype(np.int64),
        "c_phone": _phones(rng, cust_nation, ck),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": _from_pool(_SEGMENTS, rng.integers(0, 5, n_cust)),
        "c_comment": _numbered("customer comment ", ck % 1000, 0),
    }

    # ---- orders ------------------------------------------------------------
    ok = np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3  # sparse keys like dbgen
    o_cust = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    lo, hi = _days(1992, 1, 1), _days(1998, 8, 2)
    o_date = rng.integers(lo, hi - 151, n_ord)
    orders = {
        "o_orderkey": ok,
        "o_custkey": o_cust,
        "o_orderstatus": None,  # filled below from lineitem
        "o_totalprice": None,
        "o_orderdate": o_date.astype("datetime64[D]"),
        "o_orderpriority": _from_pool(_PRIORITIES, rng.integers(0, 5, n_ord)),
        "o_clerk": _numbered("Clerk#",
                             rng.integers(1, max(n_ord // 1000, 2), n_ord), 9),
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_comment": _numbered("order comment ", np.arange(n_ord) % 1000, 0),
    }

    # ---- lineitem -------------------------------------------------------------
    n_lines = rng.integers(1, 8, n_ord)
    l_order = np.repeat(ok, n_lines)
    l_odate = np.repeat(o_date, n_lines)
    n_li = len(l_order)
    starts = np.concatenate([[0], np.cumsum(n_lines)[:-1]])
    l_linenumber = (np.arange(n_li) - np.repeat(starts, n_lines) + 1).astype(np.int32)
    l_part = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # supplier chosen among the 4 that stock the part (referential integrity)
    which = rng.integers(0, n_ps_per_part, n_li)
    l_supp = ((l_part - 1 + which * (n_supp // n_ps_per_part + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n_li).astype(np.float64)
    extprice = np.round(qty * (90000 + (l_part % 20001) / 10 +
                               100 * (l_part % 1000)) / 100, 2)
    discount = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    ship = l_odate + rng.integers(1, 122, n_li)
    commit = l_odate + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    today = _days(1995, 6, 17)
    returnflag = np.where(receipt <= today,
                          np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    linestatus = np.where(ship > today, "O", "F")
    lineitem = {
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp.astype(np.int64),
        "l_linenumber": l_linenumber,
        "l_quantity": qty,
        "l_extendedprice": extprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": returnflag.astype(object),
        "l_linestatus": linestatus.astype(object),
        "l_shipdate": ship.astype("datetime64[D]"),
        "l_commitdate": commit.astype("datetime64[D]"),
        "l_receiptdate": receipt.astype("datetime64[D]"),
        "l_shipinstruct": _from_pool(_INSTRUCTIONS, rng.integers(0, 4, n_li)),
        "l_shipmode": _from_pool(_SHIPMODES, rng.integers(0, 7, n_li)),
        "l_comment": _numbered("li ", np.arange(n_li) % 1000, 0),
    }

    # order totals + status derived from lineitems
    totals = np.zeros(n_ord)
    np.add.at(totals, np.repeat(np.arange(n_ord), n_lines),
              extprice * (1 - discount) * (1 + tax))
    all_f = np.ones(n_ord, bool)
    any_f = np.zeros(n_ord, bool)
    is_f = linestatus == "F"
    np.logical_and.at(all_f, np.repeat(np.arange(n_ord), n_lines), is_f)
    np.logical_or.at(any_f, np.repeat(np.arange(n_ord), n_lines), is_f)
    orders["o_orderstatus"] = np.where(all_f, "F",
                                       np.where(any_f, "P", "O")).astype(object)
    orders["o_totalprice"] = np.round(totals, 2)

    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


# TPC-H money/quantity columns are DECIMAL(15,2) per the spec (and the
# reference's dbgen tables); exact decimal arithmetic also makes results
# deterministic where float reductions are not (Q2's min-equality).
_DECIMAL_COLS = {
    "s_acctbal", "p_retailprice", "ps_supplycost", "c_acctbal",
    "o_totalprice", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
}


def register_tpch(ctx, sf: float = 0.01, seed: int = 0,
                  n_partitions: int = 1) -> None:
    """Generate and register all 8 tables as in-memory tables
    (the reference's `tpch_mem` mode)."""
    from ..common import dt
    from ..common.batch import Batch
    from ..common.column import Column
    from ..common.schema import Field, Schema
    from ..datasource.memory import MemTable
    data = generate_tpch(sf, seed)
    for name, cols in data.items():
        base = Batch.from_arrays(cols, None)
        fields, out_cols = [], []
        for f, c in zip(base.schema.fields, base.columns):
            if f.name in _DECIMAL_COLS:
                t = dt.decimal(15, 2)
                scaled = np.round(np.asarray(
                    c.data_host(), np.float64) * 100.0).astype(np.int64)
                c = Column(t, scaled, c.validity_host())
                f = Field(f.name, t, f.nullable)
            fields.append(f)
            out_cols.append(c)
        batch = Batch(Schema(fields), out_cols, base.num_rows)
        ctx.register_table(name, MemTable.from_batches(
            [batch], n_partitions))
