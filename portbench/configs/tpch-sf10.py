"""TPC-H's tables on the device, from the seed, by the rules of the port's
`tpch/datagen.py` as `chip_smoke.py`'s `tpch_tables` vectorises them:
`o_orderkey` is 4i - 3, each order has 1 to 7 lines, foreign keys are
uniform, `l_suppkey` is one of its part's 4 suppliers, money is
Decimal(15,2) at scale 2, dates are days since 1970-01-01 and text is a
dictionary of strings. The constants are copied here, so that a change to
the port cannot move the data. Only the columns asked for are made (with
the columns they derive from)."""
from __future__ import annotations

import datetime
from functools import cached_property

import torch

from portbench.datagen import Col, Streams, numbered, strings

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
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
PER_PART = 4


def days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


TODAY = days(1995, 6, 17)     # returnflag and linestatus turn on it


def table_of(column: str) -> str:
    return {"r": "region", "n": "nation", "s": "supplier", "p": "part",
            "ps": "partsupp", "c": "customer", "o": "orders",
            "l": "lineitem"}[column.split("_", 1)[0]]


class TPCH:
    """The columns, each made once on first use."""

    def __init__(self, cfg: dict, streams: Streams, scale: float):
        rows = cfg["rows"]
        self.s = streams
        self.dev = streams.device
        self.n_supp = max(int(rows["supplier"] * scale), 2 * PER_PART)
        self.n_part = max(int(rows["part"] * scale), 2 * PER_PART)
        self.n_cust = max(int(rows["customer"] * scale), 10)
        self.n_ord = max(int(rows["orders"] * scale), 10)

    def _i64(self, t):
        return Col("int64", t.to(torch.int64))

    def _dec(self, t):
        return Col("decimal", t.to(torch.int64), scale=2)

    def _date(self, t):
        return Col("date", t.to(torch.int32))

    def _keys(self, n):
        return torch.arange(1, n + 1, device=self.dev, dtype=torch.int64)

    def _phones(self, nation: torch.Tensor, keys: torch.Tensor) -> Col:
        """'<11 + nation>-<key % 900 + 100>-<key % 9000 + 1000>'."""
        code = ((11 + nation) * 1000 + keys % 900 + 100) * 10000 + \
            keys % 9000 + 1000
        uniq, inv = torch.unique(code, return_inverse=True)
        values = [f"{c // 10**7}-{c // 10**4 % 1000}-{c % 10**4}"
                  for c in uniq.tolist()]
        return Col("string", inv.to(torch.int32), values=values)

    # ---- region, nation --------------------------------------------------
    @cached_property
    def r_regionkey(self):
        return self._i64(torch.arange(5, device=self.dev))

    @cached_property
    def r_name(self):
        return strings(REGIONS, torch.arange(5, device=self.dev))

    @cached_property
    def n_nationkey(self):
        return self._i64(torch.arange(25, device=self.dev))

    @cached_property
    def n_name(self):
        return strings([n for n, _ in NATIONS],
                       torch.arange(25, device=self.dev))

    @cached_property
    def n_regionkey(self):
        return self._i64(torch.tensor([r for _, r in NATIONS],
                                      device=self.dev))

    # ---- supplier --------------------------------------------------------
    @cached_property
    def s_suppkey(self):
        return self._i64(self._keys(self.n_supp))

    @cached_property
    def s_nationkey(self):
        return self._i64(self.s.randint("s_nationkey", 0, 25, self.n_supp))

    @cached_property
    def s_name(self):
        return numbered("Supplier#", self.n_supp, 9)

    @cached_property
    def s_address(self):
        return numbered("addr", self.n_supp, 0)

    @cached_property
    def s_phone(self):
        return self._phones(self.s_nationkey.data, self.s_suppkey.data)

    @cached_property
    def s_acctbal(self):
        return self._dec(self.s.randint("s_acctbal", -99_999, 1_000_000,
                                        self.n_supp))

    @cached_property
    def s_comment(self):
        pool = [f"supplier comment {i}" for i in range(1000)]
        return strings(pool, self.s_suppkey.data % 1000)

    # ---- part, partsupp --------------------------------------------------
    @cached_property
    def p_partkey(self):
        return self._i64(self._keys(self.n_part))

    @cached_property
    def p_name(self):
        nc = len(COLORS)
        pool = [f"{a} {b}" for a in COLORS for b in COLORS]
        return strings(pool, self.s.randint("p_name.1", 0, nc, self.n_part)
                       * nc + self.s.randint("p_name.2", 0, nc, self.n_part))

    @cached_property
    def p_mfgr(self):
        pool = [f"Manufacturer#{m}" for m in range(1, 6)]
        return strings(pool, self._brand_m)

    @cached_property
    def _brand_m(self):
        return self.s.randint("p_brand.m", 0, 5, self.n_part)

    @cached_property
    def p_brand(self):
        pool = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
        return strings(pool, self._brand_m * 5 +
                       self.s.randint("p_brand.n", 0, 5, self.n_part))

    @cached_property
    def p_type(self):
        pool = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                for c in TYPE_S3]
        return strings(pool, self.s.randint("p_type", 0, len(pool),
                                            self.n_part))

    @cached_property
    def p_size(self):
        return Col("int32", self.s.randint("p_size", 1, 51, self.n_part)
                   .to(torch.int32))

    @cached_property
    def p_container(self):
        pool = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
        return strings(pool, self.s.randint("p_container", 0, len(pool),
                                            self.n_part))

    @cached_property
    def ps_partkey(self):
        return self._i64(torch.repeat_interleave(self.p_partkey.data,
                                                 PER_PART))

    @cached_property
    def ps_suppkey(self):
        part = self.ps_partkey.data
        which = torch.arange(len(part), device=self.dev) % PER_PART
        return self._i64(self._supplier_of(part, which))

    def _supplier_of(self, part, which):
        """The `which`-th of the 4 suppliers of each part (datagen.py)."""
        return (part - 1 + which * (self.n_supp // PER_PART + 1)) % \
            self.n_supp + 1

    @cached_property
    def ps_availqty(self):
        return Col("int32", self.s.randint(
            "ps_availqty", 1, 10_000, PER_PART * self.n_part)
            .to(torch.int32))

    @cached_property
    def ps_supplycost(self):
        return self._dec(self.s.randint("ps_supplycost", 100, 100_001,
                                        PER_PART * self.n_part))

    # ---- customer --------------------------------------------------------
    @cached_property
    def c_custkey(self):
        return self._i64(self._keys(self.n_cust))

    @cached_property
    def c_nationkey(self):
        return self._i64(self.s.randint("c_nationkey", 0, 25, self.n_cust))

    @cached_property
    def c_mktsegment(self):
        return strings(SEGMENTS, self.s.randint("c_mktsegment", 0, 5,
                                                self.n_cust))

    @cached_property
    def c_name(self):
        return numbered("Customer#", self.n_cust, 9)

    @cached_property
    def c_address(self):
        return numbered("caddr", self.n_cust, 0)

    @cached_property
    def c_phone(self):
        return self._phones(self.c_nationkey.data, self.c_custkey.data)

    @cached_property
    def c_acctbal(self):
        return self._dec(self.s.randint("c_acctbal", -99_999, 1_000_000,
                                        self.n_cust))

    @cached_property
    def c_comment(self):
        pool = [f"customer comment {i}" for i in range(1000)]
        return strings(pool, self.c_custkey.data % 1000)

    # ---- orders ----------------------------------------------------------
    @cached_property
    def o_orderkey(self):
        return self._i64(self._keys(self.n_ord) * 4 - 3)

    @cached_property
    def o_custkey(self):
        return self._i64(self.s.randint("o_custkey", 1, self.n_cust + 1,
                                        self.n_ord))

    @cached_property
    def o_orderdate(self):
        return self._date(self.s.randint(
            "o_orderdate", days(1992, 1, 1), days(1998, 8, 2) - 151,
            self.n_ord))

    @cached_property
    def o_orderpriority(self):
        return strings(PRIORITIES, self.s.randint("o_orderpriority", 0, 5,
                                                  self.n_ord))

    @cached_property
    def o_shippriority(self):
        return Col("int32", torch.zeros(self.n_ord, dtype=torch.int32,
                                        device=self.dev))

    @cached_property
    def o_clerk(self):
        pool = [f"Clerk#{k:09d}" for k in range(1, max(self.n_ord // 1000,
                                                       2))]
        return strings(pool, self.s.randint("o_clerk", 0, len(pool),
                                            self.n_ord))

    @cached_property
    def o_comment(self):
        pool = [f"order comment {i}" for i in range(1000)]
        return strings(pool, torch.arange(self.n_ord, device=self.dev)
                       % 1000)

    @cached_property
    def o_orderstatus(self):
        """F where no line ships after TODAY, O where every line does, P
        else."""
        late = (self.l_shipdate.data > TODAY).to(torch.int64)
        n_open = torch.zeros(self.n_ord, dtype=torch.int64, device=self.dev)
        n_open.index_add_(0, self._line_order, late)
        status = torch.where(n_open == 0, 0,
                             torch.where(n_open == self._n_lines, 1, 2))
        return strings(["F", "O", "P"], status)

    @cached_property
    def o_totalprice(self):
        """sum(price * (1 - discount) * (1 + tax)) of the order's lines,
        rounded half up to cents."""
        charge = self.l_extendedprice.data * (100 - self.l_discount.data) * \
            (100 + self.l_tax.data)
        total = torch.zeros(self.n_ord, dtype=torch.int64, device=self.dev)
        total.index_add_(0, self._line_order, charge)
        return self._dec((total + 5000) // 10000)

    # ---- lineitem --------------------------------------------------------
    @cached_property
    def _n_lines(self):
        return self.s.randint("n_lines", 1, 8, self.n_ord)

    @cached_property
    def _line_order(self):
        """The row in orders of each line: an order's lines are adjacent."""
        n = int(self._n_lines.sum())
        return torch.repeat_interleave(
            torch.arange(self.n_ord, device=self.dev), self._n_lines,
            output_size=n)

    @cached_property
    def _n(self):
        return len(self._line_order)

    @cached_property
    def _l_odate(self):
        return self.o_orderdate.data[self._line_order].to(torch.int64)

    @cached_property
    def l_orderkey(self):
        return self._i64(self.o_orderkey.data[self._line_order])

    @cached_property
    def l_linenumber(self):
        starts = torch.cumsum(self._n_lines, 0) - self._n_lines
        return Col("int32", (torch.arange(self._n, device=self.dev) -
                             starts[self._line_order] + 1).to(torch.int32))

    @cached_property
    def l_partkey(self):
        return self._i64(self.s.randint("l_partkey", 1, self.n_part + 1,
                                        self._n))

    @cached_property
    def l_suppkey(self):
        return self._i64(self._supplier_of(
            self.l_partkey.data,
            self.s.randint("l_suppkey", 0, PER_PART, self._n)))

    @cached_property
    def _qty(self):
        return self.s.randint("l_quantity", 1, 51, self._n)

    @cached_property
    def l_quantity(self):
        return self._dec(self._qty * 100)

    @cached_property
    def l_extendedprice(self):
        """qty * (900.00 + (part % 20001) / 10 cents + part % 1000), in
        cents rounded half up."""
        part = self.l_partkey.data
        tenths = self._qty * (900_000 + part % 20_001 + 1000 * (part % 1000))
        return self._dec((tenths + 5) // 10)

    @cached_property
    def l_discount(self):
        return self._dec(self.s.randint("l_discount", 0, 11, self._n))

    @cached_property
    def l_tax(self):
        return self._dec(self.s.randint("l_tax", 0, 9, self._n))

    @cached_property
    def l_shipdate(self):
        return self._date(self._l_odate +
                          self.s.randint("l_shipdate", 1, 122, self._n))

    @cached_property
    def l_commitdate(self):
        return self._date(self._l_odate +
                          self.s.randint("l_commitdate", 30, 91, self._n))

    @cached_property
    def l_receiptdate(self):
        return self._date(self.l_shipdate.data.to(torch.int64) +
                          self.s.randint("l_receiptdate", 1, 31, self._n))

    @cached_property
    def l_returnflag(self):
        """R or A (even odds) for lines received by TODAY, N after."""
        received = self.l_receiptdate.data <= TODAY
        ra = torch.where(self.s.rand("l_returnflag", self._n) < 0.5, 2, 0)
        return Col("string", torch.where(received, ra, 1).to(torch.int32),
                   values=["A", "N", "R"])

    @cached_property
    def l_linestatus(self):
        return Col("string", (self.l_shipdate.data > TODAY).to(torch.int32),
                   values=["F", "O"])

    @cached_property
    def l_shipinstruct(self):
        return strings(INSTRUCTIONS, self.s.randint("l_shipinstruct", 0, 4,
                                                    self._n))

    @cached_property
    def l_shipmode(self):
        return strings(SHIPMODES, self.s.randint("l_shipmode", 0, 7,
                                                 self._n))


COLUMNS = sorted(name for name, v in vars(TPCH).items()
                 if isinstance(v, cached_property) and name[0] != "_")


def tables(cfg: dict, streams: Streams, needed, scale: float = 1.0):
    """{table: {column: Col}} of the columns in `needed`, at `scale` times
    the configuration's rows."""
    gen = TPCH(cfg, streams, scale)
    out = {}
    for name in sorted(needed):
        out.setdefault(table_of(name), {})[name] = getattr(gen, name)
    return out
