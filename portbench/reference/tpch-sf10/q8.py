"""TPC-H Q8: BRAZIL's share of AMERICA's ECONOMY ANODIZED STEEL volume in
1995 and 1996."""
import torch

from portbench.reference.common import code, days, div, join, revenue, year


def reference(t, ar):
    li, o, c, s, p = (t[k] for k in (
        "lineitem", "orders", "customer", "supplier", "part"))
    n, r = t["nation"], t["region"]
    pi, p_hit = join(p["p_partkey"].data, li["l_partkey"].data)
    oi, o_hit = join(o["o_orderkey"].data, li["l_orderkey"].data)
    ci, c_hit = join(c["c_custkey"].data, o["o_custkey"].data[oi])
    n1, n1_hit = join(n["n_nationkey"].data, c["c_nationkey"].data[ci])
    ri, r_hit = join(r["r_regionkey"].data, n["n_regionkey"].data[n1])
    si, s_hit = join(s["s_suppkey"].data, li["l_suppkey"].data)
    n2, n2_hit = join(n["n_nationkey"].data, s["s_nationkey"].data[si])
    d = o["o_orderdate"].data[oi]
    m = p_hit & o_hit & c_hit & n1_hit & r_hit & s_hit & n2_hit & \
        (p["p_type"].data[pi] == code(p["p_type"], "ECONOMY ANODIZED STEEL")) \
        & (r["r_name"].data[ri] == code(r["r_name"], "AMERICA")) & \
        (d >= days(1995, 1, 1)) & (d <= days(1996, 12, 31))
    vol = revenue(li, m)
    brazil = n["n_name"].data[n2[m]] == code(n["n_name"], "BRAZIL")
    years = year(d[m])
    rows = []
    for y in torch.unique(years).tolist():
        in_y = years == y
        total = ar.total(vol[in_y])
        rows.append((ar.float(y), div(ar.total(vol[in_y & brazil]), total,
                                      8)))
    return rows
