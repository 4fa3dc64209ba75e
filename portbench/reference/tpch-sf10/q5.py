"""TPC-H Q5: 1994 revenue of ASIA's nations from local suppliers."""
from portbench.reference.common import code, days, join, revenue


def reference(t, ar):
    li, o, c, s = t["lineitem"], t["orders"], t["customer"], t["supplier"]
    n, r = t["nation"], t["region"]
    oi, o_hit = join(o["o_orderkey"].data, li["l_orderkey"].data)
    d = o["o_orderdate"].data[oi]
    ci, c_hit = join(c["c_custkey"].data, o["o_custkey"].data[oi])
    si, s_hit = join(s["s_suppkey"].data, li["l_suppkey"].data)
    s_nat = s["s_nationkey"].data[si]
    ni, n_hit = join(n["n_nationkey"].data, s_nat)
    ri, r_hit = join(r["r_regionkey"].data, n["n_regionkey"].data[ni])
    m = o_hit & c_hit & s_hit & n_hit & r_hit & \
        (d >= days(1994, 1, 1)) & (d < days(1995, 1, 1)) & \
        (c["c_nationkey"].data[ci] == s_nat) & \
        (r["r_name"].data[ri] == code(r["r_name"], "ASIA"))
    names = n["n_name"]
    sums = ar.group_sum(revenue(li, m), names.data[ni[m]].long(),
                        len(names.values))
    counts = ar.group_count(names.data[ni[m]].long(), len(names.values))
    rows = [(names.values[k], v) for k, (v, cnt) in
            enumerate(zip(sums, counts)) if cnt]
    return sorted(rows, key=lambda row: -row[1])
