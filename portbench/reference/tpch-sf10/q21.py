"""TPC-H Q21: SAUDI ARABIA's suppliers who alone kept a multi-supplier
order of status F waiting, by count descending and name (100 rows)."""
import torch

from portbench.reference.common import code, join


def reference(t, ar):
    li, o, s, n = t["lineitem"], t["orders"], t["supplier"], t["nation"]
    supp = li["l_suppkey"].data
    late = li["l_receiptdate"].data > li["l_commitdate"].data
    oi, o_hit = join(o["o_orderkey"].data, li["l_orderkey"].data)
    n_ord = len(o["o_orderkey"].data)

    def per_order(values, how, init):
        out = torch.full((n_ord,), init, dtype=torch.int64,
                         device=values.device)
        return out.scatter_reduce_(0, oi, values, how)
    big = 2 ** 62
    other = (per_order(supp, "amin", big)[oi] != supp) | \
        (per_order(supp, "amax", -1)[oi] != supp)
    late_min = per_order(torch.where(late, supp, big), "amin", big)[oi]
    late_max = per_order(torch.where(late, supp, -1), "amax", -1)[oi]
    other_late = (late_max >= 0) & ((late_min != supp) | (late_max != supp))
    si, s_hit = join(s["s_suppkey"].data, supp)
    ni, n_hit = join(n["n_nationkey"].data, s["s_nationkey"].data[si])
    m = o_hit & s_hit & n_hit & late & other & ~other_late & \
        (o["o_orderstatus"].data[oi] == code(o["o_orderstatus"], "F")) & \
        (n["n_name"].data[ni] == code(n["n_name"], "SAUDI ARABIA"))
    names = s["s_name"]
    counts = ar.group_count(names.data[si[m]].long(), len(names.values))
    rows = sorted((-c, k) for k, c in enumerate(counts) if c)
    return [(names.values[k], -c) for c, k in rows[:100]]
