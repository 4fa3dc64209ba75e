"""TPC-H Q14: the share of September 1995's revenue from PROMO parts, as
100.00 * sum(promo) / sum(all) in float64 over the exact decimal sums."""
import torch

from portbench.reference.common import codes_where, days, join, revenue


def reference(t, ar):
    li, p = t["lineitem"], t["part"]
    ship = li["l_shipdate"].data
    pi, hit = join(p["p_partkey"].data, li["l_partkey"].data)
    m = hit & (ship >= days(1995, 9, 1)) & (ship < days(1995, 10, 1))
    vol = revenue(li, m)
    promo = torch.isin(p["p_type"].data[pi[m]],
                       codes_where(p["p_type"], lambda v: v.startswith(
                           "PROMO")))
    total = ar.total(vol)
    share = ar.fmul(100.0, ar.fdiv(ar.total(vol[promo]) / 1e4, total / 1e4))
    return [(share,)]
