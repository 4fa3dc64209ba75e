"""TPC-H Q4: orders of 1993 Q3 with a line received after its commit
date, counted by priority."""
import torch

from portbench.reference.common import days, join


def reference(t, ar):
    o, li = t["orders"], t["lineitem"]
    late = li["l_commitdate"].data < li["l_receiptdate"].data
    oi, hit = join(o["o_orderkey"].data, li["l_orderkey"].data[late])
    has = torch.zeros(len(o["o_orderkey"].data), dtype=torch.bool,
                      device=oi.device)
    has[oi[hit]] = True
    d = o["o_orderdate"].data
    m = (d >= days(1993, 7, 1)) & (d < days(1993, 10, 1)) & has
    prio = o["o_orderpriority"]
    counts = ar.group_count(prio.data[m].long(), len(prio.values))
    return [(prio.values[k], c) for k, c in enumerate(counts) if c]
