"""TPC-H Q12: 1994's MAIL and SHIP lines received late but shipped before
their commit date, counted by high and low order priority."""
import torch

from portbench.reference.common import code, days, join


def reference(t, ar):
    li, o = t["lineitem"], t["orders"]
    ship, commit, receipt = (li[c].data for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    mode = li["l_shipmode"]
    oi, hit = join(o["o_orderkey"].data, li["l_orderkey"].data)
    m = hit & torch.isin(mode.data, torch.tensor(
        [code(mode, "MAIL"), code(mode, "SHIP")], dtype=mode.data.dtype,
        device=mode.data.device)) & (commit < receipt) & (ship < commit) & \
        (receipt >= days(1994, 1, 1)) & (receipt < days(1995, 1, 1))
    prio = o["o_orderpriority"]
    high = torch.isin(prio.data[oi[m]], torch.tensor(
        [code(prio, "1-URGENT"), code(prio, "2-HIGH")],
        dtype=prio.data.dtype, device=prio.data.device))
    g = mode.data[m].long()
    n = len(mode.values)
    highs = ar.group_sum(high.long(), g, n)
    lows = ar.group_sum((~high).long(), g, n)
    counts = ar.group_count(g, n)
    return [(mode.values[k], highs[k], lows[k]) for k in range(n)
            if counts[k]]
