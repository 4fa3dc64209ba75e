"""TPC-H Q1: sums, averages and counts of the lines shipped by 1998-09-02,
by return flag and line status."""
from portbench.reference.common import avg, days


def reference(t, ar):
    li = t["lineitem"]
    m = li["l_shipdate"].data <= days(1998, 9, 2)
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    n_ls = len(ls.values)
    n = len(rf.values) * n_ls
    g = (rf.data.long() * n_ls + ls.data.long())[m]
    qty, price, disc, tax = (li[c].data[m] for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    sums = [ar.group_sum(v, g, n) for v in (
        qty, price, disc_price, disc_price * (100 + tax), disc)]
    counts = ar.group_count(g, n)
    rows = []
    for k, c in enumerate(counts):
        if c:
            s_qty, s_price, s_dp, s_charge, s_disc = (s[k] for s in sums)
            rows.append((rf.values[k // n_ls], ls.values[k % n_ls], s_qty,
                         s_price, s_dp, s_charge, avg(s_qty, c, 4),
                         avg(s_price, c, 4), avg(s_disc, c, 4), c))
    return rows
