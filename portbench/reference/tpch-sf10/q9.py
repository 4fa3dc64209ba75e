"""TPC-H Q9: profit on the green parts, by supplier nation and order year
(years descending)."""
import torch

from portbench.reference.common import codes_where, join, revenue, year


def reference(t, ar):
    li, o, s, p, ps, n = (t[k] for k in (
        "lineitem", "orders", "supplier", "part", "partsupp", "nation"))
    pi, p_hit = join(p["p_partkey"].data, li["l_partkey"].data)
    green = torch.isin(p["p_name"].data[pi],
                       codes_where(p["p_name"], lambda v: "green" in v))
    width = int(ps["ps_suppkey"].data.max()) + 1
    psi, ps_hit = join(ps["ps_partkey"].data * width + ps["ps_suppkey"].data,
                       li["l_partkey"].data * width + li["l_suppkey"].data)
    si, s_hit = join(s["s_suppkey"].data, li["l_suppkey"].data)
    ni, n_hit = join(n["n_nationkey"].data, s["s_nationkey"].data[si])
    oi, o_hit = join(o["o_orderkey"].data, li["l_orderkey"].data)
    m = p_hit & green & ps_hit & s_hit & n_hit & o_hit
    amount = revenue(li, m) - ps["ps_supplycost"].data[psi[m]] * \
        li["l_quantity"].data[m]
    nation = n["n_name"].data[ni[m]].long()
    years = year(o["o_orderdate"].data[oi[m]])
    keys, group = torch.unique(nation * 10_000 + years, return_inverse=True)
    sums = ar.group_sum(amount, group, len(keys))
    names = n["n_name"].values
    rows = [(names[k // 10_000], k % 10_000, v)
            for k, v in zip(keys.tolist(), sums)]
    rows.sort(key=lambda row: (row[0], -row[1]))
    return [(nm, ar.float(y), v) for nm, y, v in rows]
