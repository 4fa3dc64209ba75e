"""TPC-H Q6: revenue that 1994's discounts of 0.05-0.07 on fewer than 24
units gave away."""
from portbench.reference.common import days


def reference(t, ar):
    li = t["lineitem"]
    ship, disc, qty = (li[c].data for c in (
        "l_shipdate", "l_discount", "l_quantity"))
    m = (ship >= days(1994, 1, 1)) & (ship < days(1995, 1, 1)) & \
        (disc >= 5) & (disc <= 7) & (qty < 2400)
    return [(ar.total(li["l_extendedprice"].data[m] * disc[m]),)]
