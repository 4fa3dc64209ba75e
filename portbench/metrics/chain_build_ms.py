"""Operators, chain build sides and staging: host ms a query inside the
program's `dft.build` spans (the union where they nest), over every traced
query. Nothing where the cell's queries open no such span."""
from portbench.spans import named, union


def read(trace: dict):
    spans = named(trace, "dft.build")
    if not spans or not trace["queries"]:
        return None
    return 1000.0 * union(spans) / trace["queries"]
