"""Interval arithmetic that the metric readers share."""
from __future__ import annotations


def union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def named(trace: dict, name: str) -> list:
    """The (start, end) of every host span called `name` in the trace."""
    return [(a, b) for n, a, b in trace["spans"] if n == name]
