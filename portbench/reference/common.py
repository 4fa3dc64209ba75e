"""What the plain references share: joins on unique keys, years of dates,
grouped sums and the arithmetic in which they are taken.

A reference takes the generated columns (`t[table][column]`, each with
`.data` on a torch device and, for strings, `.values`) and returns the
query's result as a list of row tuples of str, int (decimals as integers
at the result's scale, dates as days) and float. It imports nothing of
the program."""
from __future__ import annotations

import datetime

import numpy as np
import torch


def days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


class Arith:
    """Exact arithmetic: int64 sums and float64. With `lower`, the control:
    every sum wraps as an int32 accumulator would and every float is
    float32, the step below what the configuration states."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def wrap(self, v):
        if not self.lower:
            return v
        return (v + 2 ** 31) % 2 ** 32 - 2 ** 31

    def total(self, x: torch.Tensor) -> int:
        return self.wrap(int(x.to(torch.int64).sum()))

    def group_sum(self, x: torch.Tensor, group: torch.Tensor, n: int):
        """[sum of x over each group 0..n-1], as Python ints."""
        out = torch.zeros(n, dtype=torch.int64, device=x.device)
        out.index_add_(0, group, x.to(torch.int64))
        return [self.wrap(v) for v in out.tolist()]

    def group_count(self, group: torch.Tensor, n: int):
        return [self.wrap(v) for v in
                torch.bincount(group, minlength=n).tolist()]

    def float(self, v) -> float:
        return float(np.float32(v)) if self.lower else float(v)

    def fdiv(self, a, b) -> float:
        if self.lower:
            return float(np.float32(a) / np.float32(b))
        return float(a) / float(b)

    def fmul(self, a, b) -> float:
        if self.lower:
            return float(np.float32(a) * np.float32(b))
        return float(a) * float(b)


def avg(total: int, count: int, up: int) -> int:
    """A decimal average at `up` more places than its sum, truncated toward
    zero as DataFusion's decimal AVG divides."""
    q = abs(total) * 10 ** up // count
    return q if total >= 0 else -q


def div(a: int, b: int, up: int) -> int:
    """a / b of two decimals of one scale, at `up` places, truncated toward
    zero as DataFusion's decimal division is; None where b is 0."""
    if b == 0:
        return None
    q = abs(a) * 10 ** up // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def join(keys: torch.Tensor, probe: torch.Tensor):
    """(row of `keys` that each probe value equals, whether there is one);
    `keys` are unique. Rows without a match get row 0 and False."""
    order = torch.argsort(keys)
    ordered = keys[order]
    pos = torch.searchsorted(ordered, probe).clamp(max=len(keys) - 1)
    hit = ordered[pos] == probe
    return torch.where(hit, order[pos], 0), hit


def code(col, value: str) -> int:
    """The code of `value` in a string column, or -1."""
    try:
        return col.values.index(value)
    except ValueError:
        return -1


def codes_where(col, test) -> torch.Tensor:
    """The codes of the values of a string column that pass `test`."""
    return torch.tensor([i for i, v in enumerate(col.values) if test(v)],
                        dtype=torch.int32, device=col.data.device)


_JAN1 = [days(y, 1, 1) for y in range(1900, 2101)]


def year(d: torch.Tensor) -> torch.Tensor:
    """The calendar year of days since 1970-01-01."""
    jan1 = torch.tensor(_JAN1, dtype=torch.int64, device=d.device)
    return torch.searchsorted(jan1, d.to(torch.int64), right=True) - 1 + 1900


def revenue(li, m: torch.Tensor) -> torch.Tensor:
    """l_extendedprice * (1 - l_discount) of the rows `m`, at scale 4."""
    return li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])
