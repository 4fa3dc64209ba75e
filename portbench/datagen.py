"""What the configurations' generators share: one random stream a column,
drawn on the device from the run's seed, and the plain column that the
harness hands to the program and to the reference alike."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

import torch

KINDS = ("int64", "int32", "int16", "date", "decimal", "string")


@dataclass
class Col:
    """One generated column. `data` holds int64, int32 or int16 values, int32
    days since 1970-01-01 (`date`), int64 values at `scale` decimal places
    (`decimal`), or int32 codes into `values`, a sorted list of distinct
    strings (`string`)."""
    kind: str
    data: torch.Tensor
    scale: int = 0
    values: Optional[List[str]] = field(default=None, repr=False)


class Streams:
    """A torch.Generator on the device for each named draw, seeded from the
    run's seed and the name: a column's values do not depend on which
    other columns a cell asks for, nor on the order they are made in."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def generator(self, name: str) -> torch.Generator:
        digest = hashlib.sha256(f"{self.seed}/{name}".encode()).digest()
        g = torch.Generator(device=self.device)
        g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        return g

    def randint(self, name: str, low: int, high: int, n: int) -> torch.Tensor:
        """n int64 values uniform on [low, high)."""
        return torch.randint(low, high, (n,), generator=self.generator(name),
                             device=self.device, dtype=torch.int64)

    def rand(self, name: str, n: int) -> torch.Tensor:
        """n float64 values uniform on [0, 1)."""
        return torch.rand(n, generator=self.generator(name),
                          device=self.device, dtype=torch.float64)

    def zipf(self, name: str, a: float, n: int) -> torch.Tensor:
        """n int64 draws of the Zipf distribution of exponent `a` > 1, by
        the rejection method numpy's `Generator.zipf` uses (Devroye,
        Non-Uniform Random Variate Generation, X.6)."""
        g = self.generator(name)
        am1, b = a - 1.0, 2.0 ** (a - 1.0)
        out = torch.empty(n, dtype=torch.int64, device=self.device)
        todo = torch.arange(n, device=self.device)
        while todo.numel():
            m = todo.numel()
            u = 1.0 - torch.rand(m, generator=g, device=self.device,
                                 dtype=torch.float64)
            v = torch.rand(m, generator=g, device=self.device,
                           dtype=torch.float64)
            x = torch.floor(u ** (-1.0 / am1))
            t = (1.0 + 1.0 / x) ** am1
            ok = (x < 2.0 ** 62) & (x >= 1) & \
                (v * x * (t - 1.0) / (b - 1.0) <= t / b)
            out[todo[ok]] = x[ok].to(torch.int64)
            todo = todo[~ok]
        return out


def strings(pool: List[str], idx: torch.Tensor) -> Col:
    """The string column pool[idx]: codes into the sorted distinct values of
    `pool`, as a dictionary column holds them."""
    values = sorted(set(pool))
    where = {v: i for i, v in enumerate(values)}
    rank = torch.tensor([where[v] for v in pool], dtype=torch.int32,
                        device=idx.device)
    return Col("string", rank[idx], values=values)


def numbered(prefix: str, n: int, pad: int) -> Col:
    """The strings prefix + 1..n, zero-padded to `pad` digits, one a row:
    sorted already when padded, so the codes are the rows."""
    values = [f"{prefix}{k:0{pad}d}" for k in range(1, n + 1)]
    codes = torch.arange(n, dtype=torch.int32)
    if pad and n < 10 ** pad:
        return Col("string", codes, values=values)
    order = sorted(range(n), key=values.__getitem__)
    rank = torch.empty(n, dtype=torch.int32)
    rank[torch.tensor(order)] = codes
    return Col("string", rank, values=[values[i] for i in order])
