"""ClickBench's `hits` table on the device, from the seed, by the
distributions of the port's `clickbench/workload.py` `generate_hits` (as
`chip_smoke.py`'s `hits` draws them): `UserID` Zipf(1.3) over n/6 users,
`SearchPhrase` empty with probability 0.6 and else Zipf(1.5) over
max(n/800, 997) phrases, `EventTime` 2013-07-01 plus up to 31 days of
seconds, `RegionID` uniform on [0, 5000), `AdvEngineID` 0 with
probability 0.95 and else uniform on [1, 20), `ResolutionWidth` one of 8
screen widths. Each column takes the type that ClickBench's `create.sql`
gives it (`RegionID` INTEGER, `AdvEngineID` and `ResolutionWidth`
SMALLINT, `UserID` BIGINT, `EventTime` as the parquet's int64 seconds).
Only the columns asked for are made."""
from __future__ import annotations

from functools import cached_property

import torch

from portbench.datagen import Col, Streams

WIDTHS = [1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560]
EVENT_START = 1372636800          # 2013-07-01 00:00:00 UTC


class Hits:
    def __init__(self, cfg: dict, streams: Streams, scale: float):
        self.s = streams
        self.dev = streams.device
        self.n = max(int(cfg["rows"]["hits"] * scale), 1000)

    @cached_property
    def UserID(self):
        users = max(self.n // 6, 10)
        return Col("int64", self.s.zipf("UserID", 1.3, self.n) % users)

    @cached_property
    def SearchPhrase(self):
        phrases = max(self.n // 800, 997)
        pool = [""] + [f"search phrase {i}" for i in range(phrases)]
        values = sorted(pool)
        where = {v: i for i, v in enumerate(values)}
        rank = torch.tensor([where[v] for v in pool], dtype=torch.int32,
                            device=self.dev)
        idx = torch.where(self.s.rand("SearchPhrase.empty", self.n) < 0.6, 0,
                          self.s.zipf("SearchPhrase", 1.5, self.n)
                          % len(pool))
        return Col("string", rank[idx], values=values)

    @cached_property
    def EventTime(self):
        return Col("int64", EVENT_START + self.s.randint(
            "EventTime", 0, 31 * 86400, self.n))

    @cached_property
    def RegionID(self):
        return Col("int32", self.s.randint("RegionID", 0, 5000, self.n)
                   .to(torch.int32))

    @cached_property
    def AdvEngineID(self):
        engine = self.s.randint("AdvEngineID", 1, 20, self.n)
        return Col("int16", torch.where(
            self.s.rand("AdvEngineID.none", self.n) < 0.95, 0, engine)
            .to(torch.int16))

    @cached_property
    def ResolutionWidth(self):
        widths = torch.tensor(WIDTHS, dtype=torch.int16, device=self.dev)
        return Col("int16", widths[self.s.randint("ResolutionWidth", 0,
                                                  len(WIDTHS), self.n)])


COLUMNS = sorted(name for name, v in vars(Hits).items()
                 if isinstance(v, cached_property))


def tables(cfg: dict, streams: Streams, needed, scale: float = 1.0):
    """{"hits": {column: Col}} of the columns in `needed`."""
    gen = Hits(cfg, streams, scale)
    return {"hits": {name: getattr(gen, name) for name in sorted(needed)}}
