"""ClickBench Q30 (line 30 of its queries.sql): SUM(ResolutionWidth + k)
for k = 0..89, as sum(ResolutionWidth) + k * rows."""


def reference(t, ar):
    width = t["hits"]["ResolutionWidth"].data
    total, rows = int(width.sum()), len(width)
    return [tuple(ar.wrap(total + k * rows) for k in range(90))]
