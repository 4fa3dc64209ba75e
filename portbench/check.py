"""The comparison that decides `correct`: every answer the window produced
against the plain reference's rows for its query.

Two numbers are compared, each with the limit the cell's workload file
gives it: `wrong_cells`, the most cells of one answer whose exact value
(integer, decimal at its scale, date, string) differs from the
reference's, every cell of a missing or extra row counted; and
`float_rel_err`, the largest relative error of a float cell."""
from __future__ import annotations

import math


def rows_of(batch) -> list:
    """The rows of one of the program's result batches as plain tuples:
    strings, ints (decimals as integers at their scale, dates as days),
    floats, None for NULL."""
    cols = []
    n = batch.num_rows
    for f, c in zip(batch.schema.fields, batch.columns):
        data, valid = c.data_host(), c.validity_host()
        if f.dtype.is_dict_coded:
            values = c.dictionary.values
            out = [str(values[int(x)]) for x in data[:n]]
        elif f.dtype.is_float:
            out = [float(x) for x in data[:n]]
        else:
            out = [int(x) for x in data[:n]]
        if valid is not None:
            out = [v if ok else None for v, ok in zip(out, valid[:n])]
        cols.append(out)
    return list(zip(*cols))


def rel_err(got: float, want: float) -> float:
    if got == want or (math.isnan(got) and math.isnan(want)):
        return 0.0
    if not (math.isfinite(got) and math.isfinite(want)):
        return 1e300          # as large as JSON holds
    return min(abs(got - want) / max(abs(want), 1e-300), 1e300)


def compare(got: list, want: list):
    """(wrong exact cells, largest float relative error) of one answer."""
    wrong, worst = 0, 0.0
    width = len(want[0]) if want else (len(got[0]) if got else 0)
    wrong += abs(len(got) - len(want)) * width
    for g, w in zip(got, want):
        if len(g) != len(w):
            wrong += max(len(g), len(w))
            continue
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                worst = max(worst, rel_err(a, b))
            elif a != b or type(a) is not type(b):
                wrong += 1
    return wrong, worst


def judge(answers, references, limits: dict) -> dict:
    """The compared numbers of a run, each beside its limit. `answers` is
    a list of (query, rows or None for a query that failed); `references`
    {query: rows}."""
    wrong, worst = 0, 0.0
    for q, rows in answers:
        if rows is None:
            continue
        w, e = compare(rows, references[q])
        wrong, worst = max(wrong, w), max(worst, e)
    numbers = {"wrong_cells": wrong}
    if any(isinstance(v, float) for rows in references.values()
           for row in rows for v in row):
        numbers["float_rel_err"] = worst
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
