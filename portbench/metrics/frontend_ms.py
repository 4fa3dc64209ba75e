"""Session and SQL front end: the mean host ms of `ctx.sql(text)` (parse,
SqlToRel and the logical plan), on the benchmark's own clock, over every
traced query."""


def read(trace: dict):
    times = trace["frontend_s"]
    return 1000.0 * sum(times) / len(times) if times else None
