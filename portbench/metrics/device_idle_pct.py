"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in %."""
from portbench.spans import union


def read(trace: dict):
    if not trace["device"] or trace["window_s"] <= 0:
        return None
    busy = union((a, b) for _n, _k, a, b in trace["device"])
    return 100.0 * (1.0 - busy / trace["window_s"])
