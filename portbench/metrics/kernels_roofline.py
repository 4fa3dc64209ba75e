"""Kernels: the share of the device's kernel time that the traced queries'
bytes would take at the card's peak bandwidth, in %. The bytes are the
benchmark's own count (`portbench/roofline.py`): each column a query's
SQL names, once, at the width of its source type, and its result once.
Integer operations have no published peak, so no operations term is
counted. Nothing without a kernel or a peak for the card."""


def read(trace: dict):
    busy = sum(b - a for _n, kind, a, b in trace["device"]
               if kind == "kernel")
    peak = trace.get("peak_bytes_per_s")
    if busy <= 0 or not peak:
        return None
    return 100.0 * trace["bytes_needed"] / peak / busy
