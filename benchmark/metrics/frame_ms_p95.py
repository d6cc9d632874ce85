"""95th percentile of the live window's host-to-host latency over every
frame set due in the window, in ms."""

from benchmark.stats import percentile


def read(rec):
    if "latency_s" not in rec:
        return None
    p = percentile(rec["latency_s"], 95)
    return None if p is None else p * 1e3
