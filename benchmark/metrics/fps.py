"""Frame sets per second over the whole resident window, which ends in a
device synchronize."""

from benchmark.stats import rate


def read(rec):
    if "latency_s" in rec:
        return None
    return rate(rec["frames"], rec["window_s"])
