"""Median host-to-host latency of the live window's frame sets, in ms,
from each set's due time to the pop of all its outputs."""

from benchmark.stats import percentile


def read(rec):
    if "latency_s" not in rec:
        return None
    p = percentile(rec["latency_s"], 50)
    return None if p is None else p * 1e3
