"""95th percentile over the live window's sets of the ms each waited in
the pipeline's queues (the self time of its ``pipeline.set`` span)."""

from benchmark.spans import self_ms


def read(rec):
    return self_ms(rec, "pipeline.set", 95)
