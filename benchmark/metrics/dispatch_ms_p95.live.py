"""95th percentile over the live window's sets of the host ms of each
set's ``pipeline.dispatch`` (the port's recorder)."""

from benchmark.spans import stage_ms


def read(rec):
    return stage_ms(rec, "pipeline.set", "pipeline.dispatch", 95)
