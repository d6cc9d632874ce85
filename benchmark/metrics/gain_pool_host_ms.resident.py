"""Median over the resident window's Mapper.stitch calls of the host ms
in the call's ``mapper.gain_pool`` span (the port's recorder)."""

from benchmark.spans import stage_ms


def read(rec):
    return stage_ms(rec, "mapper.stitch", "mapper.gain_pool")
