"""Median host ms of a window's Mapper.stitch call, inside the call: its
``mapper.stitch`` span (the port's recorder), the inside counterpart of
``enqueue_ms.resident``."""

from benchmark.spans import root_ms


def read(rec):
    return root_ms(rec, "mapper.stitch")
