"""Seconds of the template load (or compile) plus every Mapper
construction and its move to the card."""


def read(rec):
    return rec.get("plan_build_s")
