"""The remap kernels' share of their byte bound, in %: the least time of
a frame set's remap launches (benchmark/roofline.py, 3.35 TB/s at 700 W)
over their device time per frame set in the traced segment."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["frames"] or not t["remap_s"] or not rec.get("remap_bound_s"):
        return None
    return 100.0 * rec["remap_bound_s"] / (t["remap_s"] / t["frames"])
