"""The plans' ROI sweep, in x: the ROI box pixels of every covering
input, summed over the System's outputs, over their canvas pixels
summed (the port's plan counter, Y plane).  It is what the remap grid
and the pyramid boxes sweep per output pixel."""

from benchmark.plan_counts import totals


def read(rec):
    t = totals(rec)
    if t is None or not t.get("canvas_px"):
        return None
    return t["roi_px"] / t["canvas_px"]
