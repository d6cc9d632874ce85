"""The plans' ROI fill, in %: the valid pixels of every covering input
over their ROI box pixels, summed over the System's outputs (the port's
plan counter, Y plane)."""

from benchmark.plan_counts import totals


def read(rec):
    t = totals(rec)
    if t is None or not t.get("roi_px"):
        return None
    return 100.0 * t["valid_px"] / t["roi_px"]
