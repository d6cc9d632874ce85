"""Per-layer numbers read from the port's plan counter
(``octvr_tpu_torch.stitch.mapper.PLANS``), to which ``build_plan`` adds
the shape of each plan it builds on the Y plane: the inputs, the empty
ones, the canvas pixels, and over the covering inputs the summed ROI box
pixels, their valid pixels and the ROIs that wrap across +-180 degrees.

A run builds one plan per output of its configuration (``deploy.System``),
so the counter's totals are the sums over the System's outputs.  Where
the program has no such counter (a checkout before it), or it holds
another number of plans than the run's outputs, a reader gets None.
"""


def totals(rec):
    """The counter's totals ({key: sum}) over the run's plans, or None."""
    try:
        from octvr_tpu_torch.stitch import mapper
    except ImportError:
        return None
    plans = getattr(mapper, "PLANS", None)
    counts = getattr(plans, "counts", None)
    if not counts or counts.get("plans") != rec.get("outputs"):
        return None
    return dict(counts)
