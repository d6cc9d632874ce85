"""Whole-window statistics over plain numbers."""


def percentile(values, q):
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the two nearest ranks (numpy's default); None
    for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count, seconds):
    """Events per second over a whole window; None for an empty one."""
    return count / seconds if count and seconds > 0 else None
