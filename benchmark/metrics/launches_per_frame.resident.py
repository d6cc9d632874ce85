"""Device kernels per frame set in the traced segment."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["frames"] or not t["launches"]:
        return None
    return t["launches"] / t["frames"]
