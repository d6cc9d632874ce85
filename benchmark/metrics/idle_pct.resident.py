"""Share of the traced window, in %, in which no device operation ran:
the complement of the union of the device intervals."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
