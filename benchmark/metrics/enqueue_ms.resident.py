"""Host ms per frame set that the window's Mapper.stitch calls took to
enqueue, the clock stopped before the closing synchronize."""


def read(rec):
    if "enqueue_s" not in rec or not rec["frames"]:
        return None
    return rec["enqueue_s"] / rec["frames"] * 1e3
