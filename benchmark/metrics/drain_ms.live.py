"""Host ms per frame set of the pipeline's drain stage over the live
window (AsyncMultiMapper.stats(), differenced across the window)."""


def read(rec):
    ms = rec.get("stage_ms", {}).get("drain")
    return ms if ms else None
