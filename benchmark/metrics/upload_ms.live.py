"""Host ms per frame set of the pipeline's upload stage over the live
window (AsyncMultiMapper.stats(), differenced across the window)."""


def read(rec):
    ms = rec.get("stage_ms", {}).get("upload")
    return ms if ms else None
