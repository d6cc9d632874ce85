"""Set-up seconds: from process start to the first timed frame set."""


def read(rec):
    return rec.get("setup_s")
