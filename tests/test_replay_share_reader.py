"""The benchmark's ``replay_share.resident`` reader on a synthetic
recorder: the share of the window's ``mapper.stitch`` sets that have a
``mapper.replay`` child, nothing to read where the recorder holds no
graph span (a program without the graph, a CPU run) or where there is
no recorder at all."""

import pytest

from benchmark import spec
from octvr_tpu_torch.runtime import timer

Span = timer.Span
MS = 1_000_000


class Synthetic:
    """A recorder's reading side over made-up spans, in closing order."""

    def __init__(self):
        self.list = []

    def add(self, name, parent, t0, t1, profiled=False):
        sid = len(self.list) + 1
        self.list.append(Span(name, sid, parent, None, 1, t0, t1, profiled))
        return sid

    def spans(self, since=0):
        return [s for s in self.list if s.id >= since]


def stitch_call(fake, t, child, profiled=False):
    """One mapper.stitch call of 2 ms whose one child is ``child``: its
    child closes first, so it takes the id the call takes next."""
    sid = len(fake.list) + 2
    fake.add(child, sid, t, t + MS, profiled)
    fake.add("mapper.stitch", None, t, t + 2 * MS, profiled)
    return t + 2 * MS


def calls(fake, children, profiled=False, t=0):
    for child in children:
        t = stitch_call(fake, t, child, profiled)
    return t


CASES = {
    # the warm-up's capture, then a window of replays, then a traced segment
    "replayed": (["mapper.capture"] * 2, ["mapper.replay"] * 8, 100.0),
    # a capture in the warm-up, then a window that took the stages (none replayed)
    "captured_only": (["mapper.capture"], ["mapper.prep"] * 8, 0.0),
    "half": (["mapper.capture"], ["mapper.replay", "mapper.prep"] * 4, 50.0),
    # no graph span anywhere: the eager program
    "eager": (["mapper.prep"] * 2, ["mapper.prep"] * 8, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_share_reads_the_window(monkeypatch, case):
    warm, window, want = CASES[case]
    fake = Synthetic()
    monkeypatch.setattr(timer, "RECORDER", fake)
    t = calls(fake, warm)
    t = calls(fake, window, t=t)
    calls(fake, ["mapper.prep"] * 3, profiled=True, t=t)  # a traced segment: out of the window
    read = spec.reader("replay_share.resident")
    got = read({"frames": len(window)})
    assert got == (None if want is None else pytest.approx(want))
    assert read({"frames": len(warm) + len(window) + 1}) is None  # fewer sets than the window's


def test_replay_share_without_a_recorder(monkeypatch):
    monkeypatch.delattr(timer, "RECORDER")
    assert spec.reader("replay_share.resident")({"frames": 5}) is None
