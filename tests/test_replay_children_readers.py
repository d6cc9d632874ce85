"""The benchmark's ``copy_in_host_ms.resident`` and
``launch_host_ms.resident`` readers on a synthetic recorder: the median
over the window's sets of the set's ``mapper.copy_in`` (``mapper.launch``)
spans, summed over its calls' replays (a set of a configuration with
several outputs is that many calls); nothing to read where the program
records no such span (a checkout before them), where the recorder holds
fewer sets than the window's, or where there is no recorder."""

import pytest

from benchmark import spec
from octvr_tpu_torch.runtime import timer

Span = timer.Span
US = 1_000
READERS = {"copy_in_host_ms.resident": "mapper.copy_in", "launch_host_ms.resident": "mapper.launch"}
CHILD_US = {"mapper.copy_in": 30, "mapper.launch": 50, "mapper.copy_out": 20}


class Synthetic:
    """A recorder's reading side over made-up spans, in closing order."""

    def __init__(self):
        self.list = []

    def spans(self, since=0):
        return [s for s in self.list if s.id >= since]


def replayed_call(fake, t, scale=1, children=True, profiled=False):
    """One replayed mapper.stitch call: its replay, and the replay's
    copy in, launch and copy out of ``CHILD_US`` x ``scale`` us each
    (with ``children``).  Spans close innermost first, so the ids of
    the call and its replay are known before their children's."""
    n = len(fake.list)
    kids = list(CHILD_US) if children else []
    replay_id, call_id = n + len(kids) + 1, n + len(kids) + 2
    t0 = t
    for i, name in enumerate(kids):
        dt = CHILD_US[name] * scale * US
        fake.list.append(Span(name, n + i + 1, replay_id, None, 1, t, t + dt, profiled))
        t += dt
    fake.list.append(Span("mapper.replay", replay_id, call_id, None, 1, t0, t, profiled))
    fake.list.append(Span("mapper.stitch", call_id, None, None, 1, t0, t + 5 * US, profiled))
    return t + 5 * US


@pytest.mark.parametrize("outputs", [1, 6])
@pytest.mark.parametrize("name", sorted(READERS))
def test_replay_child_reads_the_window(monkeypatch, name, outputs):
    fake = Synthetic()
    monkeypatch.setattr(timer, "RECORDER", fake)
    t = 0
    for _ in range(2 * outputs):  # the warm-up: out of the window
        t = replayed_call(fake, t, scale=100)
    scales = [1, 2, 3, 4, 5]  # one per set of the window
    for s in scales:
        for _ in range(outputs):
            t = replayed_call(fake, t, scale=s)
    for _ in range(outputs):  # a traced segment: out of the window
        t = replayed_call(fake, t, scale=100, profiled=True)
    read = spec.reader(name)
    want = CHILD_US[READERS[name]] * outputs * 3 / 1e3  # the median set, scale 3, in ms
    assert read({"frames": len(scales), "outputs": outputs}) == pytest.approx(want)
    assert read({"frames": 100, "outputs": outputs}) is None  # fewer sets than the window's


@pytest.mark.parametrize("name", sorted(READERS))
def test_replay_child_without_the_spans(monkeypatch, name):
    """A program whose replays have no children (the parent of this
    metric) reads None, as does a process without a recorder."""
    fake = Synthetic()
    monkeypatch.setattr(timer, "RECORDER", fake)
    t = 0
    for _ in range(4):
        t = replayed_call(fake, t, children=False)
    assert spec.reader(name)({"frames": 4}) is None
    monkeypatch.delattr(timer, "RECORDER")
    assert spec.reader(name)({"frames": 4}) is None
