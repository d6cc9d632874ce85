"""The readers of the port's spans (``benchmark/spans.py`` and the
metrics that use it) on a synthetic recorder: the window is the last
``rec["frames"]`` sets opened outside a profiler, the medians and 95th
percentiles are over those sets, and a reader gets None without a
recorder or with too few sets; a resident set of several outputs (one
``mapper.stitch`` call each) reads as one set.  Then a traced CPU run of
each traffic kind, and of two outputs, reads every one of them from the
program's own spans."""

import json

import numpy as np
import pytest

from benchmark import run, spec
from octvr_tpu_torch.runtime import timer

Span = timer.Span
RESIDENT = ["stitch_host_ms.resident"] + [f"{s}_host_ms.resident" for s in
                                         ("prep", "remap", "gain_pool", "gain_solve", "blend", "pack")]
LIVE = ["queue_wait_ms.live", "queue_wait_ms_p95.live", "dispatch_ms_p95.live"]
MS = 1_000_000


class Synthetic:
    """A recorder's reading side over made-up spans, in closing order."""

    def __init__(self):
        self.list = []
        self.next = 1

    def add(self, name, parent, t0, t1, profiled=False, set_id=None):
        sid = self.next
        self.next += 1
        self.list.append(Span(name, sid, parent, set_id, 1, t0, t1, profiled))
        return sid

    def spans(self, since=0):
        return [s for s in self.list if s.id >= since]


def resident_calls(fake, stage_ms, profiled=False, t=0):
    """One mapper.stitch call: its six stages back to back, each of the
    given ms, and 0.5 ms of its own; its children close first."""
    kids = []
    start = t
    for name, ms in zip(("prep", "remap", "gain_pool", "gain_solve", "blend", "pack"), stage_ms):
        kids.append((f"mapper.{name}", t, t + int(ms * MS)))
        t += int(ms * MS)
    end = t + MS // 2
    ids = [fake.add(n, -1, a, b, profiled) for n, a, b in kids]
    rid = fake.add("mapper.stitch", None, start, end, profiled)
    fake.list = [s._replace(parent=rid) if s.id in ids else s for s in fake.list]
    return end


@pytest.fixture
def fake(monkeypatch):
    f = Synthetic()
    monkeypatch.setattr(timer, "RECORDER", f)
    return f


def test_resident_window_and_medians(fake):
    t = 0
    for _ in range(3):  # warm-up: outside the window
        t = resident_calls(fake, [50] * 6, t=t)
    window = [[1 + i, 2, 3, 4, 10 + i, 5] for i in range(10)]
    for ms in window:
        t = resident_calls(fake, ms, t=t)
    for _ in range(4):  # a traced segment: opened under the profiler
        t = resident_calls(fake, [70] * 6, profiled=True, t=t)
    rec = {"frames": 10}
    got = {name: spec.reader(name)(rec) for name in RESIDENT}
    w = np.array(window, dtype=float)
    assert got["stitch_host_ms.resident"] == pytest.approx(np.median(w.sum(1) + 0.5))
    for k, name in enumerate(RESIDENT[1:]):
        assert got[name] == pytest.approx(np.median(w[:, k])), name
    assert got["prep_host_ms.resident"] == pytest.approx(5.5) and got["blend_host_ms.resident"] == pytest.approx(14.5)
    assert all(spec.reader(n)({"frames": 14}) is None for n in RESIDENT)  # 13 unprofiled calls
    assert all(spec.reader(n)({"frames": 0}) is None for n in RESIDENT)


def test_live_queue_wait_and_dispatch_tails(fake):
    rng = np.random.default_rng(5)
    n, t = 40, 0
    waits, dispatch = [], []
    for i in range(n + 2):  # two warm-up sets, then the window
        up, dis, dr = (float(x) for x in rng.uniform(1, 30, 3))
        wait_a, wait_b = (float(x) for x in rng.uniform(0, 10, 2))
        s0 = t
        a = s0 + int(wait_a * MS)  # the upload waits for a free slot
        b = a + int(up * MS)
        c = b + int(wait_b * MS)  # the dispatch waits for the stitch thread
        d = c + int(dis * MS)
        e = d + int(dr * MS)
        end = e + MS  # 1 ms in the out queue
        kids = [("pipeline.upload", a, b), ("pipeline.dispatch", c, d), ("pipeline.drain", d, e)]
        ids = [fake.add(nm, -1, x, y, set_id=i) for nm, x, y in kids]
        ids.append(fake.add("mapper.stitch", ids[1], c, d, set_id=i))  # a grandchild: not the set's own
        rid = fake.add("pipeline.set", None, s0, end, set_id=i)
        fake.list = [s._replace(parent=rid) if s.id in ids[:3] else s for s in fake.list]
        if i >= 2:
            waits.append((end - s0 - (b - a) - (d - c) - (e - d)) / MS)
            dispatch.append((d - c) / MS)
        t = end - 5 * MS  # the next set is pushed before this one pops
    fake.add("pipeline.set", None, t, t + 99 * MS, profiled=True, set_id=99)  # traced, after the window
    rec = {"frames": n}
    assert spec.reader("queue_wait_ms.live")(rec) == pytest.approx(np.percentile(waits, 50))
    assert spec.reader("queue_wait_ms_p95.live")(rec) == pytest.approx(np.percentile(waits, 95))
    assert spec.reader("dispatch_ms_p95.live")(rec) == pytest.approx(np.percentile(dispatch, 95))
    assert sum(w > np.percentile(waits, 95) for w in waits) == 2  # 40 sets: two beyond it
    assert all(spec.reader(nm)({"frames": n + 3}) is None for nm in LIVE)


def test_nothing_to_read_without_a_recorder(monkeypatch):
    """A checkout whose port has no recorder (the parent of the spans):
    every reader gets None and none raises."""
    monkeypatch.delattr(timer, "RECORDER")
    for name in RESIDENT + LIVE:
        assert spec.reader(name)({"frames": 5}) is None


def test_cpu_runs_read_every_span_metric(small, bench_dir, cell_spec):
    """A traced CPU run of each traffic kind: its span metrics are read,
    and the resident stages' medians add up to the stitch's (within 15%:
    on the CPU the stages do the work, and vary apart from each other,
    so a sum of medians strays from the median of the sums)."""
    res, _ = run.run_cell(cell_spec(small, "resident"), "t", 2**31 + 21, 1.0, 1, "cpu")
    got = {n: res["metrics"][n]["value"] for n in RESIDENT}
    assert sum(got[n] for n in RESIDENT[1:]) == pytest.approx(got["stitch_host_ms.resident"], rel=0.15)
    live, _ = run.run_cell(cell_spec(small, "live_16fps"), "t", 2**31 + 22, 1.0, 1, "cpu")
    waits = [live["metrics"][n]["value"] for n in LIVE]
    assert 0 <= waits[0] <= waits[1] and waits[2] > 0


def test_a_set_of_several_outputs_reads_as_one_set(fake):
    """A resident set of a six-output configuration is six consecutive
    ``mapper.stitch`` calls: a set's reading is the sum over its calls.
    With one output a set, each call is a set, as without the key."""
    t = 0
    for _ in range(2):  # warm-up: outside the window
        t = resident_calls(fake, [50] * 6, t=t)
    window = np.random.default_rng(7).uniform(0.5, 20.0, size=(5, 6, 6))  # sets, outputs, stages
    for outputs in window:
        for ms in outputs:
            t = resident_calls(fake, ms, t=t)
    for _ in range(3):  # a traced segment: opened under the profiler
        t = resident_calls(fake, [70] * 6, profiled=True, t=t)
    six = {n: spec.reader(n)({"frames": 5, "outputs": 6}) for n in RESIDENT}
    assert six["stitch_host_ms.resident"] == pytest.approx(np.median(window.sum(axis=(1, 2)) + 6 * 0.5))
    for k, name in enumerate(RESIDENT[1:]):
        assert six[name] == pytest.approx(np.median(window[:, :, k].sum(axis=1))), name
    one = {n: spec.reader(n)({"frames": 30, "outputs": 1}) for n in RESIDENT}
    assert one == {n: spec.reader(n)({"frames": 30}) for n in RESIDENT}
    assert one["stitch_host_ms.resident"] == pytest.approx(np.median(window.reshape(30, 6).sum(axis=1) + 0.5))
    assert all(spec.reader(n)({"frames": 6, "outputs": 6}) is None for n in RESIDENT)  # 32 unprofiled calls


def test_cpu_run_of_two_outputs_reads_each_set_once(small, bench_dir, cell_spec, tmp_path):
    """A traced CPU run of a two-output configuration (the second output
    copies the first's gains): a set's host ms is both calls', so the
    stitch's median stands beside the host's enqueue ms per set."""
    c = {k: v for k, v in small.items() if k != "path"}
    c["outputs"] = [small["outputs"][0], dict(small["outputs"][0], name="copy")]
    path = tmp_path / "two.json"
    path.write_text(json.dumps(c))
    res, _ = run.run_cell(cell_spec(dict(c, path=str(path)), "resident"), "t", 2**31 + 25, 1.0, 1, "cpu")
    assert res["correct"]
    got = {n: res["metrics"][n]["value"] for n in RESIDENT + ["enqueue_ms.resident"]}
    assert got["stitch_host_ms.resident"] == pytest.approx(got["enqueue_ms.resident"], rel=0.25)
    assert sum(got[n] for n in RESIDENT[1:]) == pytest.approx(got["stitch_host_ms.resident"], rel=0.15)
