"""The port's span recorder (octvr_tpu_torch.runtime.timer): spans nest
with their parent and set ids across threads, the ring stays bounded
and the totals count every span under concurrent writers, the Mapper's
six stage spans cover its stitch on both pipelines without changing
its outputs, every set through an AsyncMultiMapper (one Mapper, and a
ShardedMapper's batches) has its set span with its stage children, and
a span under the torch profiler is a user annotation on the recorder's
converted clock.

Rig: two 128^2 fisheyes -> a 128x64 canvas, random YUV420P frames."""

import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.runtime import AsyncMultiMapper, timer
from octvr_tpu_torch.runtime.timer import RECORDER, RING, Recorder, self_times
from octvr_tpu_torch.stitch import FastMapper, Mapper
from octvr_tpu_torch.template import compile_rig
from rigs import two_fisheye_rig

torch.set_num_threads(2)

CAM = 128
SIZES = [(CAM, CAM)] * 2

STAGES = ["mapper.prep", "mapper.remap", "mapper.gain_pool", "mapper.gain_solve", "mapper.blend", "mapper.pack"]
GRAPH_SPANS = ("mapper.capture", "mapper.replay")


@pytest.fixture(scope="module")
def mt():
    rig = two_fisheye_rig()
    for cam in rig["inputs"]:
        cam["options"]["width"] = cam["options"]["height"] = CAM
    m = compile_rig(rig, 128, 64)
    m.create_masks()
    return m


def random_sets(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8) for h, w in SIZES] for _ in range(n)]


def by_id(spans):
    return {s.id: s for s in spans}


def stream(amm, sets):
    """Pushes ``sets`` and the end of the stream from a thread while
    popping here; the ns before each push and after each pop."""
    pushed, popped = [], []

    def push_all():
        for s in sets:
            pushed.append(time.perf_counter_ns())
            amm.push(s)
        amm.close_input()

    pusher = threading.Thread(target=push_all)
    try:
        pusher.start()
        for _ in sets:
            amm.pop()
            popped.append(time.perf_counter_ns())
        pusher.join(timeout=30)
        assert not pusher.is_alive()
    finally:
        amm.close()
    return pushed, popped


def test_spans_nest_across_threads():
    rec = Recorder()
    with rec.span("outer", set_id=7) as outer:
        with rec.span("inner") as inner:
            time.sleep(0.002)
        got = {}

        def worker():
            with rec.span("side", parent=outer) as side:
                with rec.span("leaf"):
                    pass
            got["side"] = side.id

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        detached = rec.span("set", set_id=9, stacked=False)
    rec.end(detached)  # begun inside outer: its parent, its own set id
    s = by_id(rec.spans())
    assert s[inner.id].parent == outer.id and s[inner.id].set_id == 7
    assert s[got["side"]].parent == outer.id and s[got["side"]].set_id == 7
    assert s[got["side"]].thread != s[outer.id].thread
    leaf = [x for x in s.values() if x.name == "leaf"][0]
    assert leaf.parent == got["side"] and leaf.set_id == 7 and leaf.thread == s[got["side"]].thread
    assert s[outer.id].parent is None and s[detached.id].parent == outer.id and s[detached.id].set_id == 9
    own = self_times(list(s.values()))
    inner_ns = s[inner.id].end_ns - s[inner.id].start_ns
    assert inner_ns >= 2_000_000 and own[inner.id] == inner_ns
    assert 0 <= own[outer.id] <= s[outer.id].end_ns - s[outer.id].start_ns - inner_ns
    assert rec.totals() == {n: (1, s[i].end_ns - s[i].start_ns) for n, i in
                            (("outer", outer.id), ("inner", inner.id), ("side", got["side"]),
                             ("leaf", leaf.id), ("set", detached.id))}
    assert rec.to_profiler_ns(0) == rec.offset_ns
    assert abs(rec.to_profiler_ns(time.perf_counter_ns()) - time.time_ns()) < 50_000_000


def test_self_time_is_what_children_leave():
    S = timer.Span
    spans = [S("p", 1, None, 0, 1, 100, 200, False),
             S("a", 2, 1, 0, 1, 90, 130, False),  # starts before its parent: clipped
             S("b", 3, 1, 0, 2, 120, 150, False),  # overlaps a
             S("c", 4, 1, 0, 2, 170, 180, False)]
    assert self_times(spans) == {1: 100 - 50 - 10, 2: 40, 3: 30, 4: 10}


def test_ring_is_bounded_and_totals_survive_it(monkeypatch):
    """More writers than cores, a short switch interval: the ring keeps
    the last RING spans and the totals count every one."""
    assert RING >= 20_000  # one 51 s window of the busiest cell
    monkeypatch.setattr(timer, "RING", 64)
    rec = Recorder()
    n_threads, each = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with rec.span("a", scope="s"):
                    with rec.span("b", scope="s"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.spans()
    assert len(spans) == 64
    tot = rec.totals("s")
    assert tot["a"][0] == tot["b"][0] == n_threads * each
    assert rec.totals() == {}
    s = by_id(spans)
    for x in spans:  # each b's parent is an a of its own thread
        if x.name == "b" and x.parent in s:
            assert s[x.parent].name == "a" and s[x.parent].thread == x.thread


def _coverage(spans, root):
    kids = [s for s in spans if s.parent == root.id]
    return kids, 1 - self_times([root] + kids)[root.id] / (root.end_ns - root.start_ns)


@pytest.mark.parametrize("pipeline", ["yuv420", "rgb"])
def test_mapper_stage_spans_cover_stitch(mt, pipeline):
    """The six stage spans, in call order, under each mapper.stitch,
    covering at least 95% of it (the median call of five); a profiled
    call (its spans entering record_function) gives the same bytes."""
    m = Mapper(mt, SIZES, blend=8, enable_gain=True, pipeline=pipeline, device="cpu")
    sets = random_sets(5)
    mark = RECORDER.new_id()
    outs = [m.stitch(s) for s in sets]
    spans = RECORDER.spans(mark)
    roots = [s for s in spans if s.name == "mapper.stitch"]
    assert len(roots) == 5 and all(not s.profiled for s in spans)
    covers = []
    for root in roots:
        kids, cover = _coverage(spans, root)
        assert [k.name for k in sorted(kids, key=lambda k: k.start_ns)] == STAGES
        covers.append(cover)
    assert statistics.median(covers) >= 0.95, covers
    with profile(activities=[ProfilerActivity.CPU]):
        again = m.stitch(sets[0])
    assert torch.equal(again[0], outs[0][0]) and torch.equal(again[1], outs[0][1])
    assert RECORDER.spans(mark)[-1].profiled


@pytest.mark.parametrize("kind", ["yuv420", "rgb", "fast"])
def test_cpu_stitch_is_eager(mt, kind):
    """A CPU Mapper's stitch is ``_stitch_eager`` under its
    ``mapper.stitch`` span: the same bytes, the stage spans in call
    order (FastMapper has no gain stages), no ``mapper.capture`` or
    ``mapper.replay`` span, no graph."""
    if kind == "fast":
        m = FastMapper(mt, SIZES, device="cpu")
    else:
        m = Mapper(mt, SIZES, blend=8, enable_gain=True, pipeline=kind, device="cpu")
    sets = random_sets(3, seed=2)
    mark = RECORDER.new_id()
    outs = [m.stitch(s) for s in sets]
    spans = RECORDER.spans(mark)
    assert not [s for s in spans if s.name in GRAPH_SPANS] and m._graphs == {}
    roots = [s for s in spans if s.name == "mapper.stitch"]
    assert len(roots) == 3
    for root in roots:
        kids = sorted((s for s in spans if s.parent == root.id), key=lambda k: k.start_ns)
        want = STAGES if kind != "fast" else [s for s in STAGES if "gain" not in s]
        assert [k.name for k in kids] == want
    for (o, g), s in zip(outs, sets):
        eo, eg = m._stitch_eager(s)
        assert torch.equal(o, eo) and torch.equal(g, eg)


@pytest.mark.parametrize("pipeline", ["yuv420", "rgb"])
def test_stitch_batch_spans(mt, pipeline):
    """stitch_batch opens the stage spans per frame under the caller's
    open span, and no span of its own."""
    m = Mapper(mt, SIZES, blend=8, enable_gain=True, pipeline=pipeline, device="cpu")
    sets = random_sets(2, seed=1)
    mark = RECORDER.new_id()
    with RECORDER.span("test.caller") as caller:
        out, _ = m.stitch_batch([torch.from_numpy(np.stack(x)) for x in zip(*sets)])
    spans = RECORDER.spans(mark)
    assert all(s.parent == caller.id for s in spans if s.name.startswith("mapper."))
    assert not [s for s in spans if s.name in GRAPH_SPANS]
    names = [k.name for k in sorted((s for s in spans if s.parent == caller.id), key=lambda k: k.start_ns)]
    remaps = 1 if pipeline == "yuv420" else 2
    assert names.count("mapper.prep") == 3 and names.count("mapper.remap") == remaps
    assert all(names.count(n) == 2 for n in STAGES[2:])
    for b, s in enumerate(sets):
        assert torch.equal(out[b], m.stitch(s)[0])


def _set_tree(spans, sid):
    sets = [s for s in spans if s.name == "pipeline.set" and s.set_id == sid]
    assert len(sets) == 1
    kids = [s for s in spans if s.parent == sets[0].id]
    return sets[0], kids


@pytest.mark.parametrize("kind", ["mapper", "sharded"])
def test_pipeline_set_spans(mt, kind):
    """Every set pushed has one pipeline.set from its push to its pop,
    with its upload, dispatch and drain children; its self time is at
    least 0 and with theirs adds up to pop minus push; the mappers'
    spans sit inside the dispatch; stats() reads the recorder's totals."""
    sets = random_sets(5, seed=2)
    if kind == "mapper":
        mappers = [Mapper(mt, SIZES, blend=8, pipeline="yuv420", device="cpu")]
    else:
        mappers = [ShardedMapper(mt, SIZES, make_mesh(2, 2, device="cpu"), blend=8)]
    amm = AsyncMultiMapper(mappers)
    mark = RECORDER.new_id()
    pushed, popped = stream(amm, sets)
    spans = RECORDER.spans(mark)
    set_ids = sorted({s.set_id for s in spans if s.name == "pipeline.set"})
    assert len(set_ids) == 5 and set_ids == list(range(set_ids[0], set_ids[0] + 5))
    own = self_times(spans)
    for i, sid in enumerate(set_ids):
        root, kids = _set_tree(spans, sid)
        names = sorted(k.name for k in kids)
        assert {"pipeline.upload", "pipeline.dispatch", "pipeline.drain"} == set(names)
        assert pushed[i] <= root.start_ns and root.end_ns <= popped[i]
        assert all(root.start_ns <= k.start_ns and k.end_ns <= root.end_ns for k in kids)
        assert all(k.set_id == sid for k in kids)
        assert own[root.id] >= 0
        covered = sum(k.end_ns - k.start_ns for k in kids)  # the stages of one set run one after another
        assert own[root.id] + covered == root.end_ns - root.start_ns
        if kind == "mapper":
            assert names == ["pipeline.dispatch", "pipeline.drain", "pipeline.upload"]
            dispatch = [k for k in kids if k.name == "pipeline.dispatch"][0]
            inner = [s for s in spans if s.name == "mapper.stitch" and s.parent == dispatch.id]
            assert len(inner) == 1 and inner[0].set_id == sid
    if kind == "sharded":
        # batches of two and a last of one: a batch's stitch runs in the
        # dispatch span of its last set and is recorded under the other;
        # its drain is a span of its first set, recorded under the other
        def stage(i, name):
            return sorted((k for k in _set_tree(spans, set_ids[i])[1] if k.name == name), key=lambda k: k.start_ns)

        for a, b in ((0, 1), (2, 3)):
            own_a, batch_a = stage(a, "pipeline.dispatch")
            (own_b,) = stage(b, "pipeline.dispatch")
            assert own_b.start_ns <= batch_a.start_ns and batch_a.end_ns <= own_b.end_ns
            (drain_a,), (drain_b,) = stage(a, "pipeline.drain"), stage(b, "pipeline.drain")
            assert drain_a.start_ns <= drain_b.start_ns and drain_b.end_ns <= drain_a.end_ns
        assert len(stage(4, "pipeline.dispatch")) == 2  # its copy, and the flush at the end of the stream
    tot = RECORDER.totals(amm._scope)
    st = amm.stats()
    assert st["frames"] == 5
    for stage in ("upload", "dispatch", "drain"):
        assert st[f"{stage}_ms"] == tot[f"pipeline.{stage}"][1] / 1e6 / 5
    assert tot["pipeline.upload"][0] == 5
    assert tot["pipeline.dispatch"][0] == 5 and tot["pipeline.drain"][0] == (5 if kind == "mapper" else 3)


def test_timer_lines_read_the_totals(mt, capfd):
    """The [Timer stitch] lines are the stage totals' means since the
    last lines: over the whole stream they add up to stats()."""
    m = Mapper(mt, SIZES, blend=8, pipeline="rgb", device="cpu")
    amm = AsyncMultiMapper([m], timers=True, timer_interval=2)
    stream(amm, random_sets(4, seed=3))
    lines = [line.split() for line in capfd.readouterr().err.splitlines() if line.startswith("[Timer stitch]")]
    assert len(lines) == 6
    st = amm.stats()
    for stage in ("upload", "dispatch", "drain"):
        printed = [float(x[3]) for x in lines if x[2] == f"{stage}:"]
        assert len(printed) == 2
        assert sum(printed) * 2 / 4 == pytest.approx(st[f"{stage}_ms"], abs=0.01)


def test_span_under_profiler_is_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with RECORDER.span("trace.probe") as sp:
            time.sleep(0.003)
    mine = [s for s in RECORDER.spans(sp.id) if s.id == sp.id][0]
    assert mine.profiled
    found = [e for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name() == "trace.probe"]
    assert len(found) == 1
    assert abs(found[0].start_ns() - RECORDER.to_profiler_ns(mine.start_ns)) < 1_000_000
    with RECORDER.span("trace.probe") as later:
        pass
    assert not [s for s in RECORDER.spans(later.id) if s.id == later.id][0].profiled
