"""The whole-window rate and percentile arithmetic and the readers of
the end-to-end metrics, on made-up timestamps."""

import pytest

from benchmark import spec
from benchmark.stats import percentile, rate


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 95) == pytest.approx(4.8)
    assert percentile(xs, 0) == 1.0 and percentile(xs, 100) == 5.0
    assert percentile([], 50) is None
    assert percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_rate_is_over_the_whole_window():
    assert rate(300, 10.0) == 30.0
    assert rate(0, 10.0) is None and rate(5, 0.0) is None


def test_latency_tail_is_over_every_set_of_the_window():
    # due every 50 ms; pops 80 ms after due, with a one-second stall at set 10
    # that the 18 sets behind it wait out
    due = [i * 0.05 for i in range(200)]
    pop = [d + 0.08 for d in due]
    for i in range(10, 30):
        pop[i] = max(pop[i], due[10] + 1.0)
    rec = {"latency_s": [p - d for p, d in zip(pop, due)], "frames": 200}
    p50 = spec.reader("frame_ms_p50")(rec)
    p95 = spec.reader("frame_ms_p95")(rec)
    assert p50 == pytest.approx(80.0)
    assert p95 > 200.0  # 19 of 200 stalled sets: the tail is theirs
    assert sum(x > 0.081 for x in rec["latency_s"]) == 19
    assert spec.reader("fps")(rec) is None


def test_fps_and_enqueue_readers():
    rec = {"frames": 600, "window_s": 20.0, "enqueue_s": 19.5}
    assert spec.reader("fps")(rec) == pytest.approx(30.0)
    assert spec.reader("enqueue_ms.resident")(rec) == pytest.approx(32.5)
    assert spec.reader("frame_ms_p95")(rec) is None
