"""The trace reductions on a synthetic trace: the idle share as the
complement of the union of device intervals (not a sum of kernel
times), the longest idle gaps named by the host op running in them,
and the device operations by class."""

import pytest

from benchmark import spec
from benchmark import trace as tr

TRACE = {
    "window": (0.0, 1.0),
    "device": [
        ("ampere_sgemm_128x64_nn", 0.00, 0.20),
        ("void at::native::elementwise_kernel<copy>", 0.10, 0.30),  # overlaps the gemm
        ("remap_kernel<1>", 0.50, 0.55),
        ("remap_frames_kernel<2>", 0.54, 0.60),  # overlaps the remap
        ("Memcpy HtoD (Pageable -> Device)", 0.90, 0.95),
        ("reduce_kernel<512>", 0.98, 1.20),  # runs past the window
    ],
    "host": [
        ("aten::matmul", 0.0, 0.35, 1),
        ("cudaLaunchKernel", 0.38, 0.42, 1),
        ("AsyncMultiMapper.stitch", 0.0, 1.0, 2),
        ("aten::add", 0.62, 0.88, 1),
    ],
}


def test_union_is_not_a_sum():
    busy = tr.busy_s(TRACE)
    assert busy == pytest.approx(0.30 + 0.10 + 0.05 + 0.02)
    assert sum(e - s for _, s, e in TRACE["device"]) > busy
    rec = {"trace": {"window_s": 1.0, "busy_s": busy, "frames": 2}}
    assert spec.reader("idle_pct.resident")(rec) == pytest.approx(53.0)
    assert spec.reader("idle_pct.live")(rec) == pytest.approx(53.0)


def test_gaps_and_the_host_op_in_each():
    gaps = tr.gaps([(s, e) for _, s, e in TRACE["device"]], 0.0, 1.0)
    assert gaps == pytest.approx([(0.30, 0.50), (0.60, 0.90), (0.95, 0.98)])
    named = tr.idle_gaps(TRACE)
    assert [n for n, _ in named] == ["aten::add", "cudaLaunchKernel", "AsyncMultiMapper.stitch"]
    assert named[0][1] == pytest.approx(0.30)


def test_device_ops_by_class_and_launches():
    ops = dict(tr.device_ops(TRACE))
    assert ops["ampere_sgemm_128x64_nn [matmul (pyramid, pooling)]"] == pytest.approx(0.2)
    assert any("[host-device copies and memsets]" in k for k in ops)
    assert tr.launches(TRACE) == 5
    assert tr.class_seconds(TRACE, "matmul (pyramid, pooling)") == pytest.approx(0.2)
    assert tr.kernel_seconds(TRACE, ("remap_kernel", "remap_frames_kernel")) == pytest.approx(0.11)


def test_readers_return_nothing_without_a_trace():
    for name in ("launches_per_frame.resident", "gemm_ms.resident", "remap_roofline", "idle_pct.resident"):
        assert spec.reader(name)({"frames": 3}) is None
    t = {"frames": 2, "window_s": 1.0, "busy_s": 0.5, "launches": 0, "gemm_s": 0.0, "remap_s": 0.0}
    assert spec.reader("remap_roofline")({"trace": t, "remap_bound_s": 1e-4}) is None
