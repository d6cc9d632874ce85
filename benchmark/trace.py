"""Reading a ``torch.profiler`` trace of a traced segment.

``traced(fn)`` runs ``fn`` under the profiler and returns the
segment's device operations (and, if asked, host ops) as plain
intervals in seconds from the window's start.  The reductions below are plain arithmetic over those
intervals, so the tests can feed them made-up ones.
"""

import time

# the classes of device kernels by name, as the port's chip smoke names
# them (a frozen copy of chip_smoke.py::_KERNEL_CLASSES)
KERNEL_CLASSES = (
    ("remap (csrc/remap.cu)", ("remap_kernel", "remap_frames_kernel")),
    ("matmul (pyramid, pooling)", ("gemm", "xmma", "cutlass")),
    ("dtype casts and copies", ("copy",)),
    ("reductions (gain sums)", ("reduce",)),
    ("indexing (band pastes, row gathers)", ("index",)),
)
COPY_WORDS = ("Memcpy", "Memset")


def kernel_class(name):
    if any(w in name for w in COPY_WORDS):
        return "host-device copies and memsets"
    for cls, words in KERNEL_CLASSES:
        if any(w in name for w in words):
            return cls
    return "other elementwise"


def traced(fn, host=False):
    """Runs ``fn()`` (which ends in a device synchronize) under the
    profiler: device activity only, or with ``host`` the host's ops as
    well (which slows the host's dispatch several fold).  Returns
    {"window": (0, length), "device": [(name, start, end)], "host":
    [(name, start, end, thread)], "t0_ns": start}, times in seconds from
    the window's start, which the host's clock (``time.time_ns``) takes
    around ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # (the host's ops alone where there is no card: the CPU tests)
    host = host or not torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        fn()
        t1 = time.time_ns()
    device, hosts = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start, end = (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), start, end))
        else:
            hosts.append((e.name(), start, end, e.start_thread_id()))
    return {"window": (0.0, (t1 - t0) * 1e-9), "device": device, "host": hosts, "t0_ns": t0}


def union(intervals, lo, hi):
    """Total length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def busy_s(trace):
    lo, hi = trace["window"]
    return union([(s, e) for _, s, e in trace["device"]], lo, hi)


def device_ops(trace, top=10):
    """The device operations that took most time: [[name (class), s]]."""
    tot = {}
    for name, s, e in trace["device"]:
        key = f"{name[:80]} [{kernel_class(name)}]"
        tot[key] = tot.get(key, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace, top=10):
    """The longest idle gaps, each named by the innermost host op that
    was running at its middle: [[host op, s]]."""
    lo, hi = trace["window"]
    out = []
    for s, e in sorted(gaps([(s, e) for _, s, e in trace["device"]], lo, hi), key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        covering = [(he - hs, name) for name, hs, he, _ in trace["host"] if hs <= mid <= he]
        out.append([min(covering)[1] if covering else "(no traced host op)", e - s])
    return out


def class_seconds(trace, cls):
    return sum(e - s for name, s, e in trace["device"] if kernel_class(name) == cls)


def kernel_seconds(trace, words):
    return sum(e - s for name, s, e in trace["device"] if any(w in name for w in words))


def launches(trace):
    """Device kernels (not copies or memsets) in the trace."""
    return sum(1 for name, _, _ in trace["device"] if not any(w in name for w in COPY_WORDS))
