"""Per-layer numbers read from the port's span recorder
(``octvr_tpu_torch.runtime.timer.RECORDER``) over a run's window.

A window's sets are the last spans named ``root`` that opened with no
profiler recording: the warm-up's sets come before them, and a traced
segment's after them, opened under the profiler.  A live cell's root,
``pipeline.set``, is one span a set, so its window is the last
``rec["frames"]`` of them.  A resident cell's, ``mapper.stitch``, is one
span a call, and a set of a configuration with ``rec["outputs"]``
outputs is that many consecutive calls: its window is the last
``frames x outputs`` calls, and a set reads as one span whose duration,
children and self time are the sums over its calls (with one output,
the call's own span).  Each number is a percentile over those sets.
Where the program has no recorder (a checkout before it) or holds fewer
such sets than the window's, a reader gets None.
"""

from .stats import percentile


def _port_timer():
    try:
        from octvr_tpu_torch.runtime import timer
    except ImportError:
        return None
    return timer if hasattr(timer, "RECORDER") and hasattr(timer, "self_times") else None


def window(rec, root):
    """(the window's ``root`` spans, their children by parent id, self
    ns by span id), or None."""
    timer = _port_timer()
    if timer is None:
        return None
    spans = timer.RECORDER.spans()
    per_set = rec.get("outputs", 1) if root == "mapper.stitch" else 1  # one call an output
    n = (rec.get("frames") or 0) * per_set
    roots = [s for s in spans if s.name == root and not s.profiled]
    if n < 1 or len(roots) < n:
        return None
    calls = roots[-n:]
    ids = {s.id for s in calls}
    kids = {}
    for s in spans:
        if s.parent in ids:
            kids.setdefault(s.parent, []).append(s)
    own = timer.self_times(calls + [k for ks in kids.values() for k in ks])
    sets = []
    for i in range(0, n, per_set):
        group = calls[i : i + per_set]
        first = group[0]
        sets.append(first._replace(end_ns=first.start_ns + sum(s.end_ns - s.start_ns for s in group)))
        kids[first.id] = [k for s in group for k in kids.get(s.id, ())]
        own[first.id] = sum(own[s.id] for s in group)
    return sets, kids, own


def stage_ms(rec, root, stage, q=50.0):
    """The ``q``-th percentile over the window's sets of the host ms
    that the set's ``stage`` children took together."""
    w = window(rec, root)
    if w is None:
        return None
    sets, kids, _ = w
    return percentile([sum(k.end_ns - k.start_ns for k in kids.get(s.id, ()) if k.name == stage) / 1e6
                       for s in sets], q)


def root_ms(rec, root, q=50.0):
    """The ``q``-th percentile over the window's sets of their span's ms."""
    w = window(rec, root)
    return None if w is None else percentile([(s.end_ns - s.start_ns) / 1e6 for s in w[0]], q)


def self_ms(rec, root, q=50.0):
    """The ``q``-th percentile over the window's sets of their span's
    self ms: its time less what its children cover."""
    w = window(rec, root)
    return None if w is None else percentile([w[2][s.id] / 1e6 for s in w[0]], q)
