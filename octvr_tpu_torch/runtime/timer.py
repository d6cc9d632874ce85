"""Phase timer + rolling FPS meter (vr::Timer, octvr/src/timer.cpp:36-70;
FPS aggregation as in async.cpp:141-147).  Prints the reference's
``[Timer name] msg: X ms`` format for parity debugging.  The port's copy
of octvr_tpu/runtime/timer.py.

Beside them, the port's span recorder (``RECORDER``): the stitch
(``mapper.*``) and the streaming pipeline (``pipeline.*``) open spans at
their stage boundaries.  A span records its name, id, parent span, set
id, thread, start and end on ``time.perf_counter_ns()``, and whether a
torch profiler was recording when it opened; while one is, the span
also enters ``torch.profiler.record_function(name)``, so that the
profiler's trace carries the stage ranges around their kernels.  Closed
spans go to a bounded ring; per-name running totals (count, ns) are kept
beside it.  ``Recorder.to_profiler_ns`` puts a span on the clock of
``torch.profiler``'s events (``time.time_ns()``), on every thread, which
matters because the profiler records no range of the pipeline's
threads.  Always on, with no switch: a span costs two clock reads, one
object, an append and a locked add to its totals: 7 spans an eager
stitch, 5 a replayed one (the call, its replay, and the replay's copy
in, launch and copy out).
"""

import itertools
import sys
import threading
import time
from collections import deque, namedtuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

__all__ = ["Timer", "FpsMeter", "Recorder", "RECORDER", "RING", "Span", "self_times"]

# closed spans kept, the oldest dropped first: a 51 s window and the
# traced segments of the busiest cell with room (a set of six replayed
# outputs is 30 spans: up to ~260,000 spans at 160 sets/s)
RING = 1 << 19

Span = namedtuple("Span", "name id parent set_id thread start_ns end_ns profiled")


class Timer:
    def __init__(self, name="Timer", enabled=True, out=sys.stderr):
        self.name = name
        self.enabled = enabled
        self.out = out
        self.t = time.perf_counter()

    def reset(self):
        self.t = time.perf_counter()

    def tick(self, msg):
        now = time.perf_counter()
        dt_ms = (now - self.t) * 1e3
        if self.enabled:
            print(f"[Timer {self.name}] {msg}: {dt_ms:.2f} ms", file=self.out)
        self.t = now
        return dt_ms


class FpsMeter:
    """Rolling FPS over a 10-frame window (async.cpp:141-147)."""

    def __init__(self, window=10):
        self.times = deque(maxlen=window)

    def tick(self):
        self.times.append(time.perf_counter())
        return self.value()

    def value(self):
        """Current rolling FPS without recording a frame (read-only)."""
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / dt if dt > 0 else 0.0


class _Open:
    """A span (``Recorder.span``): a context manager, or a handle closed
    by ``Recorder.end``; once closed, the ring's entry itself."""

    __slots__ = ("rec", "name", "id", "parent", "set_id", "thread", "start_ns", "end_ns", "profiled", "scope",
                 "stacked", "rf")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec.end(self)


class _Local(threading.local):
    """One thread's ident and open stacked spans, innermost last."""

    def __init__(self):
        self.ident = threading.get_ident()
        self.stack = []


class Recorder:
    """Spans of the stitch and the pipeline; see the module's docstring.
    ``scope`` keys a span's running totals, so that each pipeline reads
    its own stages' (``totals(scope)``)."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._ring = deque(maxlen=RING)  # appends are atomic
        self._ids = itertools.count(1)
        self._sets = itertools.count()
        self._local = _Local()
        self._totals = {}  # {(scope, name): [count, ns]}, under the lock
        self._lock = threading.Lock()

    def new_id(self):
        """A fresh id, unique in this recorder among span ids."""
        return next(self._ids)

    def new_set(self):
        """The next set id, in call order."""
        return next(self._sets)

    def span(self, name, parent=None, set_id=None, scope=None, stacked=True):
        """Opens a span: ``with RECORDER.span(name): ...``, or a handle
        for ``end``.  ``parent`` (an open span) defaults to the calling
        thread's innermost open one; ``set_id`` to the parent's.  A
        ``stacked`` span is its thread's innermost until it ends, which
        has to be on the same thread; any other may end on any thread,
        and no profiler range is entered for it."""
        local = self._local
        stack = local.stack
        if parent is None and stack:
            parent = stack[-1]
        sp = _Open()
        sp.rec = self
        sp.name = name
        sp.id = next(self._ids)
        sp.scope = scope
        sp.thread = local.ident
        sp.stacked = stacked
        sp.rf = None
        if parent is None:
            sp.parent = None
            sp.set_id = set_id
        else:
            sp.parent = parent.id
            sp.set_id = parent.set_id if set_id is None else set_id
        sp.profiled = _profiler._is_profiler_enabled
        if stacked:
            stack.append(sp)
            if sp.profiled:
                sp.rf = record_function(name)
                sp.rf.__enter__()
        sp.start_ns = time.perf_counter_ns()
        return sp

    def end(self, sp):
        """Closes ``sp`` (on its own thread if it is ``stacked``)."""
        t = sp.end_ns = time.perf_counter_ns()
        if sp.stacked:
            if sp.rf is not None:
                sp.rf.__exit__(None, None, None)
                sp.rf = None
            stack = self._local.stack
            if stack[-1] is sp:
                stack.pop()
            else:
                stack.remove(sp)
        self._ring.append(sp)
        key = (sp.scope, sp.name)
        with self._lock:
            tot = self._totals.get(key)
            if tot is None:
                self._totals[key] = [1, t - sp.start_ns]
            else:
                tot[0] += 1
                tot[1] += t - sp.start_ns

    def record(self, name, start_ns, end_ns, parent):
        """A closed span of [start_ns, end_ns] on this thread under the
        open span ``parent``, with its set id, and out of the totals: one
        piece of work done for several sets (a batch) is a span of one of
        them, and is recorded again so under each other set it served."""
        sp = _Open()
        sp.name, sp.id, sp.parent, sp.set_id = name, next(self._ids), parent.id, parent.set_id
        sp.thread, sp.start_ns, sp.end_ns = self._local.ident, start_ns, end_ns
        sp.profiled = _profiler._is_profiler_enabled
        self._ring.append(sp)

    def spans(self, since=0):
        """The ring's closed spans with an id of at least ``since``
        (``new_id()`` marks a point), in the order they closed."""
        return [Span(s.name, s.id, s.parent, s.set_id, s.thread, s.start_ns, s.end_ns, s.profiled)
                for s in self._ring.copy() if s.id >= since]

    def totals(self, scope=None):
        """{name: (count, ns)} of every span closed under ``scope``."""
        with self._lock:
            return {name: tuple(tot) for (s, name), tot in self._totals.items() if s == scope}

    def to_profiler_ns(self, t_ns):
        """A ``perf_counter_ns`` time on the profiler's (``time.time_ns``) clock."""
        return t_ns + self.offset_ns


def self_times(spans):
    """{span id: self ns}: each span's duration less the part of it that
    its children among ``spans`` cover."""
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, end), min(b, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


RECORDER = Recorder()
