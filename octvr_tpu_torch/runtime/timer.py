"""Phase timer + rolling FPS meter (vr::Timer, octvr/src/timer.cpp:36-70;
FPS aggregation as in async.cpp:141-147).  Prints the reference's
``[Timer name] msg: X ms`` format for parity debugging.  The port's copy
of octvr_tpu/runtime/timer.py."""

import sys
import time
from collections import deque

__all__ = ["Timer", "FpsMeter"]


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
