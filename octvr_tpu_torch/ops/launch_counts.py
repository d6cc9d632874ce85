"""Launch counts of the hand-written kernels, one ``Counter`` per kernel
family (``cuda_remap``, ``cuda_pyramid``, ``mxu_taps``), so that a run
can show that each of its paths went through its kernels.

A launch captured into a CUDA graph runs only when the graph is
replayed: inside ``deferred()`` the launches of every family made on
this thread are held apart in the yielded dict, and ``replay(held)``
counts them, once per replay of the graph.
"""

import threading
from contextlib import contextmanager

__all__ = ["Counter", "deferred", "replay"]

_LOCAL = threading.local()  # .held: the dict of an open deferred()


class Counter:
    """The launches of one kernel family: ``counts`` per variant
    ({variant: launches}) and ``launches`` in all."""

    def __init__(self):
        self.counts = {}

    @property
    def launches(self):
        return sum(self.counts.values())

    def reset(self):
        """Set every count to 0."""
        self.counts.clear()

    def add(self, counts):
        """Count launches ({variant: launches}), or, inside ``deferred``
        on this thread, hold them in its dict."""
        held = getattr(_LOCAL, "held", None)
        into = self.counts if held is None else held.setdefault(self, {})
        for key, n in counts.items():
            into[key] = into.get(key, 0) + n

    def module_getattr(self, module):
        """The ``__getattr__`` of a kernel family's module ``module``,
        which reads its ``LAUNCHES`` from this counter."""

        def getattr_(name):
            if name == "LAUNCHES":
                return self.launches
            raise AttributeError(f"module {module!r} has no attribute {name!r}")

        return getattr_


@contextmanager
def deferred():
    """Launches made inside, on this thread, of every family go to the
    yielded dict ({Counter: {variant: launches}}) and are not counted: a
    graph's capture, whose launches run at its replays."""
    prev = getattr(_LOCAL, "held", None)
    _LOCAL.held = held = {}
    try:
        yield held
    finally:
        _LOCAL.held = prev


def replay(held):
    """Count the launches that ``deferred`` held: one replay of the
    graph that holds them."""
    for counter, counts in held.items():
        counter.add(counts)
