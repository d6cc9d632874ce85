"""Per-layer numbers read from the spans under a replayed Mapper.stitch
call: the children of its ``mapper.replay`` span in the port's recorder
(``octvr_tpu_torch.runtime.timer.RECORDER``), ``mapper.copy_in`` (the
frames checked and copied into the graph's static inputs),
``mapper.launch`` (the graph launch) and ``mapper.copy_out`` (the
output copies and the done event).

A resident set is the window's sets of ``spans.window``: one
``mapper.stitch`` call an output, summed.  Where the program records no
such span (a checkout before them) there is nothing to read.
"""

from .spans import _port_timer, window
from .stats import percentile


def replay_child_ms(rec, name, q=50.0):
    """The ``q``-th percentile over the resident window's sets of the
    host ms that the set's ``name`` spans took together, over the
    replays of all its calls; None where the recorder holds none."""
    w = window(rec, "mapper.stitch")
    if w is None:
        return None
    sets, kids, _ = w
    per_replay = {}
    for s in _port_timer().RECORDER.spans():
        if s.name == name:
            per_replay[s.parent] = per_replay.get(s.parent, 0) + s.end_ns - s.start_ns
    if not per_replay:
        return None
    return percentile([sum(per_replay.get(k.id, 0) for k in kids.get(s.id, ())) / 1e6 for s in sets], q)
