"""Share, in %, of the resident window's Mapper.stitch calls that
replayed the Mapper's CUDA graph: those whose ``mapper.stitch`` span
has a ``mapper.replay`` child (the port's recorder).  Where the recorder
holds no ``mapper.capture`` or ``mapper.replay`` span at all (a program
without the graph, or a CPU run), there is nothing to read."""

from benchmark.spans import _port_timer, window

GRAPH_SPANS = ("mapper.capture", "mapper.replay")


def read(rec):
    w = window(rec, "mapper.stitch")
    if w is None or not any(s.name in GRAPH_SPANS for s in _port_timer().RECORDER.spans()):
        return None
    sets, kids, _ = w
    replayed = sum(any(k.name == "mapper.replay" for k in kids.get(s.id, ())) for s in sets)
    return 100.0 * replayed / len(sets)
