"""Median over the resident window's sets of the host ms in their calls'
``mapper.launch`` spans (the port's recorder): each replayed graph's
launch, which waits for room in the launch queue once it is full."""

from benchmark.replay_spans import replay_child_ms


def read(rec):
    return replay_child_ms(rec, "mapper.launch")
