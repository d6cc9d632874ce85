"""Median over the resident window's sets of the host ms in their calls'
``mapper.copy_in`` spans (the port's recorder): the frames checked and
copied into each replayed graph's static inputs."""

from benchmark.replay_spans import replay_child_ms


def read(rec):
    return replay_child_ms(rec, "mapper.copy_in")
