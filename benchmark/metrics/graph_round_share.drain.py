"""Conflict loop: the share of conflict rounds launched as one CUDA
graph (the program's ``assign.replay`` count over its ``assign.round``
count) before the traced stretch.  A program that marks how it launched
a round (``assign.replay`` for a graph, ``assign.eager`` for an eager
round) and replayed none gives 0.0; one that marks neither, as before
the round had a graph, gives None."""

from benchmark.program_spans import window_phases


def read(rec, ctx):
    got = window_phases(rec, ctx)
    if got is None:
        return None
    counts = {name: acc[0] for name, acc in got[1].items()}
    rounds = counts.get("assign.round", 0)
    replays = counts.get("assign.replay", 0)
    if not rounds or not replays + counts.get("assign.eager", 0):
        return None
    return replays / rounds
