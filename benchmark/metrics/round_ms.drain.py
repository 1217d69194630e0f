"""Conflict loop: the mean time of one conflict round (the program's
``assign.round`` span: the round's launches and its continue test) in
the cycles before the traced stretch, in ms."""

from benchmark.program_spans import window_phases


def read(rec, ctx):
    got = window_phases(rec, ctx)
    if got is None:
        return None
    count, total = got[1].get("assign.round", (0, 0.0))
    return total / count * 1e3 if count else None
