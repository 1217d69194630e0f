"""Conflict loop: the program's host syncs (``sync.<site>`` counts, all
sites) per conflict round (``assign.round`` count) before the traced
stretch."""

from benchmark.program_spans import syncs, window_phases


def read(rec, ctx):
    got = window_phases(rec, ctx)
    if got is None:
        return None
    rounds = got[1].get("assign.round", (0, 0.0))[0]
    n, _sec = syncs(got[1])
    return n / rounds if rounds and n else None
