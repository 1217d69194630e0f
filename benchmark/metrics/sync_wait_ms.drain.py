"""Conflict loop: the host's time waiting on the device per cycle (the
program's ``sync.<site>`` spans, all sites) before the traced stretch,
in ms."""

from benchmark.program_spans import syncs, window_phases


def read(rec, ctx):
    got = window_phases(rec, ctx)
    if got is None:
        return None
    cycles, phases = got
    n, sec = syncs(phases)
    return sec / cycles * 1e3 if n else None
