"""Conflict loop: the share of conflict rounds that ran as the
hand-written round kernels (the program's ``assign.fused`` count over its
``assign.round`` count) before the traced stretch.  A program whose
rounds ran and none as the kernels, as before they existed, gives 0.0;
one that ran no round gives None."""

from benchmark.program_spans import window_phases


def read(rec, ctx):
    got = window_phases(rec, ctx)
    if got is None:
        return None
    counts = {name: acc[0] for name, acc in got[1].items()}
    rounds = counts.get("assign.round", 0)
    if not rounds:
        return None
    return counts.get("assign.fused", 0) / rounds
