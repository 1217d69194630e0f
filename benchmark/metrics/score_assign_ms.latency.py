"""Score and conflict loop: the loop's score_assign time per cycle
before the traced stretch, in ms."""

from benchmark.readers import per_cycle_ms


def read(rec, ctx):
    return per_cycle_ms(rec, "score_assign")
