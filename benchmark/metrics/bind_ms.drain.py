"""Binds: the loop's bind time per cycle before the
traced stretch, in ms."""

from benchmark.readers import per_cycle_ms


def read(rec, ctx):
    return per_cycle_ms(rec, "bind")
