"""Device: the share of the traced stretch in which no kernel, copy or
memset ran."""

from benchmark.readers import idle_share


def read(rec, ctx):
    return idle_share(rec)
