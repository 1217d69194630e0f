"""Static score kernel: the least time its launches in the traced stretch
need at the card's peaks, over their device time, in %."""

from benchmark.readers import roofline


def read(rec, ctx):
    return roofline(rec, "static_scores_kernel")
