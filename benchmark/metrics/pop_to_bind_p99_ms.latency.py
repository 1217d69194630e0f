"""Scheduling loop: the 99th percentile, by nearest rank, of each pod's
time from a cycle's pop to the API server's acknowledgement of its bind
(the program's per-pod record) over the pods popped before the traced
stretch, in ms; a pod never acknowledged counts as the longest."""

import math

from benchmark.program_spans import popped_before_stretch
from benchmark.readers import nearest_rank


def read(rec, ctx):
    pods = popped_before_stretch(rec, ctx)
    if not pods:
        return None
    p99 = nearest_rank([math.inf if ack is None else ack - pop
                        for _enq, pop, ack in pods], 99.0)
    return None if math.isinf(p99) else p99 * 1e3
