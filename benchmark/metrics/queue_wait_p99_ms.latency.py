"""Informer and queue: the 99th percentile, by nearest rank, of each
pod's wait in the queue (from the queue's push to a cycle's pop, the
program's per-pod record) over the pods popped before the traced
stretch, in ms."""

from benchmark.program_spans import popped_before_stretch
from benchmark.readers import nearest_rank


def read(rec, ctx):
    pods = popped_before_stretch(rec, ctx)
    if not pods:
        return None
    return nearest_rank([pop - enq for enq, pop, _ack in pods], 99.0) * 1e3
