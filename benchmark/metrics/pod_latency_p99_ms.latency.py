"""99th percentile, by nearest rank, of each pod's time from its due time
to the API server's acceptance of its bind, over the pods due in the
window before the profiled stretch opened (the profiler slows the cycles
it records into bursts), in ms; a pod never bound counts as the
longest."""

import math

from benchmark.readers import nearest_rank


def read(rec, ctx):
    lat, due = rec.get("latency_s"), rec.get("latency_due_s")
    if lat is None or due is None:
        return None
    cut = rec.get("stretch_at_s", math.inf)
    values = [x for x, d in zip(lat, due) if d < cut]
    p99 = nearest_rank(values + [math.inf] * rec["failed"], 99.0)
    return None if p99 is None or math.isinf(p99) else p99 * 1e3
