"""The program's own record of the conflict loop and the pod queue, for
the per-layer metrics that read it.

The port times its cycles' inner stretches as spans (``utils/tracing.py``:
``assign.static``, ``assign.round``, ``sync.<site>``, ``replay.batch``,
...) and keeps them, with per-pod timelines (enqueued, popped, bind
acknowledged), in its flight recorder (``utils/flight.py``).  The
readers find the recorder through ``flight.recent()`` in the run's own
process, after the driver has returned, and read the stretch of the
window before the profiled stretch, on the program's clock
(``perf_counter``, the clock of ``ctx.t0``).  While a profiler collects,
the same spans are ``netaware.<name>`` ranges of the device trace, and
:func:`idle_program` puts the device's idle time under them.

A program without that record (no ``flight.recent``, or no such spans)
gives None, and the line leaves the metric out.
"""

from __future__ import annotations

import math

from benchmark.trace import DEVICE_CATS, STRETCH, _merge

PREFIX = "netaware."
SYNC = "sync."


def recorders() -> list:
    """The program's newest flight recorders, newest first."""
    try:
        from kubernetesnetawarescheduler_tpu_torch.utils import flight
    except ImportError:
        return []
    recent = getattr(flight, "recent", None)
    return list(reversed(recent())) if recent is not None else []


def opened_at(ctx):
    """The window's opening on the program's clock, or None."""
    if ctx is None or getattr(ctx, "setup_s", None) is None:
        return None
    return ctx.t0 + ctx.setup_s


def window_phases(rec: dict, ctx):
    """``(cycles, {span: [count, seconds]})`` over the child spans of the
    cycles begun from the window's opening up to the profiled stretch
    (``trace_at_s`` into the window; the whole window when that is
    shorter), or None."""
    lo = opened_at(ctx)
    if lo is None:
        return None
    hi = lo + min(float(ctx.traffic.get("trace_at_s", math.inf)),
                  float(rec.get("window_s", math.inf)))
    for recorder in recorders():
        spans = [s for s in recorder.spans() if lo <= s.t_mono < hi]
        if spans:
            out: dict[str, list] = {}
            for s in spans:
                for name, _start, dur in s.phases:
                    acc = out.setdefault(name, [0, 0.0])
                    acc[0] += 1
                    acc[1] += dur
            return len(spans), out
    return None


def syncs(phases: dict) -> tuple[int, float]:
    """Host syncs counted and waited for (s), summed over their sites."""
    n, sec = 0, 0.0
    for name, (count, total) in phases.items():
        if name.startswith(SYNC):
            n += count
            sec += total
    return n, sec


def popped_before_stretch(rec: dict, ctx):
    """``(enqueued, popped, acked)`` of the pods popped from the window's
    opening up to the profiled stretch (``acked`` None for a pod whose
    bind was never acknowledged), or None."""
    lo = opened_at(ctx)
    if lo is None:
        return None
    hi = lo + float(rec.get("stretch_at_s", math.inf))
    for recorder in recorders():
        pods = getattr(recorder, "pods", None)
        if pods is None:
            continue
        got = [(enq, pop, ack) for _uid, enq, pop, ack in pods.records()
               if lo <= pop < hi]
        if got:
            return got
    return None


def idle_program(events: list[dict]) -> dict:
    """Idle device seconds of a traced stretch by the innermost program
    span open on the host at each gap's middle (``netaware.<name>``;
    ``cycle <id>`` counts as ``cycle``; ``host`` where none was), the
    rule ``benchmark/trace.reduce_events`` applies to the harness's own
    spans; and the program spans' seconds in the stretch, by name.
    Chrome trace events, timestamps in microseconds."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == STRETCH]
    if not marks:
        raise ValueError("trace holds no stretch range")
    lo = min(float(e["ts"]) for e in marks)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    dev, prog = [], []
    program_s: dict[str, float] = {}
    for e in spans:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat", "") in DEVICE_CATS:
            if min(b, hi) > max(a, lo):
                dev.append((max(a, lo), min(b, hi)))
        elif (e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PREFIX)):
            name = e["name"][len(PREFIX):].split(" ")[0]
            prog.append((a, b, name))
            if min(b, hi) > max(a, lo):
                program_s[name] = (program_s.get(name, 0.0)
                                   + (min(b, hi) - max(a, lo)) * 1e-6)
    edges = [lo] + [x for iv in _merge(dev) for x in iv] + [hi]
    idle: dict[str, float] = {}
    prog.sort()
    active: list = []
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(prog) and prog[j][0] <= mid:
            active.append(prog[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = (min(active, key=lambda h: h[1] - h[0])[2]
                 if active else "host")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"idle_program": idle, "program_s": program_s}
