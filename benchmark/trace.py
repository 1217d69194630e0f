"""A traced stretch of the window: ``torch.profiler`` around it, the
Chrome trace read back, and the device's activity reduced to numbers.

The stretch is marked by a ``bench.stretch`` range; the harness's own
spans (``bench.<layer>``, :mod:`benchmark.spans`) name what the host was
doing while the device idled.  What comes out:

- ``busy_s``: the union of the device's activity (kernels, copies,
  memsets) inside the stretch, and ``window_s`` its length;
- ``kernels``: device seconds by kernel name;
- ``idle``: idle device seconds by the innermost harness span that was
  open on the host at the middle of each gap (``host`` where none was);
- ``host_syncs``: the CUDA runtime's synchronising calls in the stretch.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
STRETCH = "bench.stretch"


class Stretch:
    """Enter to start the profiler and the stretch's range, exit to stop
    both (on the thread that entered); :meth:`reduce` then reads the
    trace back, off the serving path."""

    def __init__(self, device_type: str) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._range = torch.profiler.record_function(STRETCH)

    def __enter__(self):
        self._prof.__enter__()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events)


def kernel_name(name: str) -> str:
    """A device operation's name without its return type, namespaces,
    template arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    name = name.split("(")[0].split("<")[0].strip()
    return name.split("::")[-1] or name


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list[dict]) -> dict:
    """The numbers of one stretch from its Chrome trace events
    (timestamps in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == STRETCH]
    if not marks:
        raise ValueError("trace holds no stretch range")
    lo = min(float(e["ts"]) for e in marks)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    dev = []
    kernels: dict[str, float] = {}
    syncs = 0
    host = []
    for e in spans:
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            dev.append((a, b))
            name = kernel_name(e["name"])
            kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
        elif cat == "cuda_runtime" and e.get("name") in SYNC_CALLS:
            if lo <= a <= hi:
                syncs += 1
        elif (cat == "user_annotation"
              and e.get("name", "").startswith("bench.")
              and e["name"] != STRETCH):
            host.append((a, b, e["name"][len("bench."):]))
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    idle: dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host.sort()
    active: list = []
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = (min(active, key=lambda h: h[1] - h[0])[2]
                 if active else "host")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": kernels, "idle": idle, "host_syncs": syncs}


def top(d: dict[str, float], k: int = 10) -> list[list]:
    return [[name, sec] for name, sec in
            sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:k]]
