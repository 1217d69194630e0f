"""Arithmetic the metric readers share (``benchmark/metrics/``)."""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent


def per_cycle_ms(rec: dict, phase: str):
    """A program phase's total time per cycle, in ms, from the window's
    opening to the traced stretch (the profiler slows the cycles it
    records): the loop's ``PhaseTimer`` total (its counts and totals are
    exact; its percentiles are not read)."""
    cycles = rec.get("cycles", 0)
    if not cycles or phase not in rec.get("timer", {}):
        return None
    return rec["timer"][phase][1] / cycles * 1e3


def idle_share(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def nearest_rank(values, q: float):
    """The ``q``-th percentile by nearest rank (no interpolation)."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def peaks() -> dict:
    with open(HERE / "peaks.json", encoding="utf-8") as fh:
        return json.load(fh)


def work(kernel: str):
    """The work-count module of ``kernel`` (``benchmark/work/``)."""
    path = HERE / "work" / f"{kernel}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.work.{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline(rec: dict, kernel: str):
    """Share of its roofline that ``kernel`` reached in the traced
    stretch, in %: the least time the launches' problem needs at the
    card's peaks, over the device time of the kernels that did it."""
    tr = rec.get("trace")
    launches = (rec.get("launches") or {}).get(kernel)
    if not tr or not launches:
        return None
    w = work(kernel)
    pk = peaks()
    least = sum(w.least_seconds(launch, pk) for launch in launches)
    spent = sum(sec for name, sec in tr["kernels"].items()
                if name in w.KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least / spent
