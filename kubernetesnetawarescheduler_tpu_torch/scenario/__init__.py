"""Trace-driven scenario engine.

The PyTorch package's copy of the JAX package's ``scenario/``.  Three
parts, importable independently:

- :mod:`.generate` — seeded workload generator emitting a replayable
  JSONL event trace (diurnal arrival waves, mixed pod classes,
  heterogeneous node classes, correlated link-degradation bursts,
  node churn) with a versioned header.
- :mod:`.replay` — streaming replay harness driving a trace through
  the REAL serving stack (SchedulerLoop + FakeCluster / chaos proxy)
  at configurable time compression, with bounded memory so millions
  of pods stream without materializing the trace.
- :mod:`.scorecard` — the outcome scorecard: realized bandwidth vs a
  sampled oracle, gang wait time, rebalance disruption, repair
  events, SLO burn windows and p99s — reusing obs/quality's regret
  join and obs/slo's burn math.

Re-exports are LAZY (PEP 562): ``.generate`` and ``.scorecard`` are
reached without paying :mod:`.replay`'s serving-stack import.
"""

from typing import Any

__all__ = [
    "ScenarioSpec", "TRACE_FORMAT", "TRACE_VERSION",
    "generate_trace", "read_trace",
    "ReplayResult", "replay_trace",
    "build_scorecard", "check_scorecard",
]

_HOME: dict[str, str] = {
    "ScenarioSpec": "generate", "TRACE_FORMAT": "generate",
    "TRACE_VERSION": "generate", "generate_trace": "generate",
    "read_trace": "generate",
    "ReplayResult": "replay", "replay_trace": "replay",
    "build_scorecard": "scorecard", "check_scorecard": "scorecard",
}


def __getattr__(name: str) -> Any:
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
