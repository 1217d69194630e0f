"""``fused_round_share.drain``: the share of conflict rounds that ran as
the hand-written round kernels, read from the program's spans before the
traced stretch: 0.0 from a program whose rounds ran and none fused, and
None from one that ran no round."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tests.test_bench_program_spans import (  # noqa: F401
    T_OPEN,
    _ctx,
    _cycle,
    _own_recorders,
)
from kubernetesnetawarescheduler_tpu_torch.utils.flight import (
    FlightRecorder,
)

NAME = "fused_round_share.drain"
GRAPH = [("assign.round", 0.002), ("assign.replay", 0.001),
         ("assign.round", 0.002), ("assign.replay", 0.001)]
FUSED = [("assign.round", 0.0003), ("assign.replay", 0.0002),
         ("assign.fused", 0.0002)]


def test_share_counts_fused_rounds_over_rounds_before_the_stretch():
    rec = FlightRecorder(capacity=16)
    _cycle(rec, T_OPEN - 1.0, FUSED)              # set-up: not read
    _cycle(rec, T_OPEN + 1.0, [("assign.static", 0.004), *FUSED, *FUSED])
    _cycle(rec, T_OPEN + 2.0, FUSED + GRAPH)
    _cycle(rec, T_OPEN + 6.0, GRAPH)              # in the stretch
    line = {"window_s": 40.0}
    assert run.reader(NAME).read(line, _ctx()) == pytest.approx(3 / 5)


def test_share_is_zero_when_rounds_ran_and_none_fused():
    rec = FlightRecorder(capacity=4)
    _cycle(rec, T_OPEN + 1.0, [("assign.static", 0.004), *GRAPH])
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) == 0.0
    # The parent's eager rounds, before the round had a graph.
    rec = FlightRecorder(capacity=4)
    _cycle(rec, T_OPEN + 1.0, [("assign.round", 0.009),
                               ("sync.assign.continue", 0.0001)])
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) == 0.0


def test_share_is_none_without_rounds():
    assert run.reader(NAME).read({"window_s": 40.0}, None) is None
    rec = FlightRecorder(capacity=4)
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) is None
    _cycle(rec, T_OPEN + 1.0, [("assign.static", 0.004),
                               ("encode", 0.001)])
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) is None
