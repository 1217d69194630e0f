"""``graph_round_share.drain``: the share of conflict rounds the program
launched as a CUDA graph, read from its spans before the traced stretch:
0.0 from a program whose rounds all ran eagerly, and None from one that
does not mark how it launched a round."""

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

NAME = "graph_round_share.drain"
EAGER = [("assign.round", 0.009), ("assign.eager", 0.008),
         ("assign.round", 0.009), ("assign.eager", 0.008)]


def test_share_counts_replays_over_rounds_before_the_stretch():
    rec = FlightRecorder(capacity=16)
    replayed = [("assign.static", 0.004), ("assign.capture", 0.050),
                ("assign.round", 0.002), ("assign.replay", 0.001),
                ("assign.round", 0.001), ("assign.replay", 0.001)]
    _cycle(rec, T_OPEN - 1.0, EAGER)              # set-up: not read
    _cycle(rec, T_OPEN + 1.0, replayed)
    _cycle(rec, T_OPEN + 2.0, replayed + EAGER)
    _cycle(rec, T_OPEN + 6.0, EAGER)              # in the stretch
    line = {"window_s": 40.0}
    assert run.reader(NAME).read(line, _ctx()) == pytest.approx(4 / 6)


def test_share_is_zero_when_every_round_ran_eagerly():
    rec = FlightRecorder(capacity=4)
    _cycle(rec, T_OPEN + 1.0, [("assign.static", 0.004), *EAGER])
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) == 0.0


def test_share_is_none_without_replays():
    assert run.reader(NAME).read({"window_s": 40.0}, None) is None
    rec = FlightRecorder(capacity=4)
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) is None
    # The parent's cycles: rounds, and no mark of how they launched.
    _cycle(rec, T_OPEN + 1.0, [("assign.round", 0.009),
                               ("sync.assign.continue", 0.0001)])
    assert run.reader(NAME).read({"window_s": 40.0}, _ctx()) is None
