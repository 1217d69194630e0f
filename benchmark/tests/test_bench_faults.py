"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted in the program (the port's loop or encoder) for
the length of one run of the harness on the CPU, past its look for a
card: an answer altered where it is produced, half of each batch left
out, and a step that leaves the state it was given unchanged.  (The
cells run on one card, so no exchange between cards exists to leave
out.)
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import run
from benchmark.tests.conftest import cell
from kubernetesnetawarescheduler_tpu_torch.core import encode, loop

CELLS = ("k8s5000-standalone.saturation", "k8s5000-standalone.latency-pods")


def altered_answer(monkeypatch):
    """Every placement the device hands back moves to the next node."""
    orig = loop._to_host

    def shifted(x):
        a = orig(x)
        return np.where(a >= 0, (a + 1) % 96, a).astype(a.dtype)

    monkeypatch.setattr(loop, "_to_host", shifted)


def half_left_out(monkeypatch):
    """Only the first half of each cycle's pods is bound; the rest is
    dropped without a word."""
    orig = loop.SchedulerLoop._bind_all

    def half(self, pods, assignment, node_table=None):
        k = len(pods) // 2
        return orig(self, pods[:k], assignment[:k], node_table)

    monkeypatch.setattr(loop.SchedulerLoop, "_bind_all", half)


def state_unchanged(monkeypatch):
    """Commits leave the ledger as it was."""
    monkeypatch.setattr(encode.Encoder, "commit_many",
                        lambda self, pods, node_indices: None)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", (altered_answer, half_left_out,
                                   state_unchanged))
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    root, bench = tiny
    fault(monkeypatch)
    out = run.measure(bench, cell(bench, name), 21, 1.5, False, "cpu",
                      time.perf_counter(), root=root)
    assert not out["correct"], out["checks"]
