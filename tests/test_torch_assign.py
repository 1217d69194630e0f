"""The port's batch-conflict assignment against the JAX package's.

Assignments must be identical (``assert_array_equal``) under both score
backends: the port's conflict loop, multi-accept prefix (with the same
odd/even prefix-sum order as ``lax.associative_scan``), second-chance
pass and zone overlay are held to the reference decision for decision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import assign as jassign
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import assign as tassign
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=160, max_pods=24, max_peers=6, use_bfloat16=False)
SMALL = dict(max_nodes=16, max_pods=12, max_peers=4, use_bfloat16=False)


def _both(seed, kw, n_nodes, n_pods, zone=True, **gen_kw):
    """Both packages' (cfg, state, pods) for one random instance;
    ``zone=False`` drops its zone-scoped terms (spread, zone
    (anti-)affinity, zone-anti residents) and keeps the rest."""
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=n_nodes,
                                            n_pods=n_pods, **gen_kw)
    if not zone:
        for key in ("spread_maxskew", "zaff_bits", "zanti_bits"):
            pods_np[key] = np.zeros_like(pods_np[key])
        state_np["az_anti"] = np.zeros_like(state_np["az_anti"])
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    ts = tstate.state_from_numpy(tcfg, state_np, "cpu")
    tp = tstate.pods_from_numpy(tcfg, pods_np, "cpu")
    return jcfg, tcfg, js, jp, ts, tp


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parallel_matches_jax(seed, backend):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, KW, 150, 20)
    jcfg = dataclasses.replace(jcfg, score_backend="xla")
    tcfg = dataclasses.replace(tcfg, score_backend=backend)
    want, want_rounds = jassign.assign_parallel(js, jp, jcfg,
                                                with_stats=True)
    got, rounds = tassign.assign_parallel(ts, tp, tcfg, with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_small_contended_batches_match_jax(seed):
    """Few nodes, many pods: multi-accept prefixes, second chances and
    zone caps all fire."""
    jcfg, tcfg, js, jp, ts, tp = _both(seed, SMALL, 12, 10)
    for fn_j, fn_t in ((jassign.assign_parallel, tassign.assign_parallel),
                       (jassign.assign_greedy, tassign.assign_greedy)):
        np.testing.assert_array_equal(fn_t(ts, tp, tcfg).numpy(),
                                      np.asarray(fn_j(js, jp, jcfg)))


@pytest.mark.parametrize("zone", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 3, 5, 7])
def test_round_without_host_gates_matches_jax(seed, zone, monkeypatch):
    """The port's round has no host gate (the body a CUDA graph
    captures): its second-chance pass runs whatever pass A left, and its
    zone overlay is ungated.  Its assignment and round count equal the
    JAX package's, which gates both.  Few nodes and many pods: without
    zone terms pass B places pods in some rounds of these seeds and none
    in others; with them it never runs."""
    jcfg, tcfg, js, jp, ts, tp = _both(seed, SMALL, 12, 10, zone=zone)
    placed = []
    add = tassign.scatter_add_rows

    def counted(base, idx, vals, mask):
        placed.append(int(mask.sum()))
        return add(base, idx, vals, mask)

    monkeypatch.setattr(tassign, "scatter_add_rows", counted)
    want, want_rounds = jassign.assign_parallel(js, jp, jcfg,
                                                with_stats=True)
    got, rounds = tassign.assign_parallel(ts, tp, tcfg, with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    if zone:
        assert len(placed) == rounds
    else:
        assert len(placed) == 2 * rounds
        assert 0 in placed[1::2]


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_jax(seed):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, KW, 150, 20)
    np.testing.assert_array_equal(
        tassign.assign_greedy(ts, tp, tcfg).numpy(),
        np.asarray(jassign.assign_greedy(js, jp, jcfg)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_agrees_with_parallel_when_conflict_free(seed):
    """No constraints and ample capacity: the batch has no conflicts, so
    the sequential oracle and the conflict loop place every pod alike."""
    jcfg, tcfg, js, jp, ts, tp = _both(seed, SMALL, 12, 10,
                                       with_constraints=False)
    ts = ts.replace(cap=ts.cap * 1000.0)
    greedy = tassign.assign_greedy(ts, tp, tcfg)
    parallel = tassign.assign_parallel(ts, tp, tcfg)
    np.testing.assert_array_equal(greedy.numpy(), parallel.numpy())
    assert (greedy[:10] >= 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_mask_and_balance_match_jax(seed):
    jcfg, tcfg, js, jp, ts, tp = _both(seed, KW, 150, 20)
    got = tassign._dynamic_mask(tp, ts.used, ts.cap, ts.group_bits,
                                ts.resident_anti)
    want = jassign._dynamic_mask(jp, js.used, js.cap, js.group_bits,
                                 js.resident_anti)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tassign._balance(tp, ts.used, ts.cap).numpy(),
        np.asarray(jassign._balance(jp, js.used, js.cap)), rtol=1e-6)


def test_int32_key_guard_raises():
    """(N + 1) * P past int32 would wrap the composite winner key."""
    cfg = TCfg(max_nodes=8, max_pods=128, max_peers=1)
    n = 2 ** 24
    big = tstate.init_cluster_state(cfg, device="cpu")
    big = big.replace(metrics=torch.zeros((1, cfg.num_metrics)).expand(
        n, cfg.num_metrics))
    pods = tstate.init_pod_batch(cfg, device="cpu")
    with pytest.raises(ValueError, match="overflows the int32"):
        tassign.assign_parallel(big, pods, cfg)


def test_schedule_batch_commits_assignment():
    jcfg, tcfg, js, jp, ts, tp = _both(2, SMALL, 12, 10)
    a, new = tassign.schedule_batch(ts, tp, tcfg)
    want = tstate.commit_assignments(ts, tp, a)
    assert torch.equal(new.used, want.used)
    assert torch.equal(new.group_bits, want.group_bits)
    with pytest.raises(ValueError):
        tassign.schedule_batch(ts, tp, tcfg, method="nope")


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,zone_work,req_shape,words,takes", [
    (CUDA, False, (256, 3), 4, True),
    (CUDA, False, (1, 3), 1, True),
    (CUDA, False, (1024, 4), 8, True),
    (CUDA, False, (1025, 3), 4, False),
    (CUDA, False, (256, 5), 4, False),
    (CUDA, False, (256, 3), 9, False),
    (CUDA, True, (256, 3), 4, False),
    (CPU, False, (256, 3), 4, False),
    (CPU, True, (256, 3), 4, False),
])
def test_fused_round_rule(device, zone_work, req_shape, words, takes):
    """Which batches ``assign_parallel`` runs as the hand-written round
    kernels: CUDA, no zone work, and pods, resources and mask words
    within the kernels' one-block resolve; every other batch keeps the
    round body.  The rule reads only the device's type, so it needs no
    card."""
    assert tassign.fused_round(device, zone_work, req_shape, words) is takes


@pytest.mark.parametrize("zone", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_cpu_rounds_take_the_round_body(seed, zone, monkeypatch):
    """On the CPU every round is the round body run eagerly (its plain
    version): the kernels' wrapper is never asked for a body, and no
    round is marked ``assign.fused``."""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels
    from kubernetesnetawarescheduler_tpu_torch.utils import tracing
    from kubernetesnetawarescheduler_tpu_torch.utils.flight import NULL_SPAN

    jcfg, tcfg, js, jp, ts, tp = _both(seed, SMALL, 12, 10, zone=zone)

    def refuse(*_):
        raise AssertionError("the CPU asked for the round kernels")

    monkeypatch.setattr(kernels, "conflict_round", refuse)
    timer = tracing.PhaseTimer()
    with tracing.cycle(timer, NULL_SPAN):
        got, rounds = tassign.assign_parallel(ts, tp, tcfg, with_stats=True)
    want = jassign.assign_parallel(js, jp, jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds >= 1
    assert timer.count("assign.eager") == rounds
    assert timer.count("assign.fused") == 0
    assert timer.count("assign.replay") == 0


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_round_kernels_wrapper_on_cpu_is_the_round_body(seed):
    """Given CPU tensors, the round kernels' wrapper returns their plain
    version, the round body without zone work: the same carry, bit for
    bit, round after round, and no launch counted."""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels

    _, tcfg, _, _, ts, tp = _both(seed, SMALL, 12, 10, zone=False)
    t, carry, zone_work, go = tassign._parallel_setup(ts, tp, tcfg)
    assert not zone_work and go
    launches = kernels.conflict_round.launches
    plain = tassign._round_body(t, tcfg, False)
    wrapped = kernels.conflict_round(t, tcfg)
    want, got = carry, carry
    for _ in range(3):
        *want, want_cont = plain(*want)
        *got, got_cont = wrapped(*got)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        assert bool(want_cont) == bool(got_cont)
    assert kernels.conflict_round.launches == launches
