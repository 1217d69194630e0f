"""The port's fused schedule step and window, on the CPU: equal to the
port's ``schedule_batch`` in every output, and to the JAX package's
``fused_schedule_step`` in its assignments and round counts, for both
methods and three seeds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetesnetawarescheduler_tpu.config import SchedulerConfig as JCfg
from kubernetesnetawarescheduler_tpu.core import assign as jassign
from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig as TCfg,
)
from kubernetesnetawarescheduler_tpu_torch.core import assign as tassign
from kubernetesnetawarescheduler_tpu_torch.core import integrity as tint
from kubernetesnetawarescheduler_tpu_torch.core import state as tstate

from tests import gen

# One intra-op thread per test process: the suite runs in parallel
# workers beside wall-clock tests.
torch.set_num_threads(1)

KW = dict(max_nodes=64, max_pods=16, max_peers=4, use_bfloat16=False)


def _both(seed, n_pods=12):
    jcfg, tcfg = JCfg(**KW), TCfg(**KW)
    rng = np.random.default_rng(seed)
    state_np, pods_np = gen.random_instance(rng, jcfg, n_nodes=48,
                                            n_pods=n_pods)
    js, jp = gen.to_pytrees(jcfg, state_np, pods_np)
    return (jcfg, tcfg, js, jp,
            tstate.state_from_numpy(tcfg, state_np, "cpu"),
            tstate.pods_from_numpy(tcfg, pods_np, "cpu"))


def _assert_states_equal(a, b) -> None:
    for name, arr in a.numpy().items():
        np.testing.assert_array_equal(arr.view(np.uint8),
                                      b.numpy()[name].view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("method", ["parallel", "greedy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_step_matches_schedule_batch_and_jax(seed, method):
    jcfg, tcfg, js, jp, ts, tp = _both(seed)
    want_assign, want_state = tassign.schedule_batch(ts, tp, tcfg, method)
    new_state, assignment, rounds, digest = tassign.fused_schedule_step(
        ts, tp, tcfg, method=method, with_digest=True)
    assert torch.equal(assignment, want_assign)
    _assert_states_equal(new_state, want_state)
    np.testing.assert_array_equal(
        digest.numpy().view(np.uint32),
        tint.host_plane_digest_vector(new_state.numpy()))
    # The untouched N×N planes are shared with the input, not copied.
    assert new_state.lat is ts.lat and new_state.bw is ts.bw

    j_state, j_assign, j_rounds = jassign.fused_schedule_step(
        jax.tree.map(jnp.array, js), jp, jcfg, method=method)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(j_assign))
    assert int(rounds) == int(j_rounds)
    # Co-located pods add into ``used`` through a one-hot product here,
    # a sequential scatter there: equal up to an ulp.
    np.testing.assert_allclose(new_state.used.numpy(),
                               np.asarray(j_state.used), rtol=1e-6,
                               atol=1e-6)
    for name in ("group_bits", "resident_anti", "gz_counts", "az_anti"):
        np.testing.assert_array_equal(
            getattr(new_state, name).numpy(),
            np.asarray(getattr(j_state, name)).view(np.int32)
            if name != "gz_counts" else np.asarray(j_state.gz_counts),
            err_msg=name)


@pytest.mark.parametrize("method", ["parallel", "greedy"])
def test_fused_window_equals_chained_steps(method):
    jcfg, tcfg, js, jp, ts, tp = _both(7)
    batches = [tp, tp.replace(priority=tp.priority.flip(0)), tp]
    window = tstate.PodBatch(**{
        name: torch.stack([getattr(b, name) for b in batches])
        for name in tp.numpy()})
    state, assignment, rounds = tassign.fused_schedule_window(
        ts, window, tcfg, method=method)
    s = ts
    for k, b in enumerate(batches):
        s, a, r = tassign.fused_schedule_step(s, b, tcfg, method=method)
        assert torch.equal(assignment[k], a)
        assert int(rounds[k]) == int(r)
    _assert_states_equal(state, s)
    jwin = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jp, jp.replace(priority=jp.priority[::-1]), jp])
    _, j_assign, _ = jassign.fused_schedule_window(
        jax.tree.map(jnp.array, js), jwin, jcfg, method=method)
    np.testing.assert_array_equal(assignment.numpy(), np.asarray(j_assign))


def test_fused_step_rejects_unknown_method():
    _, tcfg, _, _, ts, tp = _both(0, n_pods=2)
    with pytest.raises(ValueError):
        tassign.fused_schedule_step(ts, tp, tcfg,
                                    method="simulated-annealing")
    with pytest.raises(ValueError):
        tassign.fused_schedule_window(ts, tp, tcfg, method="anneal")
