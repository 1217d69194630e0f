"""Probe orchestrator: maintains the pairwise latency/bandwidth matrices.

The reference's probe pipeline is a shell loop (netperfScript/script.sh)
that every 60 s runs iperf3 from each node to ONE central server and
drops the JSON into the scheduler pod (run.sh:3-15) — so it measures
each node's path to the server, not node-to-node, and the scheduler
trusts whatever file was last dropped (scheduler.go:512).

Here the orchestrator measures *pairs* on a budgeted round-robin (full
N x N sweeps are O(N^2) probes — at 5k nodes that's 25M pairs, so each
cycle probes the stalest ``budget`` pairs), writes results into the
:class:`~..core.encode.Encoder` staging matrices, and tracks per-pair
staleness.  The prober itself is pluggable:

- :class:`FakeProber` — returns ground truth + noise (tests/bench);
- :class:`Iperf3Prober` — shells out to real iperf3 clients, parsing
  results with :func:`~.iperf.parse_iperf_json` (requires a live
  fleet; excluded from CI).
"""

from __future__ import annotations

import heapq
import subprocess
from typing import Protocol, Sequence

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
from kubernetesnetawarescheduler_tpu_torch.ingest.iperf import parse_iperf_json


class Prober(Protocol):
    def probe(self, a: str, b: str) -> tuple[float | None, float | None]:
        """Measure (lat_ms, bw_bps) between two nodes; ``None`` means
        "this prober has no figure for that quantity" (it is left
        untouched for another prober).  Raises on failure."""
        ...


class FakeProber:
    """Ground-truth matrices + multiplicative noise + injectable
    failures (SURVEY.md 5's fault-injection mode).

    ``asymmetry`` > 0 gives every directed pair a fixed, seeded
    multiplicative skew (A->B vs B->A bandwidth differ), and
    ``drift`` > 0 applies a seeded per-link random walk advanced by
    :meth:`advance` — both exercise the topology model's tracking
    behaviour.  Both default to 0 and draw from their own offset-seeded
    generators, so the default configuration consumes the main RNG
    stream identically to before (bit-identical probes for existing
    tests)."""

    def __init__(self, names: Sequence[str], lat_ms: np.ndarray,
                 bw_bps: np.ndarray, noise: float = 0.02,
                 fail_fraction: float = 0.0, seed: int = 0,
                 asymmetry: float = 0.0, drift: float = 0.0) -> None:
        self._index = {n: i for i, n in enumerate(names)}
        self._lat = lat_ms
        self._bw = bw_bps
        self._noise = noise
        self._fail_fraction = fail_fraction
        self._rng = np.random.default_rng(seed)
        self._asymmetry = float(asymmetry)
        self._drift_scale = float(drift)
        self.calls = 0
        n = len(self._index)
        if self._asymmetry:
            # Fixed antisymmetric skew in log space: A->B gets
            # exp(+s), B->A gets exp(-s) — same seed, same skew.
            arng = np.random.default_rng(seed + 1_000_003)
            s = arng.standard_normal((n, n)).astype(np.float64)
            self._asym = np.exp(self._asymmetry * (np.triu(s, 1)
                                                   - np.triu(s, 1).T))
        else:
            self._asym = None
        if self._drift_scale:
            self._drift_rng = np.random.default_rng(seed + 2_000_003)
            self._drift = np.zeros((n, n), np.float64)
        else:
            self._drift_rng = None
            self._drift = None

    def advance(self, steps: int = 1) -> None:
        """Advance the seeded symmetric per-link bandwidth random walk
        (no-op unless constructed with ``drift > 0``)."""
        if self._drift is None:
            return
        n = self._drift.shape[0]
        for _ in range(steps):
            step = self._drift_rng.standard_normal((n, n))
            step = np.triu(step, 1)
            self._drift += self._drift_scale * (step + step.T)

    def probe(self, a: str, b: str) -> tuple[float, float]:
        self.calls += 1
        if self._fail_fraction and self._rng.random() < self._fail_fraction:
            raise TimeoutError(f"probe {a}->{b} timed out")
        i, j = self._index[a], self._index[b]
        f = 1.0 + self._noise * float(self._rng.standard_normal())
        bw = float(self._bw[i, j])
        if self._asym is not None:
            bw *= float(self._asym[i, j])
        if self._drift is not None:
            bw *= float(np.exp(self._drift[i, j]))
        return float(self._lat[i, j] * f), bw / max(f, 0.5)


class Iperf3Prober:
    """LOCAL iperf3 probe: runs ``iperf3 -c <host_of[b]> -J`` from
    *this process* (the flags the reference uses at run.sh:12, minus
    the ``kubectl exec`` transport).

    Vantage caveat: because the client runs wherever the orchestrator
    runs, this measures the orchestrator→b path, NOT a↔b — fine for a
    single-host lab or when the orchestrator is on the only traffic
    source, wrong for a pairwise fleet matrix.  Real deployments use
    :class:`AgentProber`, which delegates the client role to node a's
    probe agent (run.sh's client-side semantics, without kubectl)."""

    def __init__(self, host_of: dict[str, str], duration_s: int = 2) -> None:
        self._host_of = host_of
        self._duration = duration_s

    def probe(self, a: str, b: str) -> tuple[None, float]:
        target = self._host_of[b]
        out = subprocess.run(
            ["iperf3", "-c", target, "-J", "-Z", "-t", str(self._duration),
             "-T", f"probe {a}->{b}"],
            capture_output=True, timeout=self._duration + 10, check=True)
        result = parse_iperf_json(out.stdout)
        # iperf3 has no latency figure: return None so a ping-based
        # prober's latency for the pair is preserved, not zeroed.
        return None, result.bandwidth_bps


def _bracketed(host: str) -> str:
    """IPv6 literals need brackets in a URL netloc."""
    if ":" in host and not host.startswith("["):
        return f"[{host}]"
    return host


class AgentProber:
    """Honest pairwise probe via the per-node probe agent
    (:mod:`~.probe_agent`, deployed by deploy/probes.yaml).

    ``probe(a, b)`` asks node **a**'s agent to run iperf3 against node
    **b**'s iperf3 server and to measure TCP-connect latency — so the
    recorded ``lat[a, b]``/``bw[a, b]`` is the actual a↔b path, the
    client-side vantage the reference got from ``kubectl exec`` into
    per-node client pods (run.sh:12-14), without exec or file drops.

    ``token``, when set, is sent as the ``X-Netaware-Token`` header the
    agent's ``--token`` mode requires (the auth replacing kubectl
    exec's RBAC gate)."""

    def __init__(self, host_of: dict[str, str],
                 agent_port: int = 9798, iperf_port: int = 5201,
                 duration_s: int = 2, timeout_s: float | None = None,
                 token: str = "") -> None:
        self._host_of = host_of
        self._agent_port = agent_port
        self._iperf_port = iperf_port
        self._duration = duration_s
        self._timeout = timeout_s if timeout_s is not None \
            else duration_s + 15.0
        self._token = token

    def probe(self, a: str, b: str) -> tuple[float | None, float]:
        import json as _json
        import urllib.parse
        import urllib.request

        from kubernetesnetawarescheduler_tpu_torch.ingest.iperf import (
            iperf_result_from_doc,
        )

        host_a, host_b = self._host_of[a], self._host_of[b]
        query = urllib.parse.urlencode({
            "target": host_b, "duration": self._duration,
            "port": self._iperf_port})
        url = (f"http://{_bracketed(host_a)}:{self._agent_port}"
               f"/probe?{query}")
        req = urllib.request.Request(url)
        if self._token:
            req.add_header("X-Netaware-Token", self._token)
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            doc = _json.load(resp)
        if "error" in doc:
            raise RuntimeError(f"agent {a} probing {b}: {doc['error']}")
        bw = iperf_result_from_doc(doc["iperf"]).bandwidth_bps
        lat = doc.get("latency_ms")
        return (float(lat) if lat is not None else None), bw


class ProbeOrchestrator:
    """Budgeted pair probing into an Encoder.

    Pair selection is stalest-first by default; passing a ``planner``
    (e.g. :class:`~..netmodel.EIGProbePlanner`) replaces it with
    expected-information-gain selection (the stalest-first selector is
    still handed to the planner for its exploration share).  A
    ``model`` (:class:`~..netmodel.TopologyModel`) receives every
    successful observation and is re-fit at the end of each cycle.

    ``forget_s`` bounds the per-pair bookkeeping: entries whose last
    probe is older than the horizon are pruned on ``advance_clock``
    (they revert to "never probed" for selection purposes, which is
    exactly how a probe that stale should be treated).  <= 0 keeps
    entries forever (the pre-existing behaviour)."""

    def __init__(self, encoder: Encoder, prober: Prober,
                 names: Sequence[str], planner=None, model=None,
                 forget_s: float = 0.0,
                 quarantine_streak: int = 3) -> None:
        self._encoder = encoder
        self._prober = prober
        self._names = list(names)
        self._planner = planner
        self._model = model
        self._forget_s = float(forget_s)
        self._last_probe: dict[tuple[int, int], float] = {}
        self._clock = 0.0
        self.failures = 0
        self.successes = 0
        self.pruned_total = 0
        # Ingest quarantine: a probe that RETURNS (no exception) but
        # carries a value no sane link produces — NaN/Inf, negative
        # latency, non-positive bandwidth — must not reach staging;
        # update_link would either drop it silently or, worse, a NaN
        # would poison the lat/bw planes and every score using them.
        # Quarantined samples are counted per reason (/metrics:
        # netaware_ingest_quarantined_total{reason=...}), the pair
        # stays stale (same degradation as a probe failure), and a
        # per-link CONSECUTIVE-quarantine streak past the threshold
        # queues a LinkQuarantined event (drain_quarantine_events) so
        # operators see the sick path, not just a counter.
        self.quarantined = {"non_finite": 0, "negative_latency": 0,
                            "non_positive_bandwidth": 0}
        self._quarantine_streak = max(int(quarantine_streak), 1)
        self._streaks: dict[tuple[int, int], int] = {}
        self._quarantine_events: list[dict] = []

    def advance_clock(self, dt_s: float) -> None:
        self._clock += dt_s
        if self._model is not None:
            self._model.advance_clock(dt_s)
        if self._forget_s > 0:
            horizon = self._clock - self._forget_s
            stale = [p for p, t in self._last_probe.items() if t < horizon]
            for p in stale:
                del self._last_probe[p]
            self.pruned_total += len(stale)

    def _stalest_pairs(self, budget: int) -> list[tuple[int, int]]:
        """The ``budget`` pairs ``(i < j)`` probed longest ago, never-probed
        first, ties in ``(i, j)`` order: what ``heapq.nsmallest`` over
        the row-major pair walk keyed by the last probe time (-inf when
        never probed) returns, as the JAX package computes it.

        While ``budget`` never-probed pairs remain, those are the first
        ``budget`` of them in walk order, found by a walk that skips the
        probed pairs: O(probed + budget) instead of a pass over the N²/2
        pairs (12.5M at 5k nodes).  Otherwise the full selection runs."""
        n = len(self._names)
        if budget <= 0:
            return []
        probed = self._last_probe
        if n * (n - 1) // 2 - len(probed) >= budget:
            out: list[tuple[int, int]] = []
            for i in range(n):
                for j in range(i + 1, n):
                    if (i, j) not in probed:
                        out.append((i, j))
                        if len(out) == budget:
                            return out
        pairs = ((i, j) for i in range(n) for j in range(i + 1, n))
        return heapq.nsmallest(
            budget, pairs, key=lambda p: probed.get(p, -np.inf))

    def _select_pairs(self, budget: int) -> list[tuple[int, int]]:
        if self._planner is not None:
            return self._planner.select_pairs(
                len(self._names), budget, self._stalest_pairs)
        return self._stalest_pairs(budget)

    def run_cycle(self, budget: int = 64, fit: bool = True) -> int:
        """Probe the selected ``budget`` pairs; returns successes.
        Failures are counted and skipped — the pair just stays stale
        (no crash, unlike the reference's nil-body read,
        scheduler.go:397-405)."""
        done = 0
        for i, j in self._select_pairs(budget):
            a, b = self._names[i], self._names[j]
            try:
                lat_ms, bw_bps = self._prober.probe(a, b)
            except Exception as exc:
                self.failures += 1
                if self.failures == 1:
                    # First failure EVER gets a log line with the
                    # actual error — a misconfigured fleet (no agents,
                    # wrong port) otherwise looks like quietly-stale
                    # matrices; later failures only count (a pair
                    # staying stale is the designed degradation).
                    import sys

                    print(f"WARNING: first probe failure {a}->{b}: "
                          f"{exc!r} (further failures counted "
                          "silently)", file=sys.stderr)
                continue
            reason = self._validate(lat_ms, bw_bps)
            if reason is not None:
                self._quarantine(i, j, a, b, reason, lat_ms, bw_bps)
                continue
            self._streaks.pop((i, j), None)
            self._encoder.update_link(a, b, lat_ms=lat_ms, bw_bps=bw_bps)
            if self._model is not None:
                ia = self._encoder.node_slot(a)
                ib = self._encoder.node_slot(b)
                if ia is not None and ib is not None:
                    self._model.observe(ia, ib, lat_ms, bw_bps, self._clock)
            self._last_probe[(i, j)] = self._clock
            self.successes += 1
            done += 1
        if done and fit and self._model is not None:
            if self._model.fit():
                # Fresh model params change the blended snapshot even
                # with no new direct probe on a given pair.
                self._encoder.touch_net()
        return done

    @staticmethod
    def _validate(lat_ms: float | None,
                  bw_bps: float | None) -> str | None:
        """Range-check one probe result; returns the quarantine reason
        or ``None`` when the sample is admissible.  A ``None`` quantity
        is the Prober protocol's "no figure from this prober" (e.g.
        iperf3 has no latency) — not a bad sample, so only the
        quantities actually measured are validated."""
        if lat_ms is not None:
            if not np.isfinite(lat_ms):
                return "non_finite"
            if lat_ms < 0:
                return "negative_latency"
        if bw_bps is not None:
            if not np.isfinite(bw_bps):
                return "non_finite"
            if bw_bps <= 0:
                return "non_positive_bandwidth"
        return None

    def _quarantine(self, i: int, j: int, a: str, b: str,
                    reason: str, lat_ms: float, bw_bps: float) -> None:
        self.quarantined[reason] += 1
        streak = self._streaks.get((i, j), 0) + 1
        self._streaks[(i, j)] = streak
        if streak == self._quarantine_streak:
            # Exactly-at-threshold, not >=: one event per sick episode,
            # re-armed when a good sample clears the streak.
            self._quarantine_events.append({
                "link": (a, b), "reason": reason, "streak": streak,
                "lat_ms": None if lat_ms is None else float(lat_ms),
                "bw_bps": None if bw_bps is None else float(bw_bps)})

    def drain_quarantine_events(self) -> list[dict]:
        """Pop the pending over-threshold quarantine streaks — serve.py
        turns each into a ``LinkQuarantined`` k8s Event."""
        out, self._quarantine_events = self._quarantine_events, []
        return out

    def staleness(self) -> dict[str, float]:
        """Aggregate staleness stats — O(tracked pairs) time, O(1)
        output (the old O(N^2) per-pair dict is
        :meth:`staleness_pairs`)."""
        n = len(self._names)
        total = n * (n - 1) // 2
        ages = [self._clock - t for t in self._last_probe.values()]
        return {
            "tracked_pairs": float(len(ages)),
            "total_pairs": float(total),
            "coverage_fraction": (len(ages) / total) if total else 0.0,
            "mean_age_s": float(np.mean(ages)) if ages else float("nan"),
            "max_age_s": float(np.max(ages)) if ages else float("nan"),
        }

    def staleness_pairs(self) -> dict[tuple[str, str], float]:
        """Per-pair ages keyed by name pair.  O(N^2) worst case — debug
        / small-cluster use only; prefer :meth:`staleness`."""
        return {
            (self._names[i], self._names[j]): self._clock - t
            for (i, j), t in self._last_probe.items()}
