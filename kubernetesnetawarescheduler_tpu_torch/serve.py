"""The scorer daemon: ``python -m kubernetesnetawarescheduler_tpu_torch``.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/serve.py``,
the process the deploy manifests run.  It wires:

- the Encoder + SchedulerLoop (batch score/assign on the card),
- the UDS scorer server the native extender shim fronts,
- optionally the gRPC transport for remote clients,
- the scrape pool (node_exporter ingestion) and probe orchestrator
  (pairwise lat/bw) on background threads,
- checkpoint restore on start / save on SIGTERM,
- a decision log for deterministic replay.

``--cluster fake:N`` serves against a generated N-node fake cluster;
``kube:<url>`` / ``incluster`` watch a real API server.

What differs from the JAX daemon:

- ``--device`` (default ``cuda``) picks the device; without a card the
  default raises, it never falls back to the CPU.  It takes the place of
  ``JAX_PLATFORMS``.
- ``--compilation-cache-dir`` points the CUDA kernel build directory
  (``core.kernels.BUILD_DIR``) at the given path: what a restart rebuilds
  is the nvcc library, so a persistent volume there skips the build.
- ``--jax-profile-dir`` (its name kept so deploy command lines carry
  over) wraps the run in ``torch.profiler`` and writes a Chrome trace
  there; every device step carries the flight recorder's cycle id.
- Flags and config fields of layers not ported yet (placement quality,
  SLOs, the learned policy, the topology model, rebalancing, the
  integrity auditor, state chaos, the mesh and multi-host serving) make
  the daemon exit with code 2 and one line naming the layer's ROADMAP
  item, before anything starts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading
import time

from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig,
    load_config,
)

# CLI flags of layers this package does not have yet, with the ROADMAP
# item each needs.  Config fields go through the loop's own refusal
# (core.loop._refuse_unported).
_UNPORTED_FLAGS = (
    ("quality_obs", "--quality-obs", "obs/quality.py", 12),
    ("slo", "--slo", "obs/slo.py", 12),
    ("learned_score", "--learned-score", "policy/", 12),
    ("policy_eval_trace", "--policy-eval-trace", "policy/", 12),
    ("rebalance", "--rebalance", "core/rebalance.py", 11),
    ("audit_interval", "--audit-interval", "core/integrity.py's auditor",
     11),
    ("state_chaos", "--state-chaos", "core/state_chaos.py", 11),
    ("mesh", "--mesh", "parallel/sharding.py", 15),
    ("multihost", "--multihost", "parallel/multihost.py", 15),
    ("coordinator", "--coordinator", "parallel/multihost.py", 15),
    ("num_processes", "--num-processes", "parallel/multihost.py", 15),
    ("process_id", "--process-id", "parallel/multihost.py", 15),
)


def _unported(ap: argparse.ArgumentParser, args,
              cfg: SchedulerConfig) -> str | None:
    """The refusal line for the first unported layer switched on by a
    flag (any value but its default; ``--audit-interval`` and
    ``--state-chaos`` above 0) or a config field, or None."""
    from kubernetesnetawarescheduler_tpu_torch.core.loop import (
        _refuse_unported,
    )

    for attr, flag, needs, item in _UNPORTED_FLAGS:
        val = getattr(args, attr)
        if (val > 0 if attr in ("audit_interval", "state_chaos")
                else val != ap.get_default(attr)):
            return (f"{flag} needs {needs} (ROADMAP Queue A item {item}), "
                    "which is not ported yet")
    if cfg.audit_interval_s > 0:
        return ("cfg.audit_interval_s > 0 needs core/integrity.py's "
                "auditor (ROADMAP Queue A item 11), which is not ported "
                "yet")
    try:
        _refuse_unported(cfg, None)
    except NotImplementedError as exc:
        return str(exc)
    return None


def _agent_reachable(host: str, port: int, timeout_s: float = 3.0) -> bool:
    """One /healthz round-trip to a probe agent."""
    import urllib.request

    from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (
        _bracketed,
    )

    try:
        with urllib.request.urlopen(
                f"http://{_bracketed(host)}:{port}/healthz",
                timeout=timeout_s) as resp:
            return bool(json.load(resp).get("ok"))
    except (OSError, ValueError):
        return False


def build_fake(num_nodes: int, seed: int, cfg: SchedulerConfig,
               async_bind: bool = False, burst_batches: int = 8,
               pipelined: bool = False, device="cuda"):
    import numpy as np

    from kubernetesnetawarescheduler_tpu_torch.bench.fakecluster import (
        ClusterSpec,
        build_fake_cluster,
        feed_metrics,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop

    cluster, lat, bw = build_fake_cluster(
        ClusterSpec(num_nodes=num_nodes, seed=seed))
    loop = SchedulerLoop(cluster, cfg, async_bind=async_bind,
                         burst_batches=burst_batches, pipelined=pipelined,
                         device=device)
    loop.encoder.set_network(lat, bw)
    feed_metrics(cluster, loop.encoder, np.random.default_rng(seed + 1))
    return loop, lat, bw


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kubernetesnetawarescheduler_tpu_torch",
        description=__doc__.splitlines()[0])
    ap.add_argument("--config", help="SchedulerConfig JSON/YAML path")
    ap.add_argument("--device", default="cuda",
                    help='device the encoder and the kernels run on '
                         '("cuda" by default; "cpu" runs the kernels\' '
                         "plain versions)")
    ap.add_argument("--cluster", default="fake:128",
                    help='"fake:<N>" (generated cluster), "incluster" '
                         '(ServiceAccount) or "kube:<url>" (explicit API '
                         "server); the extender webhook path works "
                         "regardless")
    ap.add_argument("--kube-token", default="",
                    help="bearer token for kube:<url> (testing)")
    ap.add_argument("--kube-insecure", action="store_true",
                    help="skip TLS verification for kube:<url>")
    ap.add_argument("--uds", default="/run/netaware/scorer.sock",
                    help="unix socket the native shim connects to")
    ap.add_argument("--grpc", default="",
                    help='gRPC bind address (e.g. "0.0.0.0:50051"); '
                         "empty disables")
    ap.add_argument("--scrape-targets", default="",
                    help="JSON file {node name: metrics URL} for the "
                         "node_exporter scrape pool")
    ap.add_argument("--scrape-period-s", type=float, default=15.0)
    ap.add_argument("--probe-period-s", type=float, default=60.0,
                    help="pairwise lat/bw probe cadence")
    ap.add_argument("--probe-targets", default="",
                    help="JSON file {node name: iperf3 host} enabling "
                         "real pairwise probing on kube/incluster "
                         "clusters")
    ap.add_argument("--probe-agent-port", type=int, default=9798,
                    help="per-node probe-agent port (deploy/probes.yaml "
                         "DaemonSet); 0 = probe from this process")
    ap.add_argument("--checkpoint-dir", default="",
                    help="restore on start, save on SIGTERM")
    ap.add_argument("--compilation-cache-dir",
                    default=os.environ.get(
                        "NETAWARE_COMPILATION_CACHE", ""),
                    help="directory the CUDA kernel library is built "
                         "into and loaded from: a restarted daemon whose "
                         "volume persists skips the nvcc build; empty "
                         "keeps the package's own _build/")
    ap.add_argument("--decision-log", default="",
                    help="JSONL decision log path")
    ap.add_argument("--jax-profile-dir", default="",
                    help="opt-in profiler trace directory: the serving "
                         "run is wrapped in torch.profiler and a Chrome "
                         "trace is written there; every device step "
                         "carries the flight recorder's cycle id; empty "
                         "disables")
    ap.add_argument("--crash-dump", default="",
                    help="path for the flight-recorder post-mortem dump "
                         "written on SIGTERM/fault; defaults to "
                         "<checkpoint-dir>/flight_dump.json when "
                         "--checkpoint-dir is set, else disabled")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--once", action="store_true",
                    help="serve one readiness cycle then exit "
                         "(smoke-test mode)")
    ap.add_argument("--burst-batches", type=int, default=8,
                    help="with a deep backlog, drain up to this many "
                         "batches per device dispatch; 1 disables burst "
                         "mode")
    ap.add_argument("--async-bind", action="store_true",
                    help="assume-then-bind cycle: commit placements to "
                         "the local ledger immediately and confirm "
                         "binds on a worker thread; rejected binds roll "
                         "back")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined burst cycle: encode of burst k+1 "
                         "overlaps the retire of burst k and the binds "
                         "of burst k-1 (implies --async-bind)")
    ap.add_argument("--multicycle", type=int, default=None,
                    help="persistent multi-cycle serving: K scheduling "
                         "cycles per device dispatch, retired one "
                         "logical cycle at a time; 1 = per-cycle "
                         "dispatch (default)")
    ap.add_argument("--bind-coalesce-window", type=int, default=None,
                    help="coalesce up to this many queued async bind "
                         "batches into one API pass; 1 disables")
    ap.add_argument("--bind-max-inflight", type=int, default=None,
                    help="bound on concurrent async bind batches in "
                         "flight; 1 = serial binder (default)")
    ap.add_argument("--async-static", action="store_true",
                    help="rebuild the static score prep on a background "
                         "thread; equivalent to enable_async_static=true "
                         "in --config")
    # Layers not ported yet: accepted so deploy command lines parse, and
    # refused with their ROADMAP item (see _UNPORTED_FLAGS).
    for flag in ("--quality-obs", "--slo", "--rebalance",
                 "--learned-score", "--mesh", "--multihost"):
        ap.add_argument(flag, action="store_true",
                        help="not ported yet; refused")
    ap.add_argument("--policy-eval-trace", default="",
                    help="not ported yet; refused")
    ap.add_argument("--coordinator", default="",
                    help="not ported yet; refused")
    ap.add_argument("--audit-interval", type=float, default=0.0,
                    help="not ported yet; refused when > 0")
    ap.add_argument("--state-chaos", type=float, default=0.0,
                    help="not ported yet; refused when > 0")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="not ported yet; refused")
    ap.add_argument("--process-id", type=int, default=None,
                    help="not ported yet; refused")
    return ap


def main(argv=None, stop: threading.Event | None = None) -> int:
    """Run the daemon until SIGTERM/SIGINT (main thread), ``stop`` being
    set (embedded callers: tests, benches), or one cycle with
    ``--once``.  Returns the exit code."""
    ap = _parser()
    args = ap.parse_args(argv)

    cfg = load_config(args.config) if args.config else SchedulerConfig()
    over = {k: v for k, v in (
        ("multicycle", args.multicycle),
        ("bind_coalesce_window", args.bind_coalesce_window),
        ("bind_max_inflight", args.bind_max_inflight),
    ) if v is not None}
    if args.async_static:
        over["enable_async_static"] = True
    if over:
        cfg = dataclasses.replace(cfg, **over)
    refusal = _unported(ap, args, cfg)
    if refusal is not None:
        print(f"refusing to start: {refusal}", file=sys.stderr)
        return 2

    from kubernetesnetawarescheduler_tpu_torch.core import kernels
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        resolve_device,
    )

    device = resolve_device(args.device)
    if cfg.multicycle > 1:
        print(f"multi-cycle serving enabled: K={cfg.multicycle}, "
              f"device queue depth {cfg.multicycle_queue_depth}, "
              f"bind coalesce window {cfg.bind_coalesce_window}, "
              f"bind max inflight {cfg.bind_max_inflight}",
              file=sys.stderr)
    if args.compilation_cache_dir:
        # Must precede the first launch, which builds the library.
        from pathlib import Path

        os.makedirs(args.compilation_cache_dir, exist_ok=True)
        kernels.BUILD_DIR = Path(args.compilation_cache_dir)

    kind, _, param = args.cluster.partition(":")
    lat_truth = bw_truth = None
    if kind == "fake":
        loop, lat_truth, bw_truth = build_fake(
            int(param or "128"), args.seed, cfg,
            async_bind=args.async_bind, burst_batches=args.burst_batches,
            pipelined=args.pipeline, device=device)
    elif kind in ("incluster", "kube"):
        from kubernetesnetawarescheduler_tpu_torch.core.loop import (
            SchedulerLoop,
        )
        from kubernetesnetawarescheduler_tpu_torch.k8s.kubeclient import (
            KubeClient,
        )

        client = KubeClient(base_url=param or None,
                            token=args.kube_token or None,
                            insecure=args.kube_insecure)
        # The loop's Informer lists + subscribes nodes itself; resync()
        # recovers pods already pending at startup.
        loop = SchedulerLoop(client, cfg, async_bind=args.async_bind,
                             burst_batches=args.burst_batches,
                             pipelined=args.pipeline, device=device)
        loop.informer.resync()
    else:
        ap.error(f"unknown cluster kind {kind!r} "
                 "(fake:<N> | incluster | kube:<url>)")

    # Brownout-resilience knobs (circuit breaker + retry budget) from
    # config; configure_resilience replaces the breaker object, so
    # re-point the loop's reference at the live one.
    resil = getattr(loop.client, "configure_resilience", None)
    if callable(resil):
        resil(failure_threshold=cfg.breaker_failure_threshold,
              window_s=cfg.breaker_window_s,
              cooldown_s=cfg.breaker_cooldown_s,
              retry_budget=cfg.api_retry_budget,
              backoff_base_s=cfg.api_backoff_base_s,
              backoff_max_s=cfg.api_backoff_max_s)
        loop.breaker = loop.client.breaker

    if args.checkpoint_dir and os.path.exists(
            os.path.join(args.checkpoint_dir, "meta.json")):
        from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
            load_checkpoint,
        )
        try:
            restored = load_checkpoint(args.checkpoint_dir, cfg,
                                       device=device)
        except Exception as exc:  # noqa: BLE001 — an incompatible or
            # corrupt checkpoint must not take the daemon down: the
            # ledger is reconstructable from the API server.
            restored = None
            print(f"IGNORING checkpoint {args.checkpoint_dir}: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
        # The checkpoint must describe THIS cluster: a node table that
        # diverges from the live registrations would silently schedule
        # onto a phantom subset.
        if restored is None:
            loop.checkpoint_state = "ignored"
        elif restored._node_names == loop.encoder._node_names:
            loop.encoder = restored
            loop.checkpoint_state = "restored"
            print(f"restored checkpoint from {args.checkpoint_dir}",
                  file=sys.stderr)
        else:
            loop.checkpoint_state = "ignored"
            print(f"IGNORING checkpoint {args.checkpoint_dir}: node "
                  f"table mismatch ({len(restored._node_names)} stored "
                  f"vs {len(loop.encoder._node_names)} live nodes)",
                  file=sys.stderr)
    if loop.flight is not None:
        loop.flight.meta["checkpoint_state"] = loop.checkpoint_state

    if args.decision_log:
        from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
            DecisionLog,
        )
        loop.decision_log = DecisionLog(args.decision_log)

    from kubernetesnetawarescheduler_tpu_torch.api.extender import (
        ExtenderHandlers,
    )
    from kubernetesnetawarescheduler_tpu_torch.api.server import (
        ScorerServer,
    )

    os.makedirs(os.path.dirname(args.uds) or ".", exist_ok=True)
    handlers = ExtenderHandlers(
        loop, batch_window_s=cfg.extender_batch_window_s)
    uds = ScorerServer(handlers, args.uds)
    uds.start()
    print(f"scorer serving on uds://{args.uds}", file=sys.stderr)

    grpc_server = None
    if args.grpc:
        from kubernetesnetawarescheduler_tpu_torch.api.grpc_server import (
            serve_grpc,
        )
        grpc_server, port = serve_grpc(handlers, args.grpc)
        print(f"scorer serving on grpc://{args.grpc} (port {port})",
              file=sys.stderr)

    threads = []
    stop = stop if stop is not None else threading.Event()
    if args.scrape_targets:
        from kubernetesnetawarescheduler_tpu_torch.ingest.scraper import (
            ScrapePool,
        )
        with open(args.scrape_targets, encoding="utf-8") as fh:
            targets = json.load(fh)
        pool = ScrapePool(loop.encoder, targets)
        threads.append(threading.Thread(
            target=pool.run_forever, args=(args.scrape_period_s, stop),
            daemon=True, name="scrape-pool"))

    # Probe orchestrator: keeps the pairwise lat/bw matrices fresh.  The
    # fake cluster gets the FakeProber against ground truth; a real
    # fleet probes through the per-node agents or iperf3.
    prober = None
    if lat_truth is not None:
        from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (
            FakeProber,
        )

        names = list(loop.encoder._node_names)
        prober = FakeProber(names, lat_truth, bw_truth, seed=args.seed)
    elif args.probe_targets:
        from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (
            AgentProber,
            Iperf3Prober,
        )

        with open(args.probe_targets, encoding="utf-8") as fh:
            host_of = json.load(fh)
        names = [n for n in loop.encoder._node_names if n in host_of]
        if args.probe_agent_port:
            prober = AgentProber(
                host_of, agent_port=args.probe_agent_port,
                token=os.environ.get("NETAWARE_PROBE_TOKEN", ""))
            if names and not _agent_reachable(
                    host_of[names[0]], args.probe_agent_port):
                print(f"WARNING: probe agent on {names[0]} "
                      f"({host_of[names[0]]}:{args.probe_agent_port}) "
                      "unreachable — deploy deploy/probes.yaml's "
                      "DaemonSet, or pass --probe-agent-port 0 for "
                      "the scorer-side iperf3 vantage", file=sys.stderr)
        else:
            prober = Iperf3Prober(host_of)
    else:
        print("WARNING: no probe source (--probe-targets unset on a "
              "real cluster): lat/bw matrices stay empty and scoring "
              "degrades to metric-vote only", file=sys.stderr)

    if args.probe_period_s > 0 and prober is not None:
        from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (
            ProbeOrchestrator,
        )
        from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
            link_event,
        )

        orch = ProbeOrchestrator(
            loop.encoder, prober, names, forget_s=cfg.probe_forget_s,
            quarantine_streak=cfg.quarantine_streak_events)
        loop.probe_orchestrator = orch

        def probe_forever() -> None:
            while not stop.is_set():
                orch.run_cycle(budget=64)
                for ev in orch.drain_quarantine_events():
                    a, b = ev["link"]
                    try:
                        loop.client.create_event(link_event(
                            src=a, dst=b, reason="LinkQuarantined",
                            streak=int(ev["streak"]),
                            message=(
                                f"link {a}<->{b} probe samples "
                                f"quarantined {ev['streak']}x in a row "
                                f"({ev['reason']}: lat={ev['lat_ms']} "
                                f"ms, bw={ev['bw_bps']} bps)"),
                            component=cfg.scheduler_name))
                    except Exception:  # noqa: BLE001 — best-effort;
                        # the refusals are already counted in /metrics
                        pass
                orch.advance_clock(args.probe_period_s)
                stop.wait(args.probe_period_s)

        threads.append(threading.Thread(target=probe_forever, daemon=True,
                                        name="probe-orchestrator"))

    def shutdown(signum, frame):
        stop.set()

    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        # Handlers are installable only from the main thread; embedded
        # callers stop the daemon through ``stop``.  The caller's own
        # handlers come back when main returns.
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, shutdown)

    for t in threads:
        t.start()

    # Main serving loop: drain any informer-fed queue work; extender-
    # path requests are served by the UDS/gRPC threads directly.  Every
    # ~60s: resync pending pods and reconcile the usage ledger.
    last_maint = time.monotonic()
    profiler = None
    if args.jax_profile_dir:
        import torch

        os.makedirs(args.jax_profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        loop.profile_steps = True
        print(f"torch profiler tracing to {args.jax_profile_dir}",
              file=sys.stderr)
    crash_dump_path = args.crash_dump or (
        os.path.join(args.checkpoint_dir, "flight_dump.json")
        if args.checkpoint_dir else "")
    dump_reason = "exit"
    try:
        loop.maintain()
        while not stop.is_set():
            loop.run_once(timeout=0.25)
            if time.monotonic() - last_maint >= 60.0:
                loop.maintain()
                last_maint = time.monotonic()
            if args.once:
                break
        if stop.is_set():
            dump_reason = "sigterm"
    except BaseException:
        dump_reason = "fault"
        raise
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        if profiler is not None:
            loop.profile_steps = False
            try:
                profiler.__exit__(None, None, None)
                profiler.export_chrome_trace(
                    os.path.join(args.jax_profile_dir, "trace.json"))
            except Exception as exc:  # noqa: BLE001 — best-effort
                print(f"WARNING: profiler stop failed: {exc}",
                      file=sys.stderr)
        # Post-mortem first: the recorder's last spans survive even if
        # the checkpoint path below fails.
        if crash_dump_path and loop.flight is not None:
            try:
                loop.flight.crash_dump(crash_dump_path,
                                       reason=dump_reason)
                print(f"flight recorder dumped to {crash_dump_path} "
                      f"({dump_reason})", file=sys.stderr)
            except Exception as exc:  # noqa: BLE001 — best-effort
                print(f"WARNING: flight dump failed: {exc}",
                      file=sys.stderr)
        ledger_settled = True
        try:
            # Settle the ledger before it is checkpointed: queued bind
            # batches may still roll back on rejection.
            loop.stop_bind_worker()
        except Exception as exc:  # noqa: BLE001 — an unsettled ledger
            # costs the checkpoint, not the shutdown
            ledger_settled = False
            print(f"WARNING: bind worker drain failed: {exc}",
                  file=sys.stderr)
        if args.checkpoint_dir and not ledger_settled:
            # A ledger with assumed-but-unconfirmed binds must not be
            # persisted: no checkpoint beats a wrong one.
            print(f"SKIPPING checkpoint save to {args.checkpoint_dir}: "
                  "bind queue did not drain", file=sys.stderr)
        elif args.checkpoint_dir:
            from kubernetesnetawarescheduler_tpu_torch.core.checkpoint \
                import save_checkpoint

            extra = ({"multicycle": loop.multicycle_meta()}
                     if loop.multicycle > 1 else None)
            save_checkpoint(args.checkpoint_dir, loop.encoder,
                            extra_meta=extra)
            print(f"checkpoint saved to {args.checkpoint_dir}",
                  file=sys.stderr)
        if loop.decision_log is not None:
            loop.decision_log.close()
        uds.stop()
        if grpc_server is not None:
            grpc_server.stop(grace=1.0)
        close = getattr(loop.client, "close", None)
        if callable(close):
            close()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
