"""The scorer daemon: ``python -m kubernetesnetawarescheduler_tpu_torch``.

The PyTorch counterpart of ``kubernetesnetawarescheduler_tpu/serve.py``,
the process the deploy manifests run.  It wires:

- the Encoder + SchedulerLoop (batch score/assign on the card),
- the UDS scorer server the native extender shim fronts,
- optionally the gRPC transport for remote clients,
- the scrape pool (node_exporter ingestion) and probe orchestrator
  (pairwise lat/bw) on background threads,
- checkpoint restore on start / save on SIGTERM,
- a decision log for deterministic replay,
- optionally the anti-entropy integrity auditor (``--audit-interval``),
  the state-fault injector (``--state-chaos``, test and soak only) and
  the continuous rebalancer (``--rebalance``).

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
- ``--mesh`` alone serves on a 1×1 mesh on the daemon's card: torch
  drives one device per process, so the daemon builds a one-rank process
  group itself.  Larger meshes come through ``--multihost``, one process
  per rank (``--coordinator host:port --num-processes R --process-id
  r``, or torchrun's environment): rank 0 runs the control plane and
  every other rank follows (``parallel/serve_multihost.py``).  The
  collectives run on NCCL when this host has a card for each of its
  ranks, else on gloo (``parallel/multihost.default_backend``).
- ``--policy-eval-trace`` hands the promotion gate its trace; the
  gate's replays run on the daemon's device.
- The audit thread and the state-chaos thread end on a fault of the
  device instead of retrying it; shutdown raises that fault after every
  thread is stopped and the daemon's state is saved.
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
               pipelined: bool = False, device="cuda", mesh=None):
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
                         device=device, mesh=mesh)
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
    ap.add_argument("--audit-interval", type=float, default=None,
                    help="anti-entropy audit period in seconds "
                         "(core/integrity.py): a background thread "
                         "digests the device planes against a shadow "
                         "re-encode of the staging truth and walks "
                         "the repair ladder on drift; overrides "
                         "cfg.audit_interval_s; 0 disables")
    ap.add_argument("--state-chaos", type=float, default=0.0,
                    help="state-fault injection period in seconds "
                         "(core/state_chaos.py): every period one "
                         "seeded fault (dropped/duplicated/reordered "
                         "delta, NaN poison, bit flip) is injected "
                         "into the state layer — pair with "
                         "--audit-interval to exercise the repair "
                         "ladder; 0 disables (NEVER enable in "
                         "production)")
    ap.add_argument("--rebalance", action="store_true",
                    help="continuous rebalancing (core/rebalance.py): "
                         "a budgeted descheduler revisits bound pods "
                         "at maintain cadence, live-migrating the "
                         "worst placements through the crash-safe "
                         "migration ledger under the eviction budget "
                         "and PDB-style disruption limits; "
                         "equivalent to enable_rebalance=true in "
                         "--config")
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
    ap.add_argument("--quality-obs", action="store_true",
                    help="outcome observability (obs/quality.py): "
                         "join each bound pod's score-time network "
                         "prediction against later probe truth — "
                         "realized bw/lat, regret vs best "
                         "alternative, calibration residuals — in a "
                         "bounded outcome ring (/debug/slo, "
                         "/metrics); equivalent to "
                         "enable_quality_obs=true in --config")
    ap.add_argument("--slo", action="store_true",
                    help="SLO burn-rate engine (obs/slo.py): "
                         "evaluate the declarative objectives "
                         "(score p99, bind tail, quality regret, "
                         "unrepaired drift) over multi-window burn "
                         "rates, emit SLOBurn Events and degrade "
                         "/readyz while burning; equivalent to "
                         "enable_slo=true in --config")
    ap.add_argument("--learned-score", action="store_true",
                    help="learned scoring policy (policy/): fit "
                         "term-level score multipliers on the "
                         "explain/outcome join and shadow-score "
                         "recorded decisions; equivalent to "
                         "enable_learned_score=true in --config. "
                         "Needs explain capture (cfg.enable_explain) "
                         "and the quality observer for training "
                         "signal")
    ap.add_argument("--policy-eval-trace", default="",
                    help="scenario trace (scenario/generate.py format) "
                         "the policy promotion gate replays "
                         "counterfactually; without one the gate "
                         "refuses every promotion and the policy "
                         "stays shadow-only")
    ap.add_argument("--mesh", action="store_true",
                    help="serve the watch loop's score + assign, the "
                         "webhook's score and the backlog burst on a "
                         "(dp, tp) mesh; alone, a 1x1 mesh on this "
                         "process's card (torch drives one device per "
                         "process: larger meshes take --multihost)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group before device use, one "
                         "process per rank; implies --mesh.  Serving is "
                         "single-CONTROLLER: rank 0 runs the control "
                         "plane and broadcasts each cycle to the other "
                         "ranks, which join the sharded assign as "
                         "followers (parallel/serve_multihost.py).  "
                         "Bootstrap failures are fatal")
    ap.add_argument("--coordinator", default="",
                    help="host:port of rank 0's TCP store for "
                         "--multihost (empty = torchrun's environment); "
                         "needs --num-processes and --process-id")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total rank count for --multihost")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank for --multihost")
    return ap


def _join_mesh(args, device):
    """``(mesh, owned)``: the process group joined (``--multihost``) or
    made as one rank (``--mesh`` alone, unless a group exists), and the
    global mesh over it; ``owned`` says this call created the group."""
    import torch.distributed as dist

    from kubernetesnetawarescheduler_tpu_torch.parallel.multihost import (
        default_backend,
        global_mesh,
        init_multihost,
    )

    backend = default_backend(device)
    owned = not dist.is_initialized()
    if args.multihost:
        init_multihost(coordinator_address=args.coordinator or None,
                       num_processes=args.num_processes,
                       process_id=args.process_id, backend=backend)
    elif owned:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        return global_mesh(device=device), owned
    except BaseException:
        if owned:
            dist.destroy_process_group()
        raise


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
    if args.rebalance:
        over["enable_rebalance"] = True
    if args.quality_obs:
        over["enable_quality_obs"] = True
    if args.slo:
        over["enable_slo"] = True
    if args.learned_score:
        over["enable_learned_score"] = True
    if over:
        cfg = dataclasses.replace(cfg, **over)
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        resolve_device,
    )

    device = resolve_device(args.device)
    mesh = None
    owned_group = False
    if args.mesh or args.multihost:
        import torch.distributed as dist

        mesh, owned_group = _join_mesh(args, args.device)
        if mesh.rank != 0:
            # Serving stays single-controller: one informer, queue,
            # encoder and binder, on rank 0.  Every other rank joins the
            # sharded assign of each cycle as a follower.
            from kubernetesnetawarescheduler_tpu_torch.parallel import (
                serve_multihost,
            )

            print(f"multihost follower {mesh.rank}/{mesh.size} joining "
                  "the mesh", file=sys.stderr)
            try:
                steps = serve_multihost.run_follower(cfg, mesh)
            finally:
                if owned_group:
                    dist.destroy_process_group()
            print(f"multihost follower exiting after {steps} steps",
                  file=sys.stderr)
            return 0
        try:
            return _serve(ap, args, cfg, device, mesh, stop)
        finally:
            if owned_group:
                dist.destroy_process_group()
    return _serve(ap, args, cfg, device, mesh, stop)


def _serve(ap, args, cfg: SchedulerConfig, device, mesh,
           stop: threading.Event | None) -> int:
    """The daemon proper (rank 0 of a mesh, or the only process)."""
    from kubernetesnetawarescheduler_tpu_torch.core import kernels

    if cfg.multicycle > 1:
        print(f"multi-cycle serving enabled: K={cfg.multicycle}, "
              f"device queue depth {cfg.multicycle_queue_depth}, "
              f"bind coalesce window {cfg.bind_coalesce_window}, "
              f"bind max inflight {cfg.bind_max_inflight}",
              file=sys.stderr)
    if cfg.enable_learned_score:
        print(f"learned scoring policy enabled (shadow-first): ring "
              f"{cfg.policy_ring}, train every "
              f"{cfg.policy_train_interval_s}s, gate margin "
              f"{cfg.policy_promote_margin}", file=sys.stderr)
    # Legal-but-weaker configurations — learned scoring without an eval
    # trace stays shadow-only — are named with the flag that fixes them.
    for warn in cfg.startup_warnings(
            policy_eval_trace=args.policy_eval_trace or None):
        print(f"WARN: {warn}", file=sys.stderr)
    if cfg.enable_quality_obs:
        print(f"quality observer enabled: outcome ring "
              f"{cfg.quality_ring_size}, harvest every "
              f"{cfg.quality_harvest_interval_s}s", file=sys.stderr)
    if cfg.enable_slo:
        print(f"slo engine enabled: score p99 {cfg.slo_score_p99_ms}ms, "
              f"burn windows {cfg.slo_fast_window_s}s/"
              f"{cfg.slo_slow_window_s}s", file=sys.stderr)
    if cfg.enable_rebalance:
        print(f"rebalancer enabled: min gain "
              f"{cfg.rebalance_min_gain}, budget "
              f"{cfg.rebalance_evictions_per_hour} evictions/h, "
              f"{cfg.rebalance_max_moves_per_cycle} moves/cycle",
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
            pipelined=args.pipeline, device=device, mesh=mesh)
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
                             pipelined=args.pipeline, device=device,
                             mesh=mesh)
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
            if loop.rebalance is not None:
                # Built with the loop on the encoder just replaced.
                loop.rebalance.encoder = restored
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

    # Learned scoring policy: resume parameters/optimizer/example ring
    # from policy.npz when the restored checkpoint carries one.
    if (cfg.enable_learned_score and args.checkpoint_dir
            and loop.checkpoint_state == "restored"):
        from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
            load_policy,
        )

        from kubernetesnetawarescheduler_tpu_torch.core.state import (
            is_device_error,
        )

        try:
            restored_policy = load_policy(args.checkpoint_dir, cfg,
                                          seed=args.seed, device=device)
        except Exception as exc:  # noqa: BLE001 — the policy is optional
            if is_device_error(exc):
                raise
            restored_policy = None
            print(f"WARNING: policy checkpoint load failed: {exc}",
                  file=sys.stderr)
        if restored_policy is not None:
            loop.policy = restored_policy
            print("restored learned-score policy "
                  f"(version {restored_policy.version}, promoted "
                  f"{restored_policy.promoted_version})",
                  file=sys.stderr)
    if args.policy_eval_trace:
        loop.policy_eval_trace = args.policy_eval_trace

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

    # Learned topology model: dense confidence-weighted lat/bw
    # estimates fit on the probe stream (netmodel/), on the encoder's
    # device.  A checkpoint restore may already have attached one
    # (netmodel.npz); otherwise start fresh.  The EIG planner replaces
    # stalest-first pair selection with uncertainty x
    # placement-relevance selection.
    netmodel = None
    planner = None
    if cfg.enable_netmodel:
        from kubernetesnetawarescheduler_tpu_torch.netmodel import (
            EIGProbePlanner,
            TopologyModel,
        )

        netmodel = loop.encoder.netmodel
        if netmodel is None:
            netmodel = TopologyModel(cfg, seed=args.seed,
                                     device=loop.encoder.device)
            loop.encoder.attach_netmodel(netmodel)
        planner = EIGProbePlanner(
            netmodel, explore_frac=cfg.netmodel_explore_frac,
            seed=args.seed)
        loop.probe_planner = planner
        print("netmodel enabled: blending learned topology estimates "
              "into lat/bw", file=sys.stderr)

    if args.probe_period_s > 0 and prober is not None:
        from kubernetesnetawarescheduler_tpu_torch.ingest.probe import (
            ProbeOrchestrator,
        )
        from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
            link_event,
        )

        orch = ProbeOrchestrator(
            loop.encoder, prober, names, planner=planner,
            model=netmodel, forget_s=cfg.probe_forget_s,
            quarantine_streak=cfg.quarantine_streak_events)
        loop.probe_orchestrator = orch

        def probe_forever() -> None:
            while not stop.is_set():
                orch.run_cycle(budget=64)
                for ev in orch.drain_quarantine_events():
                    a, b = ev["link"]
                    if loop.rebalance is not None:
                        loop.rebalance.note_link_event(
                            a, b, "quarantine", int(ev["streak"]))
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
                if netmodel is not None:
                    for i, j, pred, meas, _t in \
                            netmodel.drain_degradations():
                        try:
                            a = loop.encoder.node_name(i)
                            b = loop.encoder.node_name(j)
                            if loop.rebalance is not None:
                                loop.rebalance.note_link_event(
                                    a, b, "degraded", 1)
                            loop.client.create_event(link_event(
                                src=a, dst=b, reason="LinkDegraded",
                                streak=1,
                                message=(
                                    f"link {a}<->{b} measured "
                                    f"{meas / 1e9:.2f} Gbps vs expected "
                                    f"{pred / 1e9:.2f} Gbps"),
                                component=cfg.scheduler_name))
                        except Exception:  # noqa: BLE001 — best-effort;
                            # the degradation is already counted
                            pass
                orch.advance_clock(args.probe_period_s)
                stop.wait(args.probe_period_s)

        threads.append(threading.Thread(target=probe_forever, daemon=True,
                                        name="probe-orchestrator"))

    # State integrity & self-healing: the anti-entropy auditor re-derives
    # truth from the staging arrays on its own thread and walks the
    # repair ladder on digest drift; the chaos injector (opt-in, test and
    # soak only) feeds it faults.
    audit_interval = (args.audit_interval
                      if args.audit_interval is not None
                      else cfg.audit_interval_s)
    auditor = None
    if audit_interval > 0:
        from kubernetesnetawarescheduler_tpu_torch.core.integrity import (
            IntegrityAuditor,
        )

        auditor = IntegrityAuditor(
            loop.encoder, loop,
            interval_s=audit_interval,
            checkpoint_dir=args.checkpoint_dir or None,
            watchdog_failures=cfg.audit_watchdog_failures,
            crash_dump_path=(
                os.path.join(args.checkpoint_dir,
                             "integrity_dump.json")
                if args.checkpoint_dir else "integrity_dump.json"))
        loop.integrity = auditor
        print(f"integrity auditor enabled: period {audit_interval}s",
              file=sys.stderr)
    # A fault of the device ends a background thread; shutdown raises it.
    thread_errors: list[BaseException] = []
    if args.state_chaos > 0:
        from kubernetesnetawarescheduler_tpu_torch.core.state import (
            is_device_error,
        )
        from kubernetesnetawarescheduler_tpu_torch.core.state_chaos import (
            StateChaosInjector,
        )

        injector = StateChaosInjector(
            loop.encoder, seed=args.seed, loop=loop,
            checkpoint_dir=args.checkpoint_dir or None)
        loop.state_chaos = injector

        def chaos_forever() -> None:
            while not stop.wait(args.state_chaos):
                try:
                    injector.inject_random()
                except Exception as exc:  # noqa: BLE001
                    if is_device_error(exc):
                        thread_errors.append(exc)
                        return
                    print(f"WARNING: state-chaos injection failed: "
                          f"{exc}", file=sys.stderr)

        threads.append(threading.Thread(target=chaos_forever,
                                        daemon=True,
                                        name="state-chaos"))
        print(f"STATE CHAOS enabled: one fault per "
              f"{args.state_chaos}s (seed {args.seed})",
              file=sys.stderr)

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
    if auditor is not None:
        auditor.start()

    # A multi-rank mesh: rank 0 is the one controller; its assign
    # broadcasts each cycle so the followers join every sharded step.
    multihost_ctl = None
    if mesh is not None and mesh.size > 1:
        from kubernetesnetawarescheduler_tpu_torch.parallel import (
            serve_multihost,
        )

        multihost_ctl = serve_multihost.install_controller(loop, cfg, mesh)
        print(f"multihost controller driving {mesh.size} processes",
              file=sys.stderr)

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
        if auditor is not None:
            # Before the checkpoint save below: a mid-audit repair
            # mutating staging while save_checkpoint copies it would
            # persist a half-repaired mirror.
            try:
                auditor.stop()
            except Exception as exc:  # noqa: BLE001 — raised below
                thread_errors.append(exc)
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
        handlers.close()
        close = getattr(loop.client, "close", None)
        if callable(close):
            close()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        if multihost_ctl is not None:
            # Release the followers blocked in their header broadcast.
            multihost_ctl.stop()
    if thread_errors:
        raise thread_errors[0]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
