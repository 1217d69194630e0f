"""The standalone path: the port's daemon as its own scheduler.

What ``deploy/standalone.yaml`` runs, built as ``serve.py`` builds it: a
:class:`~kubernetesnetawarescheduler_tpu_torch.core.loop.SchedulerLoop`
over an in-memory API server (the port's ``FakeCluster``, which here also
notes when it accepted each bind), the generated cluster's nodes, metric
samples and ``lat``/``bw`` planes, and the loop's own defaults for the
rest (burst mode, synchronous binds, one cycle per dispatch).

Two arrival kinds, named by the traffic mix:

- ``backlog``: every pod is queued at set-up; the window drives
  ``run_once`` back to back and closes at the end of the last cycle that
  began inside ``--seconds`` (or when the backlog runs dry).
- ``uniform``: pods come due at ``rate_per_s`` on a fixed schedule, from
  ``warm_s`` before the window opens, and the loop runs cycles back to
  back whenever its queue holds pods, as ``run_forever`` does; the window
  closes at ``--seconds``, and the pods due in it have ``grace_s`` more
  to be bound.  A pod's latency runs from its due time.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

from benchmark import generate
from benchmark.reference import scheduler as reference


def _api_server_class():
    from kubernetesnetawarescheduler_tpu_torch.k8s.client import FakeCluster

    class ApiServer(FakeCluster):
        """The port's in-memory API server, noting each accepted bind."""

        def __init__(self) -> None:
            super().__init__()
            self.accepted: list[tuple[float, list]] = []
            self._note = threading.Lock()

        def _noted(self, bindings, outcomes) -> None:
            t = time.perf_counter()
            ok = [(b.pod_name, b.node_name)
                  for b, e in zip(bindings, outcomes) if e is None]
            with self._note:
                self.accepted.append((t, ok))

        def bind_many(self, bindings):
            out = super().bind_many(bindings)
            self._noted(bindings, out)
            return out

        def bind(self, binding) -> None:
            super().bind(binding)
            self._noted([binding], [None])

    return ApiServer


def _pod(pods, i: int, sched: str, node: str = ""):
    from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod

    peers = {pods.names[j]: float(v)
             for j, v in zip(pods.peers[i], pods.volume[i]) if j >= 0}
    return Pod(name=pods.names[i], scheduler_name=sched, node_name=node,
               requests=dict(zip(generate.RESOURCES,
                                 map(float, pods.req[i]))),
               peers=peers, priority=float(pods.priority[i]),
               tolerations=(frozenset({"dedicated"}) if pods.tolerates[i]
                            else frozenset()))


def build(config: dict, traffic: dict, seed: int, seconds: float, device,
          recorder, mark=lambda stage: None):
    """The loop, its API server and the generated inputs, with the pods
    bound at set-up committed to the loop's ledger."""
    from kubernetesnetawarescheduler_tpu_torch.config import (
        config_from_dict,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.loop import SchedulerLoop
    from kubernetesnetawarescheduler_tpu_torch.k8s.types import Node

    cfg = config_from_dict(config["scheduler"])
    mark("imports")
    cluster = generate.make_cluster(config["cluster"], seed, device)
    mark("cluster")
    pods = generate.make_pods(traffic, cluster.n, seed,
                              generate.arrivals_of(traffic, seconds))
    mark("pods")
    api = _api_server_class()()
    for i, name in enumerate(cluster.names):
        z, r = int(cluster.zone[i]), int(cluster.rack[i])
        api.add_node(Node(
            name=name,
            capacity=dict(zip(generate.RESOURCES, map(float, cluster.cap[i]))),
            labels=frozenset({f"zone={z}", f"rack={r}"}),
            taints=(frozenset({"dedicated"}) if cluster.tainted[i]
                    else frozenset()),
            zone=f"zone-{z}", rack=f"rack-{z}-{r}"))
    recorder.nodes = cluster.n
    recorder.install()
    serve = config["serve"]
    loop = SchedulerLoop(api, cfg, burst_batches=serve["burst_batches"],
                         async_bind=serve["async_bind"],
                         pipelined=serve["pipelined"], device=device)
    loop.encoder.set_network(cluster.lat, cluster.bw)
    for i, name in enumerate(cluster.names):
        loop.encoder.update_metrics(
            name, dict(zip(generate.METRIC_NAMES,
                           map(float, cluster.metrics[i]))), age_s=0.0)
    b = pods.first_arrival
    if b:
        bound = [_pod(pods, i, cfg.scheduler_name,
                      cluster.names[pods.bound_node[i]]) for i in range(b)]
        api.add_pods(bound)
        loop.encoder.commit_many(bound, [loop.encoder.node_index(p.node_name)
                                         for p in bound])
    loop.maintain()
    mark("loop")
    return loop, api, cluster, pods, cfg


def _cycles(api, cluster, lo: float = -np.inf, hi: float = np.inf):
    """Accepted binds per call, as indices, for calls in ``[lo, hi]``."""
    out = []
    for t, ok in api.accepted:
        if lo <= t <= hi and ok:
            out.append(([int(p[1:]) for p, _ in ok],
                        [int(n[5:]) for _, n in ok]))
    return out


def _bind_times(api) -> dict[int, float]:
    return {int(p[1:]): t for t, ok in api.accepted for p, _ in ok}


def _host_probe() -> float:
    """Milliseconds of a fixed pure-Python loop, best of three: how fast
    the host runs the loop's kind of work at this moment."""
    best = np.inf
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i
        best = min(best, time.perf_counter() - t)
    return round(best * 1e3, 3)


def _slices(points, width: float, fold) -> list:
    """``fold`` of the values of ``(t, value)`` points per slice of
    ``width`` seconds."""
    out: dict[int, list] = {}
    for t, v in points:
        out.setdefault(int(t // width), []).append(v)
    return [round(float(fold(out[k])), 3) if k in out else None
            for k in range(max(out, default=-1) + 1)]


def run(ctx) -> dict:
    loop, api, cluster, pods, cfg = build(ctx.config, ctx.traffic, ctx.seed,
                                          ctx.seconds, ctx.device,
                                          ctx.recorder, ctx.mark)
    traffic, rec = ctx.traffic, ctx.recorder
    sched = cfg.scheduler_name
    first = pods.first_arrival
    arrivals = [_pod(pods, i, sched) for i in range(first, pods.s)]
    ctx.mark("pod_objects")
    backlog = traffic["arrivals"] == "backlog"
    out: dict = {}
    state = {"cycles": 0, "stretch_batches": 0, "trace_hi": np.inf,
             "trace_lo": np.inf}
    stretch = None
    gc_pauses: list[tuple[float, float]] = []
    cycle_log: list[tuple[float, int, int]] = []

    def step(timeout: float) -> int:
        nonlocal stretch
        if (ctx.trace and stretch is None
                and time.perf_counter() >= state["trace_lo"]):
            # The program's timers are read up to here: the profiler
            # slows every cycle it records.
            state["timers_at_trace"] = timers()
            state["cycles_at_trace"] = state["cycles"]
            # Noted before the profiler starts: starting it holds the
            # loop up for seconds.
            state["stretch_t"] = time.perf_counter()
            stretch = ctx.stretch()
            stretch.__enter__()
            rec.tracing = True
            state["b0"] = rec.batches
            state["trace_hi"] = time.perf_counter() + traffic["trace_s"]
        n = loop.run_once(timeout=timeout)
        if n and "t_open" in state:
            state["cycles"] += 1
            cycle_log.append((time.perf_counter() - state["t_open"],
                              rec.rounds, rec.batches))
        if rec.tracing and time.perf_counter() >= state["trace_hi"]:
            end_stretch()
        return n

    def end_stretch() -> None:
        # On the thread that started the profiler: it stops only there.
        if rec.tracing:
            ctx.sync()
            stretch.__exit__(None, None, None)
            rec.tracing = False
            state["stretch_batches"] = rec.batches - state["b0"]

    def on_gc(phase: str, info: dict) -> None:
        if info.get("generation") == 2:
            if phase == "start":
                state["gc_t"] = time.perf_counter()
            elif "gc_t" in state and "t_open" in state:
                t = state.pop("gc_t")
                gc_pauses.append((t - state["t_open"],
                                  time.perf_counter() - t))

    def timers() -> dict:
        return {k: (loop.timer.count(k), loop.timer.total(k))
                for k in ("encode", "score_assign", "bind")}

    def open_window() -> float:
        """Counters and program timers start from here."""
        state["timer0"] = timers()
        with rec.lock:
            rec.batches = rec.rounds = 0
        state["taken0"] = pods.s - first - len(loop.queue)
        state["probe"] = _host_probe()
        state["thread0"] = time.thread_time()
        t = time.perf_counter()
        state["t_open"] = t
        state["trace_lo"] = t + float(traffic["trace_at_s"])
        ctx.opened(t)
        return t

    # Set-up's share of the traffic: the shapes the window will use.
    warm = int(traffic.get("warm_pods", 0))
    for pod in arrivals[:warm]:
        api.add_pod(pod)
        loop.run_once(timeout=0.0)
    gc.callbacks.append(on_gc)
    if backlog:
        api.add_pods(arrivals[warm:])
        ctx.mark("queued")
        for _ in range(int(traffic["warm_cycles"])):
            loop.run_once(timeout=0.0)
        ctx.sync()
        t_open = open_window()
        t_close = t_open
        while time.perf_counter() < t_open + ctx.seconds and len(loop.queue):
            step(0.0)
            t_close = time.perf_counter()
        in_window = _cycles(api, cluster, t_open, t_close)
        bound = sum(len(c[0]) for c in in_window)
        out["diag"] = {"pods_per_5s": _slices(
            [(t - t_open, len(ok)) for t, ok in api.accepted
             if t_open <= t <= t_close], 5.0, sum)}
        taken = pods.s - first - len(loop.queue)
        out["pods_per_s"] = bound / (t_close - t_open)
        attempted = taken - state["taken0"]
        due = np.arange(first + state["taken0"], first + taken)
        taken_all = np.arange(first, first + taken)
    else:
        # Open loop, one thread: the pods come due on one schedule from
        # the start of the rate warm-up, and each is handed to the API
        # server (and through its watch to the loop's queue) at the
        # first moment the loop is not inside a cycle, as a watch event
        # that lands mid-cycle waits for the next pop.  The window opens
        # ``warm_s`` into the schedule.
        rate = float(traffic["rate_per_s"])
        warm_s = float(traffic.get("warm_s", 0.0))
        n_sched = len(arrivals) - warm
        k_open = int(np.ceil(warm_s * rate))
        late = []
        # Set-up leaves the collector at a point of its own; a full
        # collection here makes the first one the window can meet come
        # after the same amount of the window's work in every run.
        gc.collect()
        ctx.sync()
        t0 = time.perf_counter()
        k = 0
        due = np.arange(first + warm + k_open, pods.s)
        deadline = np.inf
        while True:
            now = time.perf_counter()
            while k < n_sched and t0 + k / rate <= now:
                if k == k_open:
                    open_window()
                if k >= k_open:
                    late.append(now - (t0 + k / rate))
                api.add_pod(arrivals[warm + k])
                k += 1
            if k >= n_sched:
                if deadline == np.inf:
                    deadline = (max(now, state["t_open"] + ctx.seconds)
                                + float(traffic["grace_s"]))
                if not len(loop.queue):
                    times = _bind_times(api)
                    if (all(int(i) in times for i in due)
                            or now >= deadline):
                        break
            if len(loop.queue):
                step(0.0)
            elif k < n_sched:
                time.sleep(max(0.0, min(t0 + k / rate - now, 0.25)))
            else:
                time.sleep(0.005)
        end_stretch()
        t_open = state["t_open"]
        times = _bind_times(api)

        def due_of(i: int) -> float:
            return t0 + (i - first - warm) / rate

        lat = np.asarray([times[int(i)] - due_of(int(i))
                          for i in due if int(i) in times])
        out["latency_s"] = lat
        due_at = [due_of(int(i)) - t_open for i in due if int(i) in times]
        # When each latency's pod came due, and when the profiled stretch
        # opened, both from the window's opening.
        out["latency_due_s"] = np.asarray(due_at)
        if "stretch_t" in state:
            out["stretch_at_s"] = state["stretch_t"] - t_open
        out["diag"] = {
            "p99_ms_per_5s": _slices(list(zip(due_at, lat * 1e3)), 5.0,
                                     lambda v: float(np.percentile(v, 99))),
            "max_ms_per_5s": _slices(list(zip(due_at, lat * 1e3)), 5.0,
                                     max),
            "late_ms_p99_max": [float(np.percentile(late, 99)) * 1e3,
                                float(max(late)) * 1e3],
            "latency_ms_p50_p90_p95_p99_mean": [
                round(float(np.percentile(lat, q)) * 1e3, 4)
                for q in (50, 90, 95, 99)]
            + [round(float(lat.mean()) * 1e3, 4)] if len(lat) else []}
        attempted = len(due)
        taken_all = np.arange(first, pods.s)
        t_close = t_open + ctx.seconds
    if backlog:
        end_stretch()
    ctx.sync()
    gc.callbacks.remove(on_gc)
    host = {"probe_ms": [state["probe"], _host_probe()],
            "main_cpu_share": round((time.thread_time() - state["thread0"])
                                    / (time.perf_counter() - state["t_open"]),
                                    4)}
    marks = [(0.0, 0, 0)] + cycle_log
    per_slice: dict[int, list[int]] = {}
    for (_, r0, b0), (t, r1, b1) in zip(marks, marks[1:]):
        acc = per_slice.setdefault(int(t // 5.0), [0, 0])
        acc[0] += r1 - r0
        acc[1] += b1 - b0
    at = {}
    for _, r, b in cycle_log:
        for mark in (32, 64, 96, 128, 192):
            if b >= mark and mark not in at:
                at[mark] = r
    out.setdefault("diag", {}).update(
        setup_marks_s=ctx.marks, cycles=state["cycles"],
        batches=rec.batches, rounds_at_batches=at,
        gc2_pauses_at_s_ms=[[round(t, 3), round(x * 1e3, 3)]
                            for t, x in gc_pauses], host=host,
        rounds_per_batch_per_5s=[round(r / max(b, 1), 3) for _, (r, b)
                                 in sorted(per_slice.items())])
    bound_set = _bind_times(api)
    failed = int(sum(int(i) not in bound_set for i in due))
    unbound = np.asarray([i for i in taken_all if int(i) not in bound_set],
                         np.int64)
    upto = state.get("timers_at_trace") or timers()
    out.update(
        window_s=t_close - t_open, attempted=int(attempted),
        failed=failed, cycles=state.get("cycles_at_trace", state["cycles"]),
        batches=rec.batches, rounds=rec.rounds,
        stretch_batches=state["stretch_batches"],
        timer={k: (upto[k][0] - c0, upto[k][1] - t0)
               for k, (c0, t0) in state["timer0"].items()})
    ctx.window_closed()
    slot = np.asarray([loop.encoder.node_index(n) for n in cluster.names])
    program_used = loop.encoder.snapshot().used.cpu().numpy()[slot]
    loop.stop_bind_worker()
    cycles = _cycles(api, cluster)
    rec.undo()
    del loop, api, arrivals
    gc.collect()
    if stretch is not None:
        out["trace"] = stretch.reduce()
        out["launches"] = rec.take_launches()
    ctx.free()
    t0 = time.perf_counter()
    model = reference.Model(cluster, ctx.config["scheduler"]["weights"],
                            ctx.device)
    out["checks"] = reference.check(model, pods, cycles, program_used,
                                    unbound)
    out["reference_s"] = time.perf_counter() - t0
    return out


def cycle_sizes(config: dict, traffic: dict, pods: int) -> list[int]:
    """The loop's cycles for the control: full bursts from a backlog;
    at a uniform rate, the mix's ``control_cycle_pods`` (the pods a
    cycle held on the card at that rate)."""
    if traffic["arrivals"] == "backlog":
        size = (config["serve"]["burst_batches"]
                * config["scheduler"]["max_pods"])
    else:
        size = int(traffic.get("control_cycle_pods", 1))
    return [min(size, pods - lo) for lo in range(0, pods, size)]


def control(config: dict, traffic: dict, limits: dict, seed: int,
            pods_n: int, device: str, net_dtype=None, dtype=None) -> dict:
    """The reference one precision below the configuration (float8
    network operands, everything else in bfloat16) placing the first
    ``pods_n`` arrivals in the cycles the loop would serve them in, held
    to the check a run is held to (``python3 -m benchmark.control``)."""
    import torch

    net_dtype = net_dtype or torch.float8_e4m3fn
    dtype = dtype or torch.bfloat16
    t0 = time.perf_counter()
    cluster = generate.make_cluster(config["cluster"], seed, device)
    arrivals = generate.arrivals_of(traffic, pods_n / max(
        traffic.get("rate_per_s", 1.0), 1e-9))
    pods = generate.make_pods(traffic, cluster.n, seed,
                              max(arrivals, pods_n))
    weights = config["scheduler"]["weights"]
    low = reference.Model(cluster, weights, device, dtype=dtype,
                          net_dtype=net_dtype)
    order = np.arange(pods.first_arrival, pods.first_arrival + pods_n)
    cycles, used = reference.greedy_cycles(
        low, pods, order, cycle_sizes(config, traffic, pods_n))
    del low
    placed = np.concatenate([np.asarray(c[0], np.int64) for c in cycles])
    unbound = np.setdiff1d(order, placed)
    model = reference.Model(cluster, weights, device)
    checks = reference.check(model, pods, cycles,
                             used.double().cpu().numpy(), unbound)
    return {"seed": seed, "pods": pods_n, "checks": checks,
            "correct": all(v <= limits[k] for k, v in checks.items()),
            "seconds": time.perf_counter() - t0}
