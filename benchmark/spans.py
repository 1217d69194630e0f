"""The harness's own spans and recorders around the program's calls.

Nothing here changes what the program computes: each wrapper calls the
program's function with the same arguments and returns its result.

- :class:`Recorder` wraps the conflict loop (``assign_parallel``, as
  the loop's per-batch cycle and the replay's burst step call it) to
  count batches and conflict rounds, and the static kernel's entry point
  to note each launch's problem: the pods and nodes it really holds,
  not the padding (for the roofline work counts in
  ``benchmark/work/``).
- While ``tracing`` is on, the layers' calls run inside
  ``torch.profiler.record_function`` ranges named ``bench.<layer>``, so
  the trace can say what the host was doing while the device idled.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch


class Recorder:
    """``nodes``: the cluster's node count, which the driver sets (the
    program pads its node axis past it)."""

    def __init__(self, nodes: int = 0) -> None:
        self.lock = threading.Lock()
        self.batches = 0
        self.rounds = 0
        self.nodes = nodes
        self.tracing = False
        self.launches: dict[str, list[dict]] = {}
        self._undo: list = []

    def span(self, layer: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{layer}")

    def _patch(self, owner, attr: str, wrapper_of) -> None:
        orig = getattr(owner, attr)
        setattr(owner, attr, functools.wraps(orig)(wrapper_of(orig)))
        self._undo.append((owner, attr, orig))

    def undo(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def install(self) -> None:
        """Wrap the program's entry points; call before the loop is
        built (it binds its assigner then)."""
        from kubernetesnetawarescheduler_tpu_torch.core import (
            encode,
            loop,
            replay,
            tiled_score,
        )

        def assign(orig):
            def run(*a, **kw):
                with self.span("score_assign"):
                    out = orig(*a, **kw)
                if kw.get("with_stats") and isinstance(out, tuple):
                    with self.lock:
                        self.batches += 1
                        self.rounds += int(out[1])
                return out
            return run

        for mod in (loop, replay):
            self._patch(mod, "assign_parallel", assign)

        def static_launch(orig):
            def run(pack, *a, **kw):
                if self.tracing:
                    pods = a[1]
                    hit = pods.t != 0
                    rec = {"p": pods.pod_valid.sum(),
                           "n": self.nodes,
                           "w": int(pods.tol.shape[1]),
                           "nnz": hit.sum(), "cols": hit.any(0).sum()}
                    with self.lock:
                        self.launches.setdefault(
                            "static_scores_kernel", []).append(rec)
                return orig(pack, *a, **kw)
            return run

        self._patch(tiled_score, "static_tile_scores", static_launch)

        def layer(name):
            def wrap(orig):
                def run(*a, **kw):
                    with self.span(name):
                        return orig(*a, **kw)
                return run
            return wrap

        for attr in ("encode_pods", "encode_stream"):
            self._patch(encode.Encoder, attr, layer("encode"))
        self._patch(loop.SchedulerLoop, "_bind_all", layer("bind"))
        self._patch(replay, "replay_stream_static", layer("score_assign"))

    def take_launches(self) -> dict[str, list[dict]]:
        """The launches noted while tracing, their device counts read."""
        with self.lock:
            out = self.launches
            self.launches = {}
        for recs in out.values():
            for r in recs:
                for k in ("p", "nnz", "cols"):
                    r[k] = int(r[k])
        return out
