"""Scrape pool: concurrent, failure-tolerant node_exporter ingestion.

The reference scrapes all nodes *serially inside every scheduling
cycle* (5 blocking ``http.Get`` calls per pod scheduled,
scheduler.go:275-279) and crashes on scrape failure (nil body read,
scheduler.go:397-405).  The pool scrapes concurrently on its own
cadence, parses with the real parser, feeds the Encoder, and treats
failure as staleness: a node that stops answering just ages out of the
score (the ``exp(-age/tau)`` decay in
:func:`~..core.score.metric_scores`) and is marked unready after
``unready_after_s``.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
import urllib.request
from typing import Callable, Mapping

from kubernetesnetawarescheduler_tpu_torch.core.encode import Encoder
from kubernetesnetawarescheduler_tpu_torch.ingest.prometheus import (
    NodeExporterExtractor,
)

FetchFn = Callable[[str], str]


def http_fetch(url: str, timeout_s: float = 2.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", errors="replace")


class ScrapePool:
    """Scrapes ``targets`` (node name -> metrics URL) into an Encoder.

    ``fetch`` is pluggable for tests (and for transports other than
    plain HTTP :9100, the reference's hardcoded endpoint shape,
    scheduler.go:275-279).
    """

    def __init__(self, encoder: Encoder, targets: Mapping[str, str],
                 fetch: FetchFn = http_fetch,
                 extractor: NodeExporterExtractor | None = None,
                 max_workers: int = 16,
                 unready_after_s: float = 300.0) -> None:
        self._encoder = encoder
        self._targets = dict(targets)
        self._fetch = fetch
        if extractor is None:
            # Native single-pass parser when built, Python fallback.
            from kubernetesnetawarescheduler_tpu_torch.ingest.native import (
                make_extractor,
            )
            extractor = make_extractor()
        self._extractor = extractor
        self._max_workers = max_workers
        self._unready_after_s = unready_after_s
        self._last_success: dict[str, float] = {}
        self._marked_unready: set[str] = set()
        self.failures = 0
        self.successes = 0

    def _scrape_one(self, name: str, url: str) -> tuple[str, dict] | None:
        try:
            body = self._fetch(url)
            return name, self._extractor.extract(body)
        except Exception:
            return None

    def scrape_all(self, now_s: float | None = None) -> int:
        """One concurrent sweep; returns successful scrape count."""
        now = time.monotonic() if now_s is None else now_s
        for name in self._targets:
            # First sighting counts as the baseline, so a node that
            # never answers still ages toward unready.
            self._last_success.setdefault(name, now)
        ok = 0
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self._max_workers) as pool:
            futures = [pool.submit(self._scrape_one, name, url)
                       for name, url in self._targets.items()]
            for fut in concurrent.futures.as_completed(futures):
                result = fut.result()
                if result is None:
                    self.failures += 1
                    continue
                name, channels = result
                self._encoder.update_metrics(name, channels, age_s=0.0)
                self._last_success[name] = now
                self.successes += 1
                ok += 1
                if name in self._marked_unready:
                    # Recovery: only nodes *we* benched come back this
                    # way — a node cordoned via the API stays unready.
                    self._marked_unready.discard(name)
                    self._encoder.mark_ready(name)
        # Nodes silent for too long get marked unready (failure
        # detection — SURVEY.md 5).
        for name, last in self._last_success.items():
            if now - last > self._unready_after_s and \
                    name not in self._marked_unready:
                self._marked_unready.add(name)
                self._encoder.mark_unready(name)
        return ok

    def run_forever(self, period_s: float = 15.0,
                    stop: threading.Event | None = None) -> None:
        """Sweep every ``period_s`` until ``stop`` is set (forever
        without one)."""
        stop = stop if stop is not None else threading.Event()
        while not stop.is_set():
            start = time.monotonic()
            self.scrape_all()
            self._encoder.age_metrics(period_s)
            elapsed = time.monotonic() - start
            stop.wait(max(0.0, period_s - elapsed))
