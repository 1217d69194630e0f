"""State integrity: plane digests, the anti-entropy auditor, and the
automatic repair ladder.

The PyTorch package's copy of the JAX package's ``core/integrity.py``.
The encoder keeps a host staging mirror and patches the device planes
with row/pair scatters (core/encode.py ``snapshot_versioned``); a dropped
or re-ordered patch, a NaN-poisoned row or a flipped bit in a device
plane silently drifts the device view away from staging truth.  Three
legs close that gap:

- **Detect** — one rolling checksum per plane row, computed identically
  over the device state (:func:`device_row_digests`,
  :func:`plane_digest_vector`) and by a numpy mirror over host arrays
  (:func:`host_row_digests`, :func:`host_plane_digest_vector`).
  Bit-exact agreement of the two is the delta-ingest invariant;
  disagreement localizes drift to (plane, row).
- **Audit** — :class:`IntegrityAuditor` flushes pending deltas, derives
  the expected device view from staging
  (``Encoder.expected_device_arrays``) and compares digests.  A clean
  audit only flushes, so placements are the same with the auditor on or
  off.
- **Repair** — a ladder, cheapest rung first: row re-patch from staging
  -> full re-encode -> checkpoint restore -> apiserver relist, re-audited
  after each rung; per-rung counters feed ``/metrics``, escalations emit
  k8s Events, and drift that survives the ladder for
  ``watchdog_failures`` audits in a row dumps the flight recorder.

A rung's host side (marking dirt, reading a checkpoint, relisting) may
fail and escalate to the next rung; the flush that uploads the repaired
planes and the digests run outside any handler, so a fault of the device
propagates.  Fault injection lives in core/state_chaos.py.

Per row: ``digest = Σ_k u32(row[k]) · (2k + 1)  (mod 2^32)`` over the raw
bit patterns (float32 and int32 reinterpreted as uint32, bool as 0/1).
Odd weights make the map value -> digest a bijection per element, so a
single flipped bit always moves the digest.

torch has no general uint32 arithmetic.  The device side reinterprets
f32 and i32 as int32, widens to int64 and masks with ``& 0xFFFFFFFF``;
products and sums stay in int64, whose wraparound keeps the low 32 bits
right; a final mask leaves the u32 value, returned as the int32 with the
same bits (``numpy .view(np.uint32)`` recovers the JAX package's words).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Mapping, Sequence

import numpy as np
import torch

from kubernetesnetawarescheduler_tpu_torch.core.state import ClusterState

#: Every ClusterState plane, in checkpoint order, with the encoder dirty
#: group whose transfer path owns it.  The digest machinery iterates
#: this; tests/test_torch_integrity.py fails when a ClusterState field
#: is missing here.
PLANES: tuple[tuple[str, str], ...] = (
    ("metrics", "metrics"),
    ("metrics_age", "metrics"),
    ("lat", "net"),
    ("bw", "net"),
    ("cap", "alloc"),
    ("used", "alloc"),
    ("node_valid", "topo"),
    ("label_bits", "topo"),
    ("taint_bits", "topo"),
    ("group_bits", "alloc"),
    ("resident_anti", "alloc"),
    ("node_zone", "topo"),
    ("gz_counts", "alloc"),
    ("az_anti", "alloc"),
    ("node_numeric", "topo"),
)

PLANE_NAMES: tuple[str, ...] = tuple(name for name, _ in PLANES)
GROUP_OF: dict[str, str] = dict(PLANES)

#: Float planes where a non-finite STAGING value is itself corruption
#: (the ingest paths all validate; NaN here means something bypassed
#: them).  node_numeric is excluded on purpose: NaN is its legitimate
#: "label absent" sentinel.
_FINITE_PLANES = ("metrics", "metrics_age", "lat", "bw", "cap", "used")

#: The repair ladder, cheapest first.  Rung names are the
#: ``netaware_integrity_repairs_total{rung=...}`` label values.
REPAIR_RUNGS = ("repatch_rows", "full_reencode", "checkpoint_restore",
                "relist")

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host (numpy) digests.
# ---------------------------------------------------------------------------


def _row_weights(width: int) -> np.ndarray:
    return (2 * np.arange(width, dtype=np.uint32) + np.uint32(1))


def _host_u32_rows(arr: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(arr)
    if a.dtype == np.bool_:
        a = a.astype(np.uint32)
    elif a.dtype in (np.dtype(np.float32), np.dtype(np.int32)):
        a = a.view(np.uint32)
    elif a.dtype != np.dtype(np.uint32):
        a = a.astype(np.float32).view(np.uint32)
    return a.reshape(a.shape[0], -1)


def host_row_digest(arr: np.ndarray) -> np.ndarray:
    """``u32[rows]`` rolling digest of one host array."""
    u = _host_u32_rows(arr)
    w = _row_weights(u.shape[1])
    return np.sum(u * w[None, :], axis=1, dtype=np.uint32)


def host_row_digests(arrays: Mapping[str, np.ndarray]
                     ) -> dict[str, np.ndarray]:
    """Per-plane row digests of a host array set (the expected device
    view from ``Encoder.expected_device_arrays``, or a state's
    ``.numpy()``)."""
    return {name: host_row_digest(arrays[name]) for name in PLANE_NAMES
            if name in arrays}


def _fold_rows(rowd: np.ndarray) -> np.ndarray:
    """One plane's row digests folded to its scalar digest."""
    return np.sum(rowd * _row_weights(int(rowd.shape[0])), dtype=np.uint32)


def host_plane_digest_vector(arrays: Mapping[str, np.ndarray]
                             ) -> np.ndarray:
    """Numpy mirror of :func:`plane_digest_vector`: ``u32[len(PLANES)]``."""
    return np.stack([_fold_rows(host_row_digest(arrays[name]))
                     for name in PLANE_NAMES])


def compare_row_digests(dev: Mapping[str, np.ndarray],
                        host: Mapping[str, np.ndarray]
                        ) -> dict[str, list[int]]:
    """Drift localization: plane -> sorted row indices whose digests
    disagree.  Empty dict == bit-identical state."""
    drift: dict[str, list[int]] = {}
    for name in PLANE_NAMES:
        if name not in dev or name not in host:
            continue
        rows = np.flatnonzero(np.asarray(dev[name])
                              != np.asarray(host[name]))
        if rows.size:
            drift[name] = [int(r) for r in rows]
    return drift


def staging_sanity(arrays: Mapping[str, np.ndarray]
                   ) -> dict[str, list[int]]:
    """Rows of the HOST truth itself holding non-finite values in planes
    where that is corruption (see ``_FINITE_PLANES``).  Device-vs-staging
    digests cannot see this case (both sides agree on the poison), so the
    auditor checks it separately and repairs from the checkpoint rung."""
    bad: dict[str, list[int]] = {}
    for name in _FINITE_PLANES:
        if name not in arrays:
            continue
        a = np.asarray(arrays[name])
        flat = a.reshape(a.shape[0], -1)
        rows = np.flatnonzero(~np.all(np.isfinite(flat), axis=1))
        if rows.size:
            bad[name] = [int(r) for r in rows]
    return bad


# ---------------------------------------------------------------------------
# Device (torch) digests.
# ---------------------------------------------------------------------------


def _dev_u32_rows(x: torch.Tensor) -> torch.Tensor:
    """The plane's raw bits as u32 values held in int64, one row per
    leading index."""
    if x.dtype == torch.bool:
        u = x.to(torch.int64)
    else:
        if x.dtype not in (torch.float32, torch.int32):
            x = x.to(torch.float32)
        u = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    return u.reshape(x.shape[0], -1)


def _weights(width: int, dev: torch.device) -> torch.Tensor:
    return 2 * torch.arange(width, dtype=torch.int64, device=dev) + 1


def _dev_row_digest(x: torch.Tensor) -> torch.Tensor:
    """``Σ_k u32(row[k]) · (2k + 1) mod 2^32`` per row, as int64 in
    ``[0, 2^32)``."""
    u = _dev_u32_rows(x)
    return (u * _weights(u.shape[1], u.device)[None, :]).sum(dim=1) & _U32


def _as_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` as the int32 with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def device_row_digests(state: ClusterState) -> dict[str, torch.Tensor]:
    """Per-plane ``u32[rows]`` digests of the device state, each as an
    int32 tensor with the same bits."""
    return {name: _as_i32_bits(_dev_row_digest(getattr(state, name)))
            for name in PLANE_NAMES}


def plane_digest_vector(state: ClusterState) -> torch.Tensor:
    """``u32[len(PLANES)]`` as int32 bits — one scalar digest per plane,
    the compact fingerprint :func:`~.assign.fused_schedule_step` returns
    with ``with_digest=True``."""
    folded = []
    for name in PLANE_NAMES:
        rowd = _dev_row_digest(getattr(state, name))
        w = _weights(rowd.shape[0], rowd.device)
        folded.append((rowd * w).sum() & _U32)
    return _as_i32_bits(torch.stack(folded))


def device_row_digests_host(state: ClusterState) -> dict[str, np.ndarray]:
    """:func:`device_row_digests` on the host as numpy ``uint32`` rows
    (the JAX package's words): a few KB per audit at N=5120."""
    return {name: d.cpu().numpy().view(np.uint32)
            for name, d in device_row_digests(state).items()}


# ---------------------------------------------------------------------------
# The anti-entropy auditor + repair ladder.
# ---------------------------------------------------------------------------


class IntegrityAuditor:
    """Periodic device-vs-staging integrity audit with self-healing.

    ``audit_once`` is the whole cycle: flush pending deltas, compare
    digests, and if anything drifted walk the repair ladder, re-auditing
    after each rung.  ``start``/``stop`` run it on a daemon thread every
    ``interval_s`` (the serve.py ``--audit-interval`` flag).

    Clean-run identity: a passing audit only calls
    ``snapshot_versioned()``, the same flush the next scheduling cycle
    would perform, so placements are unchanged by auditing.
    """

    def __init__(self, encoder, loop=None, *,
                 interval_s: float = 5.0,
                 checkpoint_dir: str | None = None,
                 watchdog_failures: int = 3,
                 crash_dump_path: str | None = None) -> None:
        self.encoder = encoder
        self.loop = loop
        self.interval_s = float(interval_s)
        self.checkpoint_dir = checkpoint_dir
        self.watchdog_failures = max(1, int(watchdog_failures))
        self.crash_dump_path = crash_dump_path
        # Counters (selfmetrics reads these; names mirror /metrics).
        self.audits_total = 0
        self.drift_detected_total = 0
        self.drift_rows_total = 0
        self.repairs = {rung: 0 for rung in REPAIR_RUNGS}
        self.unrepaired_total = 0
        self.watchdog_dumps = 0
        self.last_audit_ms = 0.0
        self.last_drift: dict[str, list[int]] = {}
        self.audit_ms: "deque[float]" = deque(maxlen=2048)
        self._unrepaired_streak = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The exception that ended the background thread, re-raised by
        # stop().
        self._error: BaseException | None = None

    # -- detect -------------------------------------------------------

    def check(self) -> tuple[dict[str, list[int]], dict[str, list[int]]]:
        """One detection pass: ``(device_drift, staging_corruption)``,
        both plane -> row lists (empty == clean).  Flushes pending
        deltas first so legitimate not-yet-shipped dirt is never
        reported as drift."""
        enc = self.encoder
        with enc._lock:
            state, _ = enc.snapshot_versioned()
            expected = enc.expected_device_arrays()
        dev = device_row_digests_host(state)
        host = host_row_digests(expected)
        return compare_row_digests(dev, host), staging_sanity(expected)

    # -- repair rungs (host side; _flush uploads) ---------------------

    def _rung_repatch_rows(self, drift: Mapping[str, Sequence[int]]
                           ) -> None:
        """Rung 1: mark exactly the drifted rows dirty.  Net drift
        re-ships the whole group: its delta protocol is (i, j) pairs,
        and a drifted ROW of an N x N matrix is past the pair-scatter's
        break-even."""
        enc = self.encoder
        with enc._lock:
            for plane, rows in drift.items():
                group = GROUP_OF[plane]
                if group == "net":
                    enc._mark_full("net")
                else:
                    enc._mark_rows(group, *[int(r) for r in rows])

    def _mark_all_full(self) -> None:
        enc = self.encoder
        with enc._lock:
            enc._cache.clear()
            for group in enc._dirty:
                enc._mark_full(group)

    def _rung_checkpoint_restore(self) -> None:
        """Rung 3: overwrite the STAGING planes from the last good
        (manifest-verified) checkpoint, then re-encode in full.  Repairs
        staging-side corruption rungs 1-2 cannot touch; the ledger and
        interners are left alone (rung 4's relist reconciles them)."""
        if not self.checkpoint_dir:
            raise RuntimeError("no checkpoint directory configured")
        from kubernetesnetawarescheduler_tpu_torch.core.checkpoint import (
            _STATE_ARRAYS,
            read_state_arrays,
        )

        arrays = read_state_arrays(self.checkpoint_dir)
        enc = self.encoder
        with enc._lock:
            for name in _STATE_ARRAYS:
                target = getattr(enc, name)
                stored = arrays[name.lstrip("_")]
                if stored.shape != target.shape:
                    raise ValueError(
                        f"checkpoint array {name} has shape "
                        f"{stored.shape}, expected {target.shape}")
                target[...] = stored
        self._mark_all_full()

    def _apply_rung(self, rung: str,
                    drift: Mapping[str, Sequence[int]]) -> None:
        if rung == "repatch_rows":
            self._rung_repatch_rows(drift)
        elif rung == "full_reencode":
            # Rung 2: drop the device cache and re-upload every plane
            # from staging (the full-transfer path).
            self._mark_all_full()
        elif rung == "checkpoint_restore":
            self._rung_checkpoint_restore()
        elif rung == "relist":
            # Rung 4: apiserver relist (the watch-gap audit) repairs
            # ledger/node drift at the source of truth, then re-encode.
            if self.loop is not None:
                self.loop.relist_audit()
            self._mark_all_full()
        else:  # pragma: no cover - registry and ladder stay in sync
            raise ValueError(f"unknown repair rung {rung!r}")

    def _flush(self) -> None:
        """Upload what a rung marked: the device side of every rung."""
        enc = self.encoder
        with enc._lock:
            enc.snapshot()

    def _emit_event(self, message: str) -> None:
        loop = self.loop
        if loop is None or getattr(loop, "client", None) is None:
            return
        try:
            from kubernetesnetawarescheduler_tpu_torch.k8s.types import (
                Event,
            )

            loop.client.create_event(Event(
                message=message,
                reason="StateIntegrity",
                involved_pod=loop.cfg.scheduler_name,
                namespace="default",
                component=loop.cfg.scheduler_name,
                type="Warning"))
        except Exception:  # noqa: BLE001 — events are best-effort
            pass

    # -- the audit cycle ----------------------------------------------

    def audit_once(self) -> dict:
        """Detect + repair.  Returns a summary dict:
        ``{"clean", "drift", "staging", "rung", "repaired"}``."""
        t0 = time.perf_counter()
        self.audits_total += 1
        drift, staging_bad = self.check()
        out = {"clean": not drift and not staging_bad,
               "drift": drift, "staging": staging_bad,
               "rung": None, "repaired": True}
        if not out["clean"]:
            self.drift_detected_total += 1
            self.drift_rows_total += sum(
                len(r) for r in drift.values()) + sum(
                len(r) for r in staging_bad.values())
            self.last_drift = {**drift,
                               **{f"staging:{k}": v
                                  for k, v in staging_bad.items()}}
            out.update(self._repair(drift, staging_bad))
        if out["repaired"]:
            self._unrepaired_streak = 0
        else:
            self._unrepaired_streak += 1
            if self._unrepaired_streak >= self.watchdog_failures:
                self._watchdog_fire()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.last_audit_ms = dt_ms
        self.audit_ms.append(dt_ms)
        return out

    def _repair(self, drift: dict, staging_bad: dict) -> dict:
        for i, rung in enumerate(REPAIR_RUNGS):
            if (rung == "checkpoint_restore"
                    and not self.checkpoint_dir):
                continue
            if rung == "relist" and self.loop is None:
                # A bare-encoder auditor has no apiserver to relist
                # against; full_reencode is then its top rung.
                continue
            try:
                self._apply_rung(rung, drift)
            except Exception:  # noqa: BLE001 — a failing rung (no
                # checkpoint, a shape mismatch, a checkpoint refused by
                # its manifest, a failed relist) escalates to the next.
                continue
            self._flush()
            drift, staging_bad = self.check()
            if not drift and not staging_bad:
                self.repairs[rung] += 1
                if i > 0:
                    self._emit_event(
                        f"state drift repaired at rung '{rung}' "
                        f"(escalated past {i} cheaper rung(s))")
                return {"rung": rung, "repaired": True,
                        "drift": {}, "staging": {}}
        self.unrepaired_total += 1
        self._emit_event(
            "state drift UNREPAIRED after full ladder: "
            + ", ".join(sorted(set(drift) | {f"staging:{k}"
                                             for k in staging_bad})))
        return {"rung": None, "repaired": False,
                "drift": drift, "staging": staging_bad}

    def _watchdog_fire(self) -> None:
        """Stuck-audit watchdog: drift has survived the whole ladder for
        ``watchdog_failures`` consecutive audits — dump the flight
        recorder for the post-mortem (once per streak)."""
        if self._unrepaired_streak != self.watchdog_failures:
            return
        self.watchdog_dumps += 1
        loop = self.loop
        flight = getattr(loop, "flight", None) if loop else None
        if flight is not None and self.crash_dump_path:
            try:
                flight.crash_dump(
                    self.crash_dump_path, reason="stuck_audit",
                    extra={"drift": {k: list(v) for k, v
                                     in self.last_drift.items()},
                           "unrepaired_streak":
                               self._unrepaired_streak,
                           "repairs": dict(self.repairs)})
            except Exception:  # noqa: BLE001 — the dump is best-effort
                pass

    # -- background thread --------------------------------------------

    def start(self) -> None:
        """Run :meth:`audit_once` every ``interval_s`` on a daemon
        thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(
            target=self._run, name="integrity-audit", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # What escapes audit_once is not a rung failure (the ladder
        # handles those) but a fault of the flush or the digests: it
        # ends the thread, and stop() raises it.
        while not self._stop.wait(self.interval_s):
            try:
                self.audit_once()
            except Exception as exc:  # noqa: BLE001 — handed to stop()
                self._error = exc
                return

    def stop(self, timeout: float | None = 10.0) -> None:
        """Stop the thread; raise the error that ended it, if any."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout)
        self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err
