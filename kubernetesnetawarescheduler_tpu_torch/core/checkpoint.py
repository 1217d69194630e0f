"""Checkpoint / resume + the decision log.

The PyTorch package's copy of ``kubernetesnetawarescheduler_tpu/core/
checkpoint.py``.  A checkpoint is the :class:`~.encode.Encoder`'s numpy
staging and ledger, which the port keeps as they are, so the files are
byte-compatible: a checkpoint saved by either package loads in the
other.  The learned layers that ride beside the encoder state (the
topology model's ``netmodel.npz`` and the scoring policy's
``policy.npz``) keep the JAX files' keys, dtypes and shapes, so they
load across packages too.

The reference has NO persistence: its only state is the in-memory pod
channel plus the last scraped values, so a scheduler restart loses every
queued pod (they are enqueued only on ADD events, scheduler.go:165-173,
with no re-list on startup).  SURVEY.md §5 sets the bar for the build:
pending pods are reconstructable from the API server (that part is
:meth:`~..k8s.client.ClusterClient.list_pending_pods` + the informer
resync), and the *metric store* — the HBM-resident matrices the ingest
pipeline spent minutes building — plus the *decision log* are
snapshotted here so benchmarks replay deterministically.

A checkpoint is a directory:

- ``state.npz``  — every staging array of the :class:`~.encode.Encoder`
  (metrics, ages, the ``N×N`` lat/bw matrices, capacity/usage, validity
  and constraint bitmasks; u32 masks stay u32).
- ``meta.json``  — config echo, node name table, interner tables
  (string -> bit position), and counters.
- ``MANIFEST.json`` — per-file SHA-256 digests; its rename is the
  SINGLE commit point of a save (r10).  Payload files are written to
  ``.staging/`` and renamed into place first, the previous good file
  set is preserved under ``previous/``, and restore verifies every
  digest — a crash anywhere in the sequence leaves either the old
  committed set or a digest mismatch that falls back to
  ``previous/``, never a silently-torn mixed-version checkpoint.

``decisions.jsonl`` (one JSON object per scheduling decision) is written
by :class:`DecisionLog`, which the loop appends to; replaying the same
pod stream against a restored checkpoint must reproduce it bit-for-bit
(test: tests/test_checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Iterator, Sequence

import numpy as np

from kubernetesnetawarescheduler_tpu_torch.config import (
    SchedulerConfig,
    config_from_dict,
    config_to_dict,
)
from kubernetesnetawarescheduler_tpu_torch.core.encode import (
    Encoder,
    words_to_int,
)

_STATE_ARRAYS = (
    "_metrics", "_metrics_age", "_lat", "_bw", "_cap", "_used",
    "_node_valid", "_label_bits", "_taint_bits", "_group_bits",
    "_resident_anti", "_node_zone", "_gz_counts", "_az_anti",
    "_node_numeric",
)

# Format history (NONE of the pre-v6 formats load anymore — see
# _ACCEPTED_VERSIONS; kept as a record of what each version added):
# v2 widened constraint bitmasks to u32[N, mask_words] and persisted
# raw node-label sets; v3 added topology-spread state; v4 zone-scoped
# anti-affinity residency; v5 the labelSelector-parity registry with
# per-record full membership masks and pod labels.  (The _rec() short-
# entry tolerances below remain live for a different reason: ledger
# ENTRIES may legitimately predate group tracking — the phantom-ref
# behavior test_restore_rebuilds_group_refcounts pins.)
# v6: namespace-scoped group keys (round 4) — selector-group and
# annotation-group keys parsed from kube objects now carry the
# namespace qualifier (kubeclient.NS_SEP).  Pre-v6 checkpoints hold
# memberships under the old cluster-wide keys: restoring them into the
# scoped parser would silently SPLIT each group across old/new keys
# (old residents invisible to new pods' terms — anti-affinity would
# degrade open without an event), so pre-v6 is REFUSED rather than
# migrated; the ledger is reconstructable from the API server.
FORMAT_VERSION = 6
_ACCEPTED_VERSIONS = (6,)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One scheduling outcome, as logged: ``node == ""`` means
    unschedulable (the reference's analog is the "Scheduled" k8s Event,
    scheduler.go:214-233 — we keep those too; this log is the replayable
    record)."""

    seq: int
    pod: str
    node: str

    def to_json(self) -> str:
        return json.dumps({"seq": self.seq, "pod": self.pod,
                           "node": self.node})


class DecisionLog:
    """Append-only decision record with optional streaming to disk."""

    def __init__(self, path: str | None = None) -> None:
        self.decisions: list[Decision] = []
        self._fh = open(path, "a", encoding="utf-8") if path else None

    def append(self, pod: str, node: str) -> None:
        d = Decision(len(self.decisions), pod, node)
        self.decisions.append(d)
        if self._fh is not None:
            self._fh.write(d.to_json() + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __len__(self) -> int:
        return len(self.decisions)

    def __iter__(self) -> Iterator[Decision]:
        return iter(self.decisions)

    @staticmethod
    def load(path: str) -> "DecisionLog":
        log = DecisionLog()
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                if line.strip():
                    obj = json.loads(line)
                    log.decisions.append(
                        Decision(obj["seq"], obj["pod"], obj["node"]))
        return log

    def same_as(self, other: "DecisionLog") -> bool:
        return [dataclasses.astuple(d) for d in self.decisions] == \
            [dataclasses.astuple(d) for d in other.decisions]


# ---------------------------------------------------------------------------
# Manifest protocol (r10): per-file SHA-256 digests, one commit point.
# ---------------------------------------------------------------------------

MANIFEST = "MANIFEST.json"
PREVIOUS_DIR = "previous"
_STAGING_DIR = ".staging"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_manifest(path: str) -> "list[str] | None":
    """Digest-check a checkpoint directory against its manifest.

    Returns ``None`` when no manifest exists (a pre-r10 checkpoint —
    the caller decides whether to trust it), ``[]`` when every listed
    file is present with a matching SHA-256, and a list of
    human-readable mismatch descriptions otherwise."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, encoding="utf-8") as fh:
            manifest = json.load(fh)
        files = dict(manifest["files"])
    except Exception as exc:  # noqa: BLE001 — unreadable manifest IS
        # a verification failure, not a missing one
        return [f"manifest unreadable: {exc}"]
    errors: list[str] = []
    for name, digest in files.items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            errors.append(f"{name}: listed in manifest but missing")
        elif _sha256_file(fpath) != digest:
            errors.append(f"{name}: SHA-256 mismatch")
    return errors


def update_manifest(path: str) -> None:
    """Recompute the manifest digests for the files currently in
    ``path`` (keeping the existing file list).  For tooling and tests
    that legitimately edit a checkpoint in place — production writers
    go through :func:`save_checkpoint`'s staged commit."""
    mpath = os.path.join(path, MANIFEST)
    with open(mpath, encoding="utf-8") as fh:
        manifest = json.load(fh)
    manifest["files"] = {
        name: _sha256_file(os.path.join(path, name))
        for name in manifest["files"]
        if os.path.exists(os.path.join(path, name))}
    tmp = mpath + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2)
    os.replace(tmp, mpath)


def resolve_checkpoint_dir(path: str) -> str:
    """The directory restore should actually read: ``path`` when its
    manifest verifies (or predates manifests), else the preserved
    ``previous/`` good set, else a :class:`ValueError` — garbage is
    REFUSED, never loaded."""
    errors = verify_manifest(path)
    if errors is None:
        # Pre-r10 checkpoint: no digests to check.  Loaded as before
        # (np.load/json still fail loudly on gross truncation).
        return path
    if not errors:
        return path
    prev = os.path.join(path, PREVIOUS_DIR)
    prev_errors = verify_manifest(prev)
    if prev_errors == []:
        import sys

        print(f"WARNING: checkpoint {path} failed verification "
              f"({'; '.join(errors)}); falling back to the previous "
              "good checkpoint", file=sys.stderr)
        return prev
    raise ValueError(
        f"checkpoint {path} is corrupt ({'; '.join(errors)}) and no "
        "verified previous checkpoint is available — refusing to "
        "restore (start fresh; state rebuilds from the API server)")


def read_state_arrays(path: str) -> "dict[str, np.ndarray]":
    """Load (and digest-verify) just the ``state.npz`` plane arrays
    from a checkpoint — the integrity repair ladder's
    checkpoint-restore rung reads staging planes without rebuilding a
    whole Encoder."""
    base = resolve_checkpoint_dir(path)
    out: dict[str, np.ndarray] = {}
    with np.load(os.path.join(base, "state.npz")) as data:
        for name in _STATE_ARRAYS:
            key = name.lstrip("_")
            if key not in data:
                raise ValueError(
                    f"checkpoint state.npz is missing array {name!r}")
            out[key] = np.array(data[key])
    return out


# ---------------------------------------------------------------------------
# Encoder snapshot <-> directory.
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, encoder: Encoder,
                    policy=None,
                    extra_meta: dict | None = None) -> None:
    """Write the encoder's full staging state (the host mirror of the
    HBM matrices) + naming/interning tables under ``path``.

    ``policy``, when given, is the loop's learned
    :class:`~kubernetesnetawarescheduler_tpu_torch.policy.ScoringPolicy`:
    its parameters/optimizer/example ring land in ``policy.npz``
    beside the encoder state, and the promotion provenance rides the
    manifest-verified meta.  An attached topology model lands in
    ``netmodel.npz``.

    ``extra_meta`` (r15): caller-owned top-level meta entries — the
    fleet server stamps ``{"fleet": {"cluster_id": ...}}`` so a
    tenant's checkpoint directory is self-identifying.  Keys must not
    collide with the reserved encoder/policy meta; collisions raise.
    The MANIFEST protocol (staging, previous/ rotation, digest
    verification) is unchanged.

    Multi-cycle serving rides the same seam: serve.py stamps
    ``{"multicycle": {"k", "waves_inflight", "last_retired_cycle"}}``
    (SchedulerLoop.multicycle_meta()).  Usage commits only at wave
    RETIRE, so the ledger here never contains a dispatched-but-
    unretired wave — a mid-window crash restores to
    ``last_retired_cycle`` by construction, and the unretired waves'
    pods re-arrive Pending through the informer resync.  Optional
    key, read via .get: no format bump."""
    os.makedirs(path, exist_ok=True)
    with encoder._lock:
        # Deep copies under the lock: serialization happens after the
        # lock is released, and live ingest threads (scrape pool /
        # probe orchestrator) may keep writing the staging arrays — a
        # reference snapshot would tear mid-savez.
        arrays = {name.lstrip("_"): getattr(encoder, name).copy()
                  for name in _STATE_ARRAYS}
        meta = {
            "format_version": FORMAT_VERSION,
            "config": config_to_dict(encoder.cfg),
            "node_names": list(encoder._node_names),
            # Raw label sets per node index (lazy interning: the bit
            # arrays only carry selector-referenced labels; the raw
            # strings are needed so future selectors can backfill).
            "node_labels": {
                str(idx): sorted(labels)
                for idx, labels in encoder._node_labels.items()},
            "interners": {
                "labels": dict(encoder.labels._bits),
                "taints": dict(encoder.taints._bits),
                "groups": dict(encoder.groups._bits),
            },
            # Usage ledger: without it a restored daemon could not
            # release usage for pods bound before the restart.  The
            # commit stamp is not persisted — pre-restart commits are
            # by definition older than any post-restart listing.
            "committed": {
                uid: [rec.node, [float(x) for x in rec.req],
                      rec.priority, rec.namespace, rec.name,
                      int(rec.group_bit), int(rec.anti_bits),
                      int(rec.pdb_min), int(rec.group_slot),
                      int(rec.zone), int(rec.zanti_bits),
                      int(rec.member_bits),
                      (sorted(rec.labels) if rec.labels is not None
                       else None),
                      rec.gang_key]
                for uid, rec in encoder._committed.items()
            },
            # Gangs inside their assume->bind window at snapshot time:
            # restore ROLLS THESE BACK (all-or-nothing must hold
            # across a crash — the bind outcome is unknown, and a
            # half-bound gang resurrected from the ledger would
            # violate the atomicity invariant).  Optional key, read
            # via .get: no format bump needed.
            "gangs_inflight": {
                key: [list(e) for e in entries]
                for key, entries in encoder._inflight_gangs.items()},
            # Live migrations inside their evict->rebind window
            # (core/rebalance.py): restore rolls back the TARGET
            # commits of every member so a crashed move lands
            # fully-reverted, never half-evicted.  Optional key, read
            # via .get: no format bump needed, pre-r12 checkpoints
            # load unchanged.
            "migrations_inflight": {
                key: [list(e) for e in entries]
                for key, entries in
                encoder._inflight_migrations.items()},
            # Elastic reshapes inside their evict->re-pin window
            # (r17): restore settles the gang to fully-the-old-shape
            # (rolls back every affected member; resync re-places the
            # gang as a unit) — never a hybrid realization.  Optional
            # key, read via .get: no format bump needed, pre-r17
            # checkpoints load unchanged.
            "reshapes_inflight": {
                key: [v[0], v[1], [list(e) for e in v[2]]]
                for key, v in encoder._inflight_reshapes.items()},
            # Committed realization per shaped gang ([chosen_count,
            # declared_count]) — tools/state_audit.py cross-checks it
            # against the committed member placements.  Optional key.
            "gang_realizations": {
                key: list(v)
                for key, v in encoder._gang_realizations.items()},
            # Zone interner (topology-spread domains).
            "zones": dict(encoder._zone_index),
            # Numeric-label columns (v5): Gt/Lt key -> column of
            # _node_numeric.
            "numeric_keys": dict(encoder._numeric_keys),
            # Selector-group registry (v5): group key -> canonical
            # labelSelector structure, as nested lists.
            "selector_defs": {
                key: [[list(p) for p in ml],
                      [[op, k2, list(vals)] for op, k2, vals in exprs]]
                for key, (ml, exprs)
                in encoder._selector_defs.items()},
        }
    if policy is not None:
        meta["policy"] = {
            "version": int(policy.version),
            "promoted_version": int(policy.promoted_version),
            "last_promotion": policy.last_promotion,
        }
    if extra_meta:
        clash = set(extra_meta) & set(meta)
        if clash:
            raise ValueError(
                f"extra_meta keys collide with reserved checkpoint "
                f"meta: {sorted(clash)}")
        meta.update(extra_meta)
    # Staged commit: every payload file is written to .staging/
    # first, the CURRENT good set is preserved under previous/, the
    # payload files rename into place, and the MANIFEST rename is the
    # single commit point.  A crash anywhere leaves either the old
    # committed set intact or a digest mismatch restore detects and
    # falls back from — never a torn mixed-version window.
    staging = os.path.join(path, _STAGING_DIR)
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    with open(os.path.join(staging, "state.npz"), "wb") as fh:
        np.savez_compressed(fh, **arrays)
    with open(os.path.join(staging, "meta.json"), "w",
              encoding="utf-8") as fh:
        json.dump(meta, fh, indent=2)
    payload = ["state.npz", "meta.json"]
    # Learned topology model: beside the encoder state, so restarts
    # resume learning.  Written only when attached; a stale file from a
    # since-detached model is dropped from the manifest and removed
    # post-commit so restore cannot resurrect it.
    if encoder.netmodel is not None:
        encoder.netmodel.save(os.path.join(staging, "netmodel.npz"))
        payload.append("netmodel.npz")
    # Learned scoring policy: same attach-only discipline.
    if policy is not None:
        policy.save(os.path.join(staging, "policy.npz"))
        payload.append("policy.npz")
    manifest = {
        "format_version": FORMAT_VERSION,
        "files": {name: _sha256_file(os.path.join(staging, name))
                  for name in payload},
    }
    with open(os.path.join(staging, MANIFEST), "w",
              encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=2)
    # Preserve the current committed set — only if it verifies (a torn
    # current set must not overwrite an older good previous/).  Copies,
    # not renames: a crash mid-rotation must leave the committed set in
    # place, and a torn previous/ is detected by ITS manifest (copied
    # last).
    if verify_manifest(path) == []:
        prev = os.path.join(path, PREVIOUS_DIR)
        os.makedirs(prev, exist_ok=True)
        with open(os.path.join(path, MANIFEST),
                  encoding="utf-8") as fh:
            cur_files = list(json.load(fh)["files"])
        for name in cur_files:
            tmp = os.path.join(prev, name + ".tmp")
            shutil.copy2(os.path.join(path, name), tmp)
            os.replace(tmp, os.path.join(prev, name))
        tmp = os.path.join(prev, MANIFEST + ".tmp")
        shutil.copy2(os.path.join(path, MANIFEST), tmp)
        os.replace(tmp, os.path.join(prev, MANIFEST))
    # Commit: payload first, manifest LAST.
    for name in payload:
        os.replace(os.path.join(staging, name),
                   os.path.join(path, name))
    os.replace(os.path.join(staging, MANIFEST),
               os.path.join(path, MANIFEST))
    # A learned layer's file from an earlier save is off the new
    # manifest when its layer is gone; remove it so restore cannot
    # resurrect it.
    for stale in ("netmodel.npz", "policy.npz"):
        if stale not in payload and os.path.exists(
                os.path.join(path, stale)):
            os.remove(os.path.join(path, stale))
    shutil.rmtree(staging, ignore_errors=True)


def load_checkpoint(path: str,
                    cfg: SchedulerConfig | None = None,
                    settle_inflight: bool = True,
                    device="cuda") -> Encoder:
    """Reconstruct an :class:`Encoder` from :func:`save_checkpoint`
    output.  ``cfg`` overrides the checkpointed config (shapes must
    match the stored arrays).  ``settle_inflight=False`` skips the
    gang/migration rollback passes and restores the ledger EXACTLY as
    written — the offline auditor's pristine read (a restore that will
    actually serve must keep the default and settle).  The encoder is
    built on ``device``.

    Restore resolves through the r10 MANIFEST: a committed set whose
    digests verify loads as-is; a torn/corrupted set falls back to the
    ``previous/`` good set; if neither verifies the load REFUSES
    (:class:`ValueError`) rather than deserialize garbage into hard
    allocation constraints.  Legacy checkpoints (no manifest) load
    exactly as before.  A config that wants the learned topology model
    (``enable_netmodel``) gets it from ``netmodel.npz`` when the set
    carries one, on the encoder's device."""
    path = resolve_checkpoint_dir(path)
    with open(os.path.join(path, "meta.json"), encoding="utf-8") as fh:
        meta = json.load(fh)
    if meta.get("format_version") not in _ACCEPTED_VERSIONS:
        raise ValueError(
            f"unsupported checkpoint format "
            f"{meta.get('format_version')} (this build reads "
            f"{_ACCEPTED_VERSIONS}; pre-v6 group keys predate "
            "namespace scoping and cannot be restored faithfully — "
            "start fresh, the ledger rebuilds from the API server)")
    stored_cfg = config_from_dict(meta["config"])
    cfg = cfg or stored_cfg
    if (cfg.max_nodes, cfg.num_metrics, cfg.num_resources,
            cfg.mask_words) != (
            stored_cfg.max_nodes, stored_cfg.num_metrics,
            stored_cfg.num_resources, stored_cfg.mask_words):
        raise ValueError(
            "config shapes do not match checkpoint: "
            f"{(cfg.max_nodes, cfg.num_metrics, cfg.num_resources, cfg.mask_words)} vs "
            f"{(stored_cfg.max_nodes, stored_cfg.num_metrics, stored_cfg.num_resources, stored_cfg.mask_words)}")
    enc = Encoder(cfg, device=device)
    with np.load(os.path.join(path, "state.npz")) as data:
        for name in _STATE_ARRAYS:
            if name.lstrip("_") not in data:
                # v6 writes every array; a file missing one is corrupt
                # and must fail loudly, not restore hard constraints
                # against silently-empty state.  (The pre-v6
                # missing-array tolerances died with their versions.)
                raise ValueError(
                    f"checkpoint state.npz is missing array {name!r}")
            stored = data[name.lstrip("_")]
            target = getattr(enc, name)
            if stored.shape != target.shape:
                raise ValueError(
                    f"checkpoint array {name} has shape {stored.shape}, "
                    f"expected {target.shape}")
            target[...] = stored
    enc._node_names = list(meta["node_names"])
    # "" entries are tombstones of removed nodes: not indexable, and
    # their slots go back on the free list (order preserved).
    enc._node_index = {n: i for i, n in enumerate(enc._node_names) if n}
    enc._free_slots = [i for i, n in enumerate(enc._node_names) if not n]
    # Generations/stamps are process-local guards (in-flight cycles,
    # reconcile races) — a fresh process has neither, so zeros suffice.
    enc._node_gen = [0] * len(enc._node_names)
    enc._node_stamp = [0.0] * len(enc._node_names)
    for attr, table in meta["interners"].items():
        getattr(enc, attr)._bits = {k: int(v) for k, v in table.items()}
    enc._zone_index = {k: int(v)
                       for k, v in meta.get("zones", {}).items()}
    for idx_s, labels in meta.get("node_labels", {}).items():
        idx = int(idx_s)
        enc._node_labels[idx] = frozenset(labels)
        for s in labels:
            enc._label_nodes.setdefault(s, set()).add(idx)
    from kubernetesnetawarescheduler_tpu_torch.core.encode import CommitRecord

    def _rec(entry) -> CommitRecord:
        idx, req = entry[0], entry[1]
        prio = float(entry[2]) if len(entry) > 2 else 0.0
        ns = entry[3] if len(entry) > 3 else "default"
        name = entry[4] if len(entry) > 4 else ""
        gbit = int(entry[5]) if len(entry) > 5 else 0
        abits = int(entry[6]) if len(entry) > 6 else 0
        pdb = int(entry[7]) if len(entry) > 7 else 0
        gslot = int(entry[8]) if len(entry) > 8 else -1
        zone = int(entry[9]) if len(entry) > 9 else -1
        zanti = int(entry[10]) if len(entry) > 10 else 0
        member = int(entry[11]) if len(entry) > 11 else 0
        # Pre-v5 entries (or null): labels unknown — never re-claim.
        labels = (frozenset(entry[12])
                  if len(entry) > 12 and entry[12] is not None
                  else None)
        gang_key = str(entry[13]) if len(entry) > 13 and entry[13] else ""
        return CommitRecord(int(idx), np.asarray(req, np.float32), 0.0,
                            prio, ns, name, gbit, abits, pdb,
                            group_slot=gslot, zone=zone,
                            zanti_bits=zanti, member_bits=member,
                            labels=labels, gang_key=gang_key)

    enc._committed = {uid: _rec(entry)
                      for uid, entry in meta.get("committed", {}).items()}
    # Selector-group registry (v5; absent pre-v5).
    enc._selector_defs = {
        key: (tuple((str(k2), str(v)) for k2, v in ml),
              tuple((str(op), str(k2), tuple(str(x) for x in vals))
                    for op, k2, vals in exprs))
        for key, (ml, exprs)
        in meta.get("selector_defs", {}).items()}
    enc._selector_gen = len(enc._selector_defs)
    enc._numeric_keys = {k: int(v) for k, v
                         in meta.get("numeric_keys", {}).items()}
    # Group/anti refcounts and cluster-wide member counts are derived
    # state: rebuild from the ledger (member_bits when present, the
    # legacy single group_bit otherwise).
    for rec in enc._committed.values():
        member = rec.member_bits or rec.group_bit
        if member:
            enc._ref_add(enc._group_refs, rec.node, member)
            m = member
            while m:
                b = m & -m
                m ^= b
                enc._group_member_counts[b.bit_length() - 1] += 1
        if rec.anti_bits:
            enc._ref_add(enc._anti_refs, rec.node, rec.anti_bits)
        if rec.zanti_bits and rec.zone >= 0:
            enc._ref_add(enc._az_anti_refs, rec.zone, rec.zanti_bits)
    # Bits set in the restored arrays with NO ledger member (ledger
    # entries written before group bits were persisted) get a phantom
    # +1 so a later same-group commit+release cycle cannot clear a bit
    # whose pre-upgrade member may still be running — sticky-
    # conservative, exactly the pre-refcount behavior for those bits.
    for refs, bit_arr, rows in (
            (enc._group_refs, enc._group_bits, len(enc._node_names)),
            (enc._anti_refs, enc._resident_anti, len(enc._node_names)),
            (enc._az_anti_refs, enc._az_anti, enc._az_anti.shape[0])):
        for row in range(rows):
            unaccounted = words_to_int(bit_arr[row])
            while unaccounted:
                b = unaccounted & -unaccounted
                pos = b.bit_length() - 1
                if refs[row, pos] == 0:
                    refs[row, pos] = 1
                unaccounted ^= b
    # Gangs that were inside their assume->bind window when the
    # checkpoint was taken: the bind's outcome is unknown (the process
    # died holding it), so the all-or-nothing contract says ROLL BACK
    # every member — deterministically, via the same ledger-driven
    # release the live rollback path uses (refcounts above are already
    # rebuilt, so _release_record reverses them consistently).  The
    # members' pods are still Pending on the API server and re-arrive
    # through the informer's initial resync to re-gate.
    if settle_inflight:
        for key, entries in meta.get("gangs_inflight", {}).items():
            enc.rollback_gang_members(e[0] for e in entries)
    # Live migrations inside their evict->rebind window (optional
    # key, pre-r12 checkpoints carry none): the move's outcome is
    # unknown, so revert it whole — pop every member's TARGET commit
    # (the rebalancer pins the target before eviction completes) and
    # let the informer resync re-place the gang as a unit.  Either
    # every member re-binds (the move had already completed and the
    # members are Bound — rollback then strands nothing because
    # resync re-commits from the API server's truth) or none do;
    # never a half-moved gang (tests/test_rebalance.py chaos drill).
    if settle_inflight:
        for key, entries in meta.get("migrations_inflight", {}).items():
            enc.rollback_gang_members(e[0] for e in entries)
    # Committed realizations per shaped gang (r17, optional key).
    enc._gang_realizations = {
        key: [int(v[0]), int(v[1])]
        for key, v in meta.get("gang_realizations", {}).items()
        if isinstance(v, (list, tuple)) and len(v) >= 2}
    # Elastic reshapes inside their evict->re-pin window (r17,
    # optional key): the reshape's outcome is unknown, so settle the
    # gang WHOLE — pop every affected member's commit (targets the
    # reshape may have pinned, sources it may not have evicted yet)
    # and drop the realization record; the informer resync re-places
    # the gang as a unit at whichever shape is then feasible.  Either
    # way the restored ledger holds fully-the-old-shape or
    # fully-the-new-shape via resync — NEVER a hybrid (zero
    # half-shaped gangs, the r17 chaos drill's invariant).
    if settle_inflight:
        for key, v in meta.get("reshapes_inflight", {}).items():
            entries = v[2] if len(v) > 2 else []
            enc.rollback_gang_members(e[0] for e in entries)
            enc._gang_realizations.pop(key, None)
    # Multi-cycle provenance (optional): the ledger already holds
    # only RETIRED waves (commit-at-retire), so there is nothing to
    # settle — but a checkpoint taken mid-window names its restore
    # point, and saying so out loud makes the "lands on the last
    # retired cycle" contract auditable in restore logs.
    mc = meta.get("multicycle")
    if isinstance(mc, dict) and mc.get("waves_inflight"):
        import sys

        print(f"checkpoint taken mid multicycle window "
              f"(K={mc.get('k')}, {mc.get('waves_inflight')} waves "
              f"unretired): restoring to last retired cycle "
              f"{mc.get('last_retired_cycle')}; unretired waves' pods "
              "re-arrive Pending via resync", file=sys.stderr)
    # Learned topology model: restore beside the encoder when the
    # config wants one and the checkpoint carries it.  A shape mismatch
    # (dims/rank/max_nodes changed) starts the model fresh rather than
    # failing the whole restore — the encoder state is still good.
    npz = os.path.join(path, "netmodel.npz")
    if cfg.enable_netmodel and os.path.exists(npz):
        from kubernetesnetawarescheduler_tpu_torch.netmodel import (
            TopologyModel,
        )

        try:
            enc.attach_netmodel(TopologyModel.load(npz, cfg,
                                                   device=enc.device))
        except ValueError as exc:
            import sys

            print(f"WARNING: netmodel checkpoint not restored: {exc}; "
                  "starting with a fresh model", file=sys.stderr)
            enc.attach_netmodel(TopologyModel(cfg, device=enc.device))
    # Everything is freshly loaded: first snapshot() must upload all.
    for key in enc._dirty:
        enc._dirty[key] = True
    return enc


def load_policy(path: str, cfg: SchedulerConfig, seed: int = 0,
                device="cuda"):
    """Restore the learned scoring policy saved beside the encoder
    state, on ``device``.  Returns None when the config does not want
    one or the checkpoint carries none; a shape mismatch (explain_top_k
    / max_zones / policy_ring changed) starts the policy fresh rather
    than failing — same degradation contract as the netmodel
    restore."""
    if not cfg.enable_learned_score:
        return None
    path = resolve_checkpoint_dir(path)
    npz = os.path.join(path, "policy.npz")
    if not os.path.exists(npz):
        return None
    from kubernetesnetawarescheduler_tpu_torch.policy import ScoringPolicy

    try:
        return ScoringPolicy.load(npz, cfg, seed=seed, device=device)
    except ValueError as exc:
        import sys

        print(f"WARNING: policy checkpoint not restored: {exc}; "
              "starting with a fresh policy", file=sys.stderr)
        return ScoringPolicy(cfg, seed=seed, device=device)


def replay_decisions(encoder: Encoder, pods: Sequence,
                     cfg: SchedulerConfig,
                     method: str = "parallel") -> DecisionLog:
    """Deterministically re-run the scheduling of ``pods`` against a
    (restored) encoder state, recording decisions.  Used by tests and
    the benchmark replay harness to prove restart-determinism — the
    property the reference cannot have (its scoring depends on live
    scrapes at call time, scheduler.go:275-279)."""
    from kubernetesnetawarescheduler_tpu_torch.core.assign import (
        assign_greedy,
        assign_parallel,
    )
    from kubernetesnetawarescheduler_tpu_torch.core.state import (
        commit_assignments,
    )

    assign = {"greedy": assign_greedy, "parallel": assign_parallel}[method]
    log = DecisionLog()
    state = encoder.snapshot()
    placed_node: dict[str, str] = {}

    def node_of(name: str) -> str:
        return placed_node.get(name, "")

    for i in range(0, len(pods), cfg.max_pods):
        chunk = list(pods[i:i + cfg.max_pods])
        batch = encoder.encode_pods(chunk, node_of=node_of)
        assignment_dev = assign(state, batch, cfg)
        state = commit_assignments(state, batch, assignment_dev)
        assignment = assignment_dev.cpu().numpy()
        placed_pods, placed_idx = [], []
        for j, pod in enumerate(chunk):
            idx = int(assignment[j])
            node = encoder.node_name(idx) if idx >= 0 else ""
            if node:
                placed_node[pod.name] = node
                placed_pods.append(pod)
                placed_idx.append(idx)
            log.append(pod.name, node)
        # Mirror the live loop's ENCODER-side commits (bind →
        # encoder.commit): encode-time state — group member counts
        # behind the first-pod affinity waiver, selector memberships —
        # must evolve identically or the replayed decisions diverge
        # from the live log.  Device-side scoring still reads the
        # locally-threaded `state`, so this cannot double-count usage.
        if placed_pods:
            encoder.commit_many(placed_pods, placed_idx)
    return log
