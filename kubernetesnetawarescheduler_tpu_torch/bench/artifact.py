"""Shared artifact writer for every bench-suite leg.

The PyTorch package's copy of the JAX package's ``bench/artifact.py``:
stamp the provenance block (``detail.bench_env``) at write time, one
dump shape (indent=2, UTF-8), and the path appended to the caller's
artifact list in the same call.
"""

from __future__ import annotations

import json
import os

from kubernetesnetawarescheduler_tpu_torch.bench.envinfo import bench_env


def stamp_provenance(doc: dict) -> dict:
    """Ensure ``doc.detail.bench_env`` is present and non-empty.  A leg
    that already stamped a fresher env block keeps it."""
    detail = doc.setdefault("detail", {})
    if not detail.get("bench_env"):
        detail["bench_env"] = bench_env()
    return doc


def write_artifact(out_dir: str | None, filename: str, doc: dict,
                   artifacts: list[str] | None = None) -> str | None:
    """Stamp provenance and persist ``doc`` as
    ``<out_dir>/<filename>``; returns the path (None when ``out_dir``
    is None — smoke callers that want the doc but no file).  When
    ``artifacts`` is given the path is appended to it, matching the
    ``SuiteResult.artifacts`` convention."""
    stamp_provenance(doc)
    if out_dir is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
    if artifacts is not None:
        artifacts.append(path)
    return path
