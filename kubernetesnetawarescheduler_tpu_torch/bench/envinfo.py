"""Shared bench-environment fingerprint for every emitted artifact.

The PyTorch package's copy of the JAX package's ``bench/envinfo.py``,
with the same output shape: every benchmark JSON carries a
``bench_env`` block so a number can be traced to the machine and tree
that produced it.  ``platform`` names the torch device this process
computes on instead of a JAX backend.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def git_sha(repo_dir: str | None = None) -> str:
    """Short commit sha of the tree that produced the run ('' outside
    a checkout or without git)."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def accel_platform() -> str:
    """The device the producing process computed on: ``'gpu'`` once
    CUDA is initialised in it, else ``'cpu'``.  Only consults an
    already-imported torch, and never initialises CUDA itself."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "cpu"
    try:
        return "gpu" if torch.cuda.is_initialized() else "cpu"
    except Exception:  # noqa: BLE001 — a fingerprint never fails a run
        return "cpu"


def bench_env() -> dict:
    """{host, cpu_count, loadavg_1m, platform, git_sha} — the
    provenance block every bench artifact embeds as ``bench_env``."""
    try:
        load1 = round(os.getloadavg()[0], 2)
    except OSError:  # platforms without getloadavg
        load1 = -1.0
    return {
        "host": socket.gethostname(),
        "cpu_count": os.cpu_count() or 0,
        "loadavg_1m": load1,
        "platform": accel_platform(),
        "git_sha": git_sha(),
    }
