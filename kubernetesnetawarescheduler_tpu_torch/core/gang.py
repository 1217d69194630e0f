"""Gang scheduling: the gang identity of a pod.

The part of the JAX package's ``core/gang.py`` that the encoder needs at
import time: :func:`gang_key_of`, the ``namespace/pod-group`` key a
commit is recorded under.  The gate (``Gang``, ``GangRegistry``) and the
joint-scoring helpers (``gang_bias``, ``intra_gang_pair_score``) follow
with the scheduling loop (ROADMAP Queue A, item 8).
"""

from __future__ import annotations

from kubernetesnetawarescheduler_tpu_torch.k8s.types import Pod


def gang_key_of(pod: Pod) -> str:
    """Canonical gang identity, ``namespace/pod-group`` — or "" for
    pods that schedule independently (no group, or minMember <= 1:
    a gang of one is just a pod)."""
    group = getattr(pod, "pod_group", "") or ""
    if not group:
        return ""
    if int(getattr(pod, "gang_min_member", 0) or 0) <= 1:
        return ""
    return f"{getattr(pod, 'namespace', 'default') or 'default'}/{group}"
