"""Kubernetes boundary: API object types and cluster clients.

The PyTorch package's own copies of the JAX package's ``k8s/types.py``
(:class:`~.types.Node`, :class:`~.types.Pod`, :class:`~.types.Binding`
and the rest) and of ``k8s/client.py`` (the abstract
:class:`~.client.ClusterClient` and the in-memory
:class:`~.client.FakeCluster` used by tests and benchmarks).  The
informer, the HTTP kube client, the chaos proxy and the conformance
suite follow with the scheduling loop.
"""

from kubernetesnetawarescheduler_tpu_torch.k8s.types import (  # noqa: F401
    Binding,
    Event,
    Node,
    Pod,
)
from kubernetesnetawarescheduler_tpu_torch.k8s.client import (  # noqa: F401
    ClusterClient,
    FakeCluster,
)
