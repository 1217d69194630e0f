"""Kubernetes boundary: API object types and cluster clients.

The PyTorch package's own copies of the JAX package's ``k8s/types.py``
(:class:`~.types.Node`, :class:`~.types.Pod`, :class:`~.types.Binding`
and the rest), ``k8s/client.py`` (the abstract
:class:`~.client.ClusterClient` and the in-memory
:class:`~.client.FakeCluster` used by tests and benchmarks),
``k8s/informer.py``, ``k8s/kubeclient.py`` (the HTTP API-server client)
and ``k8s/conformance.py`` (the wire-contract schemas).  The chaos proxy
(``k8s/chaos.py``) is not ported yet.
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
