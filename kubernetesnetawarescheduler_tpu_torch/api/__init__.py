"""Service boundary: Score/Filter APIs for external schedulers.

The PyTorch package's copy of the JAX package's ``api/``.  Three
transports over one semantic core (:mod:`.extender`):

- :class:`~.server.ScorerServer` — length-prefixed frames over a unix
  domain socket; what the native shim (native/extender.cpp) speaks.  The
  frame format is byte-identical to the JAX package's, so the one shim
  binary fronts either package.
- :func:`~.grpc_server.serve_grpc` — the same ops over real gRPC
  (generic byte handlers, JSON payloads) for remote/DCN clients.
- The native ``netaware_extender`` binary — kube-scheduler's extender
  webhook (HTTP) relaying to the UDS server.

The scoring behind them runs on the card through the masked tile kernel
(``score_backend="pallas"``) or the dense torch path.
"""

from kubernetesnetawarescheduler_tpu_torch.api.extender import (  # noqa: F401
    ExtenderHandlers,
)
from kubernetesnetawarescheduler_tpu_torch.api.server import (  # noqa: F401
    ScorerServer,
)
