"""Learned network-topology model (coordinate embedding + low-rank
bandwidth completion) over the budgeted probe stream.

The PyTorch package's copy of the JAX package's ``netmodel/``: the
parameters and the Adam step live on the model's device, the ring
buffer, the confidence state, the blend and the planner on the host.
See :mod:`.model` for the estimator and :mod:`.planner` for the
expected-information-gain probe planner."""

from kubernetesnetawarescheduler_tpu_torch.netmodel.model import (
    TopoParams,
    TopologyModel,
)
from kubernetesnetawarescheduler_tpu_torch.netmodel.planner import (
    EIGProbePlanner,
)

__all__ = ("TopoParams", "TopologyModel", "EIGProbePlanner")
