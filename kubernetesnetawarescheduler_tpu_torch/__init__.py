"""PyTorch + CUDA port of the network-aware Kubernetes scheduler.

A package of its own beside ``kubernetesnetawarescheduler_tpu`` (the JAX
reference, which it never imports).  It holds the cluster-state tensors
(``core.state``), the dense score path (``core.score``), the
hand-written Hopper tile kernels and their host side (``core.kernels``,
``core.tiled_score``, ``csrc/tiled_score.cu``), batch-conflict
assignment (``core.assign``, its round as kernels in
``csrc/conflict_round.cu``), the replay (``core.replay``), the encoder
(``core.encode``), the scheduling loop (``core.loop``), the Score/Filter
webhook (``api``) and the daemon around it (``serve``,
``python -m kubernetesnetawarescheduler_tpu_torch``).

Entry points build on ``device="cuda"`` unless the caller asks for the
CPU; ``python3 chip_smoke.py`` at the repository root drives the whole
path on the card.
"""
