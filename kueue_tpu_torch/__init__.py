"""kueue_tpu_torch: the PyTorch/CUDA port of kueue_tpu.

Kueue's quota-based admission of gang workloads across hierarchical
cohorts of ClusterQueues, with its device programs — the admit scans and
the batched preemption search of each cycle, the fused burst, fair
sharing, topology-aware placement and the one-call cycle solver
(``ops.cycle.solve_cycle``, ``probe``) — as hand-written CUDA kernels
for an NVIDIA H100 (sm_90a).  The host plane (cache, queues, scheduler,
driver) is the JAX package's code, carried over unchanged; the device
plane (``ops``, ``kernels``) is rewritten in PyTorch.  This package never
imports JAX or kueue_tpu.

``controller.driver.Driver()`` runs on the card by default
(``device="cuda"``, raising when no GPU is present); ``device="cpu"``
runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
