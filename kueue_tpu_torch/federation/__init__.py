"""Federation robustness layer: the N-worker-cluster MultiKueue
simulation driven by ``scripts/federation_soak.py`` and the
``tests/test_federation.py`` parity suite."""

from .sim import (
    FederationSim,
    FedSpec,
    VirtualClock,
    full_state,
    global_digest,
    global_state,
    outcome,
    schedule_traffic,
)

__all__ = [
    "FederationSim",
    "FedSpec",
    "VirtualClock",
    "full_state",
    "global_digest",
    "global_state",
    "outcome",
    "schedule_traffic",
]
