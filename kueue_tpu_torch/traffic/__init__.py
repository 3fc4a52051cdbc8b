"""Open-loop traffic subsystem: seeded arrival processes + runner.

``arrivals`` generates replayable, deterministic workload event streams
(submissions, cancellations, priority churn) from Poisson / diurnal /
bursty-MMPP arrival processes; ``runner`` feeds them into
``Driver.schedule_once`` at a target rate and measures admission
latency, queue-depth growth, and requeue storms, with a binary-search
mode for the sustainable rate at a fixed p99 SLO.
"""

from .arrivals import (
    ArrivalStream,
    DiurnalProcess,
    MMPPProcess,
    PoissonProcess,
    ReplayStream,
    TrafficEvent,
    TrafficSpec,
)
from .runner import (
    OpenLoopConfig,
    OpenLoopResult,
    RateEWMA,
    find_sustainable_rate,
    run_open_loop,
)

__all__ = [
    "ArrivalStream",
    "DiurnalProcess",
    "MMPPProcess",
    "PoissonProcess",
    "ReplayStream",
    "TrafficEvent",
    "TrafficSpec",
    "OpenLoopConfig",
    "OpenLoopResult",
    "RateEWMA",
    "find_sustainable_rate",
    "run_open_loop",
]
