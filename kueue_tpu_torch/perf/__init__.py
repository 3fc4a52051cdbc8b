"""Performance harness (reference test/performance/scheduler).

Generator-config-driven scenario replay with fake workload execution,
stat collection, and a rangespec checker.
"""

from .harness import (
    PerfStats,
    check_rangespec,
    load_generator_config,
    run_scenario,
)

__all__ = ["PerfStats", "check_rangespec", "load_generator_config",
           "run_scenario"]
