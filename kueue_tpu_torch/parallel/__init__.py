"""Cycle arguments for the one-call solver and the forest-sharded burst
(``parallel.sharded``).

Ported: ``cycle_args``; the burst mesh (``make_burst_mesh``, with the
``virtual_mesh`` hook that tests and ``chip_smoke.py`` set),
``BurstShardLayout`` and ``sharded_burst`` with its two kernels'
routed functions.  The JAX package's per-cycle mesh functions
(``make_mesh``, ``sharded_cycle_fn``, ``admit_scan_fns``,
``fs_scan_fn``, ``make_hybrid_mesh``) are the next slice (ROADMAP Queue
1 item 9)."""

from .sharded import (BurstShardLayout, cycle_args, make_burst_mesh,
                      sharded_burst, virtual_mesh)

__all__ = ["BurstShardLayout", "cycle_args", "make_burst_mesh",
           "sharded_burst", "virtual_mesh"]
