"""Cycle arguments for the one-call solver (``parallel.sharded``).

Only ``cycle_args`` is ported; the JAX package's mesh functions
(``make_mesh``, ``sharded_cycle_fn``, ``admit_scan_fns``, ``fs_scan_fn``,
``sharded_burst_fn``) exist only across devices and are not here yet
(ROADMAP Queue 1 item 9)."""

from .sharded import cycle_args

__all__ = ["cycle_args"]
