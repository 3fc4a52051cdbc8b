"""Device meshes and the sharded programs (``parallel.sharded``).

The per-cycle mesh: ``make_mesh`` / ``make_hybrid_mesh`` build a 2-D
(wl, cq) mesh, ``cycle_args`` gives the one-call solver's planes and
``sharded_cycle_fn`` runs it over the mesh, as the JAX package's
``parallel`` exports them; ``CycleSolver.set_mesh`` routes the
production admit scans and the fair-sharing scan through
``admit_scan_fns`` / ``fs_scan_fn``.  The forest-sharded burst:
``make_burst_mesh``, ``BurstShardLayout`` and ``sharded_burst``.  Both
partition whole cohort forests over the ``cq`` axis; ``virtual_mesh``
(tests and ``chip_smoke.py`` only) repeats one device."""

from .sharded import (BurstShardLayout, cycle_args, make_burst_mesh,
                      make_hybrid_mesh, make_mesh, sharded_burst,
                      sharded_cycle_fn, virtual_mesh)

__all__ = ["BurstShardLayout", "cycle_args", "make_burst_mesh",
           "make_hybrid_mesh", "make_mesh", "sharded_burst",
           "sharded_cycle_fn", "virtual_mesh"]
