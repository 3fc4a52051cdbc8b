"""The positional arguments of ``ops.cycle.solve_cycle`` from a packed
cycle: the twin of the JAX package's ``parallel/sharded.py`` ``cycle_args``
(:51-57).  The mesh wrappers of that module are multi-device only and not
ported (ROADMAP Queue 1 item 9)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.packing import PackedCycle


def cycle_args(packed: PackedCycle, device="cuda") -> tuple:
    """The 14 planes of ``solve_cycle``, in signature order, as tensors on
    ``device`` ("cuda" by default: raises without a GPU).  The float64
    timestamp becomes float32, as the JAX jit boundary makes it."""
    from ..ops.solver import resolve_device
    dev = resolve_device(device)
    arrays = (packed.usage0, packed.subtree_quota, packed.guaranteed,
              packed.borrow_cap, packed.has_borrow_limit, packed.parent,
              packed.nominal_cq, packed.slot_fr, packed.slot_valid,
              packed.cq_can_preempt_borrow, packed.wl_cq,
              packed.wl_requests, packed.wl_priority,
              np.asarray(packed.wl_timestamp, dtype=np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)
