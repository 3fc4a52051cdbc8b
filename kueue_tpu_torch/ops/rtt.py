"""The round-trip probe: eight distinct int32 uploaded to a device, ``x + 1``
launched there (``kernels/probe.cu`` on a card, its plain version on the
CPU) and the result read back — the JAX solver's
``jax.jit(lambda x: x + 1)`` probe (kueue_tpu/ops/solver.py:367), whose
input is eight zeros; distinct values let a readback that is not
``x + 1`` show.  The solver's warm-up (``CycleSolver.rtt_s``) and the
roofline twin (``accel_roofline.measure_rtt``) both time this one copy."""

from __future__ import annotations

import time

import numpy as np
import torch

PROBE = np.arange(8, dtype=np.int32)


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` on int32 (wrapping at the int32 limit, as XLA's add)."""
    return x + 1


def add_one(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU
    one; any other device raises."""
    if x.device.type == "cuda":
        from .. import kernels
        return kernels.kq_add_one(x)
    if x.device.type != "cpu":
        raise ValueError(f"no add-one kernel for device {x.device}")
    return add_one_plain(x)


def round_trip(device) -> np.ndarray:
    """One probe: upload, launch, readback → the result on the host; a
    result other than ``PROBE + 1`` raises."""
    got = add_one(torch.from_numpy(PROBE).to(device)).cpu().numpy()
    if not np.array_equal(got, PROBE + 1):
        raise RuntimeError(f"round-trip probe read back {got.tolist()}, "
                           f"not {(PROBE + 1).tolist()}")
    return got


def round_trip_s(device) -> float:
    """Wall seconds of one probe after an untimed one (the first launch
    pays the module load and the allocator's first block)."""
    round_trip(device)
    t0 = time.perf_counter()
    round_trip(device)
    return time.perf_counter() - t0
