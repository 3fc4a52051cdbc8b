"""Persistent packed-plane arena with slab-doubling growth.

The streaming burst pack (ops/stream_pack.py) patches a persistent
copy of the dense ``[C, M]`` packed universe in place instead of
rebuilding it every window.  The arena owns the backing slabs: each
named plane lives in a buffer whose leading (row-ish) dimensions are
rounded up to powers of two, so C and M can grow across structure
generations without reallocating — and, downstream, without changing
the plan shapes the XLA kernel was compiled for more often than the
sticky-``M`` bucketing already does.

Growth policy: when ``ensure`` asks for a shape that exceeds a slab's
capacity along any axis, the slab is reallocated at the next power of
two per overflowing axis (doubling amortizes to O(1) per row ever
stored), the live region is copied over and the new territory is
filled with the plane's pad value.  Shrink never happens — a smaller
request just views a prefix of the slab, so transient peaks don't
cause realloc churn.

The arena also keeps the occupancy/growth counters surfaced as
``kueue_pack_arena_*`` gauges.
"""

from __future__ import annotations

import numpy as np


def _cap(n: int) -> int:
    """Slab capacity for a requested extent: next power of two ≥ n
    (min 4, so early growth doesn't realloc every other row)."""
    c = 4
    while c < n:
        c <<= 1
    return c


class PlaneArena:
    """Named persistent plane slabs; see module docstring."""

    def __init__(self):
        self._slabs: dict[str, np.ndarray] = {}
        self._fills: dict[str, object] = {}
        self.stats = {"arena_growth_events": 0, "arena_planes": 0,
                      "arena_bytes": 0, "arena_used_bytes": 0}

    def drop(self) -> None:
        """Forget every slab (structure change with new trailing axes)."""
        self._slabs.clear()
        self._fills.clear()

    def ensure(self, name: str, shape: tuple, dtype, fill,
               grow_axes: int = 2) -> np.ndarray:
        """Return a ``shape``-sized view of the named slab, growing (or
        creating) the slab as needed.  The first ``grow_axes`` axes get
        power-of-two capacity; trailing axes are exact — a trailing-axis
        or dtype mismatch (new structure with different R/F) drops and
        reallocates the slab.  New territory is filled with ``fill``."""
        shape = tuple(int(s) for s in shape)
        grow_axes = min(grow_axes, len(shape))
        slab = self._slabs.get(name)
        want = tuple(_cap(s) for s in shape[:grow_axes]) + shape[grow_axes:]
        if (slab is None or slab.dtype != np.dtype(dtype)
                or slab.ndim != len(shape)
                or slab.shape[grow_axes:] != shape[grow_axes:]):
            slab = np.full(want, fill, dtype=dtype)
            if name in self._slabs:
                self.stats["arena_growth_events"] += 1
            self._slabs[name] = slab
            self._fills[name] = fill
        elif any(slab.shape[i] < shape[i] for i in range(grow_axes)):
            cap = tuple(max(slab.shape[i], want[i])
                        for i in range(grow_axes)) + shape[grow_axes:]
            grown = np.full(cap, fill, dtype=dtype)
            grown[tuple(slice(0, s) for s in slab.shape)] = slab
            self._slabs[name] = slab = grown
            self.stats["arena_growth_events"] += 1
        return slab[tuple(slice(0, s) for s in shape)]

    def view(self, name: str, shape: tuple) -> np.ndarray:
        return self._slabs[name][tuple(slice(0, int(s)) for s in shape)]

    def refresh_stats(self, used_shapes: dict | None = None) -> dict:
        """Recompute the byte counters; ``used_shapes`` maps plane name
        → live view shape for the occupancy ratio."""
        total = sum(s.nbytes for s in self._slabs.values())
        used = 0
        if used_shapes:
            for name, shp in used_shapes.items():
                slab = self._slabs.get(name)
                if slab is None:
                    continue
                n = slab.dtype.itemsize
                for s in shp:
                    n *= int(s)
                used += n
        self.stats["arena_planes"] = len(self._slabs)
        self.stats["arena_bytes"] = int(total)
        self.stats["arena_used_bytes"] = int(used)
        return self.stats
