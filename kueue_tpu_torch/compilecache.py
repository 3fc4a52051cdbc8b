"""Persistent warm-up artifacts: the directory of the router's
calibration sidecar.

``CycleSolver.warmup`` measures the admit-scan routes per shape bucket
and writes the table as a JSON sidecar here; a later process on the same
machine, kernel sources and cluster shape loads it and skips the
measurement pass (the JAX package keeps its sidecar beside its XLA
compilation cache, ``kueue_tpu/compilecache.py``).

There is no XLA configuration here: the port's compiled kernels are the
CUDA library that ``kernels.build`` writes into ``.kueue_tpu_torch_build/``
at the repository root (rebuilt only when a source is newer), and that
build directory is the port's compile cache.  This module only names the
sidecar directory.

Enabled by default wherever a solver warms up; opt out with
``KUEUE_TPU_COMPILE_CACHE=0`` or point it elsewhere with
``KUEUE_TPU_COMPILE_CACHE=/path``; empty means ``~/.cache/kueue_tpu_torch``
(apart from the JAX package's ``~/.cache/kueue_tpu/xla``).
"""

from __future__ import annotations

import json
import os

from .features import env_value

_enabled_dir: str | None = None


def enable(cache_dir: str | None = None) -> str | None:
    """Idempotently create the sidecar directory.

    Returns the directory, or None when disabled via env."""
    global _enabled_dir
    env = env_value("KUEUE_TPU_COMPILE_CACHE")
    if env == "0":
        return None
    if _enabled_dir is not None:
        return _enabled_dir
    d = cache_dir or env or os.path.expanduser("~/.cache/kueue_tpu_torch")
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    _enabled_dir = d
    return d


def load_json(name: str, cache_dir: str | None = None):
    """Read a sidecar JSON artifact (e.g. the router calibration table)
    from the cache directory; None when absent/disabled."""
    d = cache_dir or enable()
    if d is None:
        return None
    try:
        with open(os.path.join(d, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def save_json(name: str, obj, cache_dir: str | None = None) -> bool:
    """Write a sidecar JSON artifact into the cache directory (atomic
    rename; best effort)."""
    d = cache_dir or enable()
    if d is None:
        return False
    try:
        tmp = os.path.join(d, f".{name}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, os.path.join(d, name))
        return True
    except OSError:
        return False
