"""Native (C++) solver-plane backend.

``classify_cycle(packed)`` runs the batched nominate/classify pass in the
compiled core (``cycle_core.cpp``, the JAX package's file unchanged) —
identical decisions to ``ops.cycle.solve_cycle(run_scan=False)`` and to
the scalar host oracle; ``admit_scan`` runs the sequential admit loop.
Both take and return numpy arrays.  The shared library is built with
``g++`` at first use into ``.kueue_tpu_torch_build/`` at the repository
root (git-ignored), never beside the source, and rebuilt when the source
is newer; a failed build raises ``NativeBuildError``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from ..kernels import build_dir

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cycle_core.cpp")
_LIB = str(build_dir() / "libcyclecore.so")

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _u8(a):
    return np.ascontiguousarray(a, dtype=np.uint8)


def _build() -> None:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"building cycle core failed: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"building cycle core failed: {proc.stderr[-2000:]}")
    os.replace(tmp, _LIB)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.classify_cycle.restype = None
        lib.classify_cycle.argtypes = (
            [ctypes.c_int32] * 6
            + [i32p, i32p, i32p, i32p, u8p, i32p, i32p, i32p, u8p, u8p,
               i32p, i32p]
            + [i32p, u8p, u8p])
        lib.admit_scan.restype = None
        lib.admit_scan.argtypes = (
            [ctypes.c_int32] * 5
            + [i32p, i32p, i32p, i32p, u8p, i32p, i32p, i32p,
               i32p, i32p, i32p, u8p, i32p, i32p, u8p, u8p, i32p]
            + [u8p])
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native backend can be used (g++ present or built)."""
    return os.path.exists(_LIB) or shutil.which("g++") is not None


def classify_cycle(packed):
    """Run the native classify over a PackedCycle.

    Returns (fit_slot0 [W] int32, borrows0 [W] bool, preempt [W] bool),
    matching ops/cycle.solve_cycle(..., run_scan=False) outputs 4-6.
    """
    lib = _load()
    N = packed.node_count
    C, S, R = packed.slot_fr.shape
    F = packed.usage0.shape[1]
    W = packed.wl_cq.shape[0]

    fit_slot = np.empty(W, dtype=np.int32)
    borrows = np.empty(W, dtype=np.uint8)
    preempt = np.empty(W, dtype=np.uint8)
    lib.classify_cycle(
        N, F, C, S, R, W,
        _i32(packed.usage0), _i32(packed.subtree_quota),
        _i32(packed.guaranteed), _i32(packed.borrow_cap),
        _u8(packed.has_borrow_limit), _i32(packed.parent),
        _i32(packed.nominal_cq), _i32(packed.slot_fr),
        _u8(packed.slot_valid), _u8(packed.cq_can_preempt_borrow),
        _i32(packed.wl_cq), _i32(packed.wl_requests),
        fit_slot, borrows, preempt)
    return fit_slot, borrows.astype(bool), preempt.astype(bool)


def admit_scan_raw(usage0, subtree_quota, guaranteed, borrow_cap,
                   has_borrow_limit, parent, nominal_cq, npb_cq,
                   wl_cq, dec_fr, dec_amt, fit_mask, res_fr, res_amt,
                   res_mask, res_borrows, order):
    """Array-level admit loop (same argument order as
    ``ops.cycle.admit_scan_plain``, numpy) → admitted [W] bool."""
    lib = _load()
    N, F = np.asarray(usage0).shape
    C = np.asarray(nominal_cq).shape[0]
    W, K = np.asarray(dec_fr).shape
    admitted = np.empty(W, dtype=np.uint8)
    lib.admit_scan(
        N, F, C, K, W,
        _i32(usage0), _i32(subtree_quota), _i32(guaranteed),
        _i32(borrow_cap), _u8(has_borrow_limit), _i32(parent),
        _i32(nominal_cq), _i32(npb_cq),
        _i32(wl_cq), _i32(dec_fr), _i32(dec_amt), _u8(fit_mask),
        _i32(res_fr), _i32(res_amt), _u8(res_mask), _u8(res_borrows),
        _i32(order), admitted)
    return admitted.astype(bool)


def admit_scan(packed, dec_fr, dec_amt, fit_mask, res_fr, res_amt,
               res_mask, res_borrows, order):
    """The sequential admit loop in the compiled core — identical
    decisions to ops/cycle.admit_scan (tests/test_torch_native.py).

    Decision inputs are the (flavor-resource, amount) pair arrays the
    solver builds (CycleSolver._build_pair_tensors).  Returns
    admitted [W] bool in head order."""
    st = packed.structure
    return admit_scan_raw(
        packed.usage0, packed.subtree_quota, packed.guaranteed,
        packed.borrow_cap, packed.has_borrow_limit, packed.parent,
        packed.nominal_cq, st.nominal_plus_blimit_cq,
        packed.wl_cq, dec_fr, dec_amt, fit_mask, res_fr, res_amt,
        res_mask, res_borrows, order)
