"""Hand-written CUDA kernels for Hopper (sm_90a) and their launchers.

The sources beside this file are compiled with ``nvcc`` at first use, one
``nvcc -c`` per source run in parallel and then one link, into
``libkueue_kernels.so`` in ``.kueue_tpu_torch_build/`` at the repository
root (git-ignored).  The library is
rebuilt when a source is newer than it.  It has a plain C interface (one
``extern "C"`` launch function per kernel that returns
``cudaGetLastError()``) and is loaded with ``ctypes``; arguments are
``tensor.data_ptr()`` values and the current stream, all passed as
``ctypes.c_void_p``.

Every launcher checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs and scratch with ``torch.empty``,
launches on the current stream without synchronizing, raises if the
launch status is not 0, and adds one to ``LAUNCHES[name]`` — nowhere
else is a count taken.  Each launch is bracketed by CUDA events;
``collect()`` folds the finished ones into ``DEVICE_MS``.

Nothing here is imported or built on a machine without CUDA unless a
launcher is called with CUDA tensors.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

KERNELS = ("admit_scan", "admit_scan_preempt", "admit_scan_forests",
           "minimal_preemptions_batch", "burst_cycles", "fs_admit_scan",
           "drs_components", "fill_counts", "best_fit_descend",
           "split_across_roots")
SOURCES = ("admit_scan.cu", "admit_scan_preempt.cu", "admit_scan_forests.cu",
           "minimal_preemptions.cu", "burst_cycles.cu", "fs_admit_scan.cu",
           "drs_components.cu", "tas_fill_counts.cu", "tas_descend.cu")
HEADERS = ("quota.cuh", "admit_entry.cuh", "tas.cuh")
MAX_DEPTH = 16          # KQ_MAX_DEPTH in quota.cuh
MAX_THREADS = 1024
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on H100
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
DEVICE_MS: dict[str, float] = dict.fromkeys(KERNELS, 0.0)
BUILD: dict = {"seconds": None, "library": None}

_SRC_DIR = Path(__file__).resolve().parent
_lib = None
_lock = threading.Lock()
_pending: list[tuple[str, object, object]] = []


def build_dir() -> Path:
    return _SRC_DIR.parent.parent / ".kueue_tpu_torch_build"


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "kueue_tpu_torch's kernels")


def _run(cmd: list[str]) -> None:
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                           f"{r.stdout}\n{r.stderr}")


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library (when stale)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libkueue_kernels.so"
    newest = max((_SRC_DIR / f).stat().st_mtime for f in SOURCES + HEADERS)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        BUILD["library"] = str(lib)
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(_run, [[nvcc, *NVCC_FLAGS, "-c", str(_SRC_DIR / s),
                            "-o", str(o)] for s, o in zip(SOURCES, objs)]))
    tmp = out_dir / f"libkueue_kernels.{tag}.so"
    _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
          "-o", str(tmp), *map(str, objs)])
    os.replace(tmp, lib)
    for o in objs:
        o.unlink(missing_ok=True)
    BUILD.update(seconds=time.perf_counter() - t0, library=str(lib))
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "kq_admit_scan": [_P] * 19 + [_I] * 8 + [_P],
    "kq_admit_scan_forests": [_P] * 20 + [_I] * 9 + [_P],
    "kq_admit_scan_preempt": [_P] * 28 + [_I] * 11 + [_P],
    "kq_minimal_preemptions": [_P] * 18 + [_I] * 7 + [_P],
    "kq_burst_cycles": [_P, _P, _P],
    "kq_fs_admit_scan": [_P, _P, _P],
    "kq_drs_components": [_P] * 11 + [_I] * 4 + [_P],
    "kq_tas_fill_counts": [_P, _P, _P],
    "kq_tas_best_fit_descend": [_P, _P, _P],
    "kq_tas_split_across_roots": [_P, _P, _P],
}


def load():
    """Build (when stale) and load the kernel library once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def reset_counts() -> None:
    collect()
    for k in KERNELS:
        LAUNCHES[k] = 0
        DEVICE_MS[k] = 0.0


def collect() -> dict[str, float]:
    """Fold the device times of finished launches into DEVICE_MS."""
    while _pending:
        name, start, end = _pending.pop()
        end.synchronize()
        DEVICE_MS[name] += start.elapsed_time(end)
    return dict(DEVICE_MS)


# -- argument checks -------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _threads(F: int, minimum: int = 32) -> int:
    if F > MAX_THREADS:
        raise ValueError(f"F={F} columns exceed {MAX_THREADS} threads")
    return max(minimum, -(-F // 32) * 32)


def _check_depth(depth: int) -> None:
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth={depth} outside [1, {MAX_DEPTH}]")


def _launch(name: str, fn, *args) -> None:
    stream = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    status = fn(*args, _P(stream.cuda_stream))
    end.record(stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {status}")
    LAUNCHES[name] += 1
    _pending.append((name, start, end))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return _P(t.data_ptr())


def _cycle_checks(usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
                  nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
                  res_fr, res_amt, res_mask, res_borrows, order):
    dev = usage0.device
    if dev.type != "cuda":
        raise ValueError(f"usage0 on {dev}: the kernels need CUDA tensors")
    N, F = usage0.shape
    C = nominal_cq.shape[0]
    W = wl_cq.shape[0]
    i32, b = torch.int32, torch.bool
    _check("usage0", usage0, i32, (N, F), dev)
    for nm, t in (("subtree", subtree), ("guaranteed", guaranteed),
                  ("borrow_cap", borrow_cap)):
        _check(nm, t, i32, (N, F), dev)
    _check("has_blim", has_blim, b, (N, F), dev)
    _check("parent", parent, i32, (N,), dev)
    _check("nominal_cq", nominal_cq, i32, (C, F), dev)
    _check("npb_cq", npb_cq, i32, (C, F), dev)
    _check("wl_cq", wl_cq, i32, (W,), dev)
    rd = dec_fr.shape[1] if dec_fr.dim() == 2 else -1
    rr = res_fr.shape[1] if res_fr.dim() == 2 else -1
    _check("dec_fr", dec_fr, i32, (W, rd), dev)
    _check("dec_amt", dec_amt, i32, (W, rd), dev)
    _check("fit_mask", fit_mask, b, (W,), dev)
    _check("res_fr", res_fr, i32, (W, rr), dev)
    _check("res_amt", res_amt, i32, (W, rr), dev)
    _check("res_mask", res_mask, b, (W,), dev)
    _check("res_borrows", res_borrows, b, (W,), dev)
    _check("order", order, i32, (W,), dev)
    return dev, N, F, W, rd, rr


def _cycle_ptrs(*ts):
    return [_ptr(t) for t in ts]


# -- launchers ---------------------------------------------------------------

def admit_scan(usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
               nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
               res_fr, res_amt, res_mask, res_borrows, order, *, depth):
    """CUDA admit_scan (kernels/admit_scan.cu) → admitted [W] bool."""
    args = (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
            res_fr, res_amt, res_mask, res_borrows, order)
    dev, N, F, W, rd, rr = _cycle_checks(*args)
    _check_depth(depth)
    lib = load()
    threads = _threads(F)
    smem = N * F * 4
    if smem > SMEM_LIMIT:
        smem = 0
        scratch = torch.empty((N, F), dtype=torch.int32, device=dev)
    else:
        scratch = torch.empty(1, dtype=torch.int32, device=dev)
    admitted = torch.empty(W, dtype=torch.bool, device=dev)
    _launch("admit_scan", lib.kq_admit_scan, *_cycle_ptrs(*args),
            _ptr(scratch), _ptr(admitted), N, F, W, rd, rr, depth, threads,
            smem)
    return admitted


def admit_scan_forests(usage0, subtree, guaranteed, borrow_cap, has_blim,
                       parent, nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt,
                       fit_mask, res_fr, res_amt, res_mask, res_borrows,
                       order, forest_of_node, *, depth, n_forests,
                       max_forest_wl):
    """CUDA admit_scan_forests (kernels/admit_scan_forests.cu)."""
    args = (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
            res_fr, res_amt, res_mask, res_borrows, order)
    dev, N, F, W, rd, rr = _cycle_checks(*args)
    _check("forest_of_node", forest_of_node, torch.int32, (N,), dev)
    _check_depth(depth)
    if n_forests < 1 or max_forest_wl < 1:
        raise ValueError("n_forests and max_forest_wl must be >= 1")
    threads = _threads(F, minimum=128)
    if (max_forest_wl + threads // 32) * 4 > SMEM_LIMIT:
        raise ValueError(f"max_forest_wl={max_forest_wl} exceeds shared "
                         "memory")
    lib = load()
    scratch = torch.empty((N, F), dtype=torch.int32, device=dev)
    admitted = torch.empty(W, dtype=torch.bool, device=dev)
    _launch("admit_scan_forests", lib.kq_admit_scan_forests,
            *_cycle_ptrs(*args), _ptr(forest_of_node), _ptr(scratch),
            _ptr(admitted), N, F, W, rd, rr, depth, n_forests, max_forest_wl,
            threads)
    return admitted


def admit_scan_preempt(usage0, subtree, guaranteed, borrow_cap, has_blim,
                       parent, nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt,
                       fit_mask, res_fr, res_amt, res_mask, res_borrows,
                       preempt_mask, pre_fr, pre_amt, tgt_mat, tu_cq,
                       tu_delta, order, *, depth):
    """CUDA admit_scan_preempt (kernels/admit_scan_preempt.cu) →
    (admitted, preempting, overlap_skip), each [W] bool."""
    args = (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
            res_fr, res_amt, res_mask, res_borrows, order)
    dev, N, F, W, rd, rr = _cycle_checks(*args)
    _check_depth(depth)
    rp = pre_fr.shape[1] if pre_fr.dim() == 2 else -1
    mt = tgt_mat.shape[1] if tgt_mat.dim() == 2 else -1
    T = tu_cq.shape[0]
    _check("preempt_mask", preempt_mask, torch.bool, (W,), dev)
    _check("pre_fr", pre_fr, torch.int32, (W, rp), dev)
    _check("pre_amt", pre_amt, torch.int32, (W, rp), dev)
    _check("tgt_mat", tgt_mat, torch.int32, (W, mt), dev)
    _check("tu_cq", tu_cq, torch.int32, (T,), dev)
    _check("tu_delta", tu_delta, torch.int32, (T, F), dev)
    lib = load()
    threads = _threads(F)
    smem = 3 * N * F * 4
    if smem > SMEM_LIMIT:
        smem = 0
        scratch = torch.empty((3, N, F), dtype=torch.int32, device=dev)
    else:
        scratch = torch.empty(1, dtype=torch.int32, device=dev)
    used = torch.empty(max(T, 1), dtype=torch.bool, device=dev)
    admitted = torch.empty(W, dtype=torch.bool, device=dev)
    preempting = torch.empty(W, dtype=torch.bool, device=dev)
    skip = torch.empty(W, dtype=torch.bool, device=dev)
    _launch("admit_scan_preempt", lib.kq_admit_scan_preempt,
            *_cycle_ptrs(*args[:16]), _ptr(preempt_mask), _ptr(pre_fr),
            _ptr(pre_amt), _ptr(tgt_mat), _ptr(tu_cq), _ptr(tu_delta),
            _ptr(order), _ptr(scratch), _ptr(used), _ptr(admitted),
            _ptr(preempting), _ptr(skip), N, F, W, rd, rr, rp, mt, T, depth,
            threads, smem)
    return admitted, preempting, skip


def minimal_preemptions_batch(usage0, subtree, guaranteed, borrow_cap,
                              has_blim, parent, pre_cq, wl_usage, frs_mask,
                              cand_cq, cand_delta, cand_other_cq,
                              cand_above_threshold, allow_borrowing0,
                              threshold_enabled, *, depth):
    """CUDA minimal_preemptions_batch (kernels/minimal_preemptions.cu) →
    (fitted [S] bool, target_mask [S, K] bool)."""
    dev = usage0.device
    if dev.type != "cuda":
        raise ValueError(f"usage0 on {dev}: the kernels need CUDA tensors")
    S, NL, F = usage0.shape
    K = cand_cq.shape[1] if cand_cq.dim() == 2 else -1
    i32, b = torch.int32, torch.bool
    for nm, t in (("usage0", usage0), ("subtree", subtree),
                  ("guaranteed", guaranteed), ("borrow_cap", borrow_cap)):
        _check(nm, t, i32, (S, NL, F), dev)
    _check("has_blim", has_blim, b, (S, NL, F), dev)
    _check("parent", parent, i32, (S, NL), dev)
    _check("pre_cq", pre_cq, i32, (S,), dev)
    _check("wl_usage", wl_usage, i32, (S, F), dev)
    _check("frs_mask", frs_mask, b, (S, F), dev)
    _check("cand_cq", cand_cq, i32, (S, K), dev)
    _check("cand_delta", cand_delta, i32, (S, K, F), dev)
    _check("cand_other_cq", cand_other_cq, b, (S, K), dev)
    _check("cand_above_threshold", cand_above_threshold, b, (S, K), dev)
    _check("allow_borrowing0", allow_borrowing0, b, (S,), dev)
    _check("threshold_enabled", threshold_enabled, b, (S,), dev)
    _check_depth(depth)
    lib = load()
    smem = NL * F * 4
    if smem > SMEM_LIMIT:
        smem = 0
        scratch = torch.empty((S, NL, F), dtype=i32, device=dev)
    else:
        scratch = torch.empty(1, dtype=i32, device=dev)
    fitted = torch.empty(S, dtype=b, device=dev)
    mask = torch.empty((S, K), dtype=b, device=dev)
    if S == 0:
        return fitted, mask
    _launch("minimal_preemptions_batch", lib.kq_minimal_preemptions,
            *_cycle_ptrs(usage0, subtree, guaranteed, borrow_cap, has_blim,
                         parent, pre_cq, wl_usage, frs_mask, cand_cq,
                         cand_delta, cand_other_cq, cand_above_threshold,
                         allow_borrowing0, threshold_enabled, scratch, fitted,
                         mask),
            S, NL, F, K, depth, _threads(F), smem)
    return fitted, mask


# -- the fused burst ---------------------------------------------------------

BURST_THREADS = 256
_BURST_Q_N = 6          # Q_N in burst_cycles.cu: per-CQ ints of a cycle
_BURST_BOOL = ("vec_ok", "elig0", "parked0", "adm0", "adm_uses0",
               "has_blim", "slot_valid", "cq_can_preempt_borrow",
               "cq_wcb_borrow", "cq_wcp_preempt", "strict_cq", "wcq_lower",
               "rwc_enabled", "rwc_only_lower", "preempt_ok", "ext_unpark")
# the launch's input order (BurstArgs in burst_cycles.cu)
_BURST_INPUTS = ("wl_req", "wl_rank", "wl_cycle_rank", "wl_prio",
                 "wl_uidrank", "vec_ok", "potential0", "subtree",
                 "guaranteed", "borrow_cap", "has_blim", "parent",
                 "node_level", "nominal_cq", "npb_cq", "slot_fr",
                 "slot_valid", "cq_can_preempt_borrow", "cq_wcb_borrow",
                 "cq_wcp_preempt", "strict_cq", "wcq_lower", "rwc_enabled",
                 "rwc_only_lower", "preempt_ok", "members", "cand_rows",
                 "cand_lmem", "self_lmem", "ext_release", "ext_unpark")


def burst_node_table(parent, node_level, forest_of_cq, G: int, device):
    """The burst kernel's per-forest node table: ``(nodes [G, NN] int32,
    count [G] int32)`` on ``device`` — every node of each cohort forest
    (the trees holding that forest's CQs), deepest level first, -1 pad.
    Derived on the host from the structure planes (numpy or tensors)."""
    import numpy as np

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(x).astype(np.int64)

    parent, level, fcq = host(parent), host(node_level), host(forest_of_cq)
    N, C = len(parent), len(fcq)
    root = np.arange(N)
    for _ in range(N):
        up = parent[root]
        nxt = np.where(up >= 0, up, root)
        if np.array_equal(nxt, root):
            break
        root = nxt
    forest_of_root = np.full(N, -1, dtype=np.int64)
    forest_of_root[root[:C]] = fcq
    fo = forest_of_root[root]
    nodes = np.nonzero(fo >= 0)[0]
    nodes = nodes[np.lexsort((nodes, -level[nodes], fo[nodes]))]
    f = fo[nodes]
    count = np.bincount(f, minlength=G).astype(np.int32)
    NN = max(1, int(count.max(initial=0)))
    table = np.full((G, NN), -1, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(count)[:-1]])
    table[f, np.arange(len(nodes)) - starts[f]] = nodes
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(count).to(device))


def burst_cycles(*args, K, depth, L, S, KC, n_levels, G, runtime,
                 node_table=None):
    """CUDA burst_cycles (kernels/burst_cycles.cu): K fused admission
    cycles, one block per cohort forest.  Arguments and outputs as
    ``ops.burst.burst_cycles_plain``; ``node_table`` as
    ``burst_node_table`` (derived here when not given)."""
    from ..ops.burst import ARG_NAMES, NARROW_ARGS, STATE_NAMES
    if len(args) != len(ARG_NAMES):
        raise ValueError(f"burst_cycles takes {len(ARG_NAMES)} arguments, "
                         f"got {len(args)}")
    a = dict(zip(ARG_NAMES, args))
    dev = a["wl_req"].device
    if dev.type != "cuda":
        raise ValueError(f"wl_req on {dev}: the kernels need CUDA tensors")
    i32, b = torch.int32, torch.bool
    for name in NARROW_ARGS:
        t = a[name]
        if isinstance(t, torch.Tensor) and t.dtype in (torch.int8,
                                                       torch.int16):
            a[name] = t.to(i32)    # planes narrowed for the transfer
    C, M, R = a["wl_req"].shape
    N, F = a["subtree"].shape
    shapes = {
        "wl_req": (C, M, R), "potential0": (N, F), "subtree": (N, F),
        "guaranteed": (N, F), "borrow_cap": (N, F), "has_blim": (N, F),
        "parent": (N,), "node_level": (N,), "nominal_cq": (C, F),
        "npb_cq": (C, F), "slot_fr": (C, S, R), "slot_valid": (C, S),
        "members": (G, L), "cand_rows": (G, KC), "cand_lmem": (G, KC),
        "ext_release": (K, C, F), "ext_unpark": (K, G),
        "adm_usage0": (C, M, F), "adm_uses0": (C, M, F), "u_cq0": (C, F)}
    for name in ARG_NAMES:
        if name == "seq_base":
            continue
        shape = shapes.get(name)
        if shape is None:
            shape = (C,) if name in ("cq_can_preempt_borrow",
                                     "cq_wcb_borrow", "cq_wcp_preempt",
                                     "forest_of_cq", "strict_cq",
                                     "wcq_lower", "rwc_enabled",
                                     "rwc_only_lower", "preempt_ok",
                                     "self_lmem") else (C, M)
        _check(name, a[name], b if name in _BURST_BOOL else i32, shape, dev)
    if KC < 32 or KC % 32 or KC > 1 << 16:
        raise ValueError(f"KC={KC}: a positive multiple of 32 up to 65536")
    if min(C, M, R, F, S, L, G, K) < 1:
        raise ValueError("burst_cycles needs non-empty planes")
    _check_depth(depth)
    kcp = 1 << (KC - 1).bit_length()
    if kcp * 12 + 2 * (KC // 32) * 4 > SMEM_LIMIT:
        raise ValueError(f"KC={KC} exceeds shared memory")
    if node_table is None:
        node_table = burst_node_table(a["parent"], a["node_level"],
                                      a["forest_of_cq"], G, dev)
    fnodes, fcount = node_table
    _check("fnodes", fnodes, i32, (G, fnodes.shape[1]), dev)
    _check("fcount", fcount, i32, (G,), dev)
    lib = load()
    KCW = KC // 32
    carry = [a[n].clone() for n in STATE_NAMES]
    head_row = torch.empty((K, C), dtype=i32, device=dev)
    kind = torch.empty((K, C), dtype=i32, device=dev)
    slot = torch.empty((K, C), dtype=i32, device=dev)
    borrows = torch.empty((K, C), dtype=b, device=dev)
    tgt_words = torch.zeros((K, C, KCW), dtype=i32, device=dev)
    dflags = torch.zeros((K, 4), dtype=i32, device=dev)

    def scratch(*shape):
        return torch.empty(shape, dtype=i32, device=dev)

    scr = [scratch(N, F)] + [scratch(C, F) for _ in range(7)] + [
        scratch(C, _BURST_Q_N), scratch(G, L), scratch(G, L),
        scratch(G, KCW), scratch(G, 2, L, F)]
    tensors = ([a[n] for n in _BURST_INPUTS] + [fnodes, fcount] + carry
               + [head_row, kind, slot, borrows, tgt_words, dflags] + scr)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * 16)(
        C, M, R, N, F, S, L, KC, K, G, depth, n_levels, fnodes.shape[1],
        max(0, runtime), int(a["seq_base"]), BURST_THREADS)
    _launch("burst_cycles", lib.kq_burst_cycles, ptrs, dims)
    dirty = dflags[:, 0] > 0
    dirty_reason = ((dflags[:, 1] > 0).to(i32) * 1
                    + (dflags[:, 2] > 0).to(i32) * 2)
    return (head_row, kind, slot, borrows, tgt_words, dirty, dirty_reason,
            tuple(carry))


# -- fair sharing --------------------------------------------------------------

FS_MAX_F = 64           # FS_MAX_F in fs_admit_scan.cu: per-thread carry
FS_MAX_THREADS = 256


def fs_admit_scan(usage0, subtree, sq_mask, guaranteed, borrow_cap,
                  has_blim, parent, node_level, weights, lendable_r, onehot,
                  child_order, wl_cq, u_e, nofit, prio, ts_rank, valid,
                  forest_of_node, *, depth, n_levels):
    """CUDA fs_admit_scan (kernels/fs_admit_scan.cu) → (order [W] int32,
    admitted [W] bool, processed [W] bool); arguments as
    ``ops.fs_scan.fs_admit_scan_plain``."""
    dev = usage0.device
    if dev.type != "cuda":
        raise ValueError(f"usage0 on {dev}: the kernels need CUDA tensors")
    N, F = usage0.shape
    R = lendable_r.shape[1] if lendable_r.dim() == 2 else -1
    W = wl_cq.shape[0]
    i32, b = torch.int32, torch.bool
    for nm, t in (("usage0", usage0), ("subtree", subtree),
                  ("guaranteed", guaranteed), ("borrow_cap", borrow_cap)):
        _check(nm, t, i32, (N, F), dev)
    _check("sq_mask", sq_mask, b, (N, F), dev)
    _check("has_blim", has_blim, b, (N, F), dev)
    for nm, t in (("parent", parent), ("node_level", node_level),
                  ("weights", weights), ("child_order", child_order),
                  ("forest_of_node", forest_of_node)):
        _check(nm, t, i32, (N,), dev)
    _check("lendable_r", lendable_r, i32, (N, R), dev)
    _check("onehot", onehot, i32, (F, R), dev)
    for nm, t in (("wl_cq", wl_cq), ("prio", prio), ("ts_rank", ts_rank)):
        _check(nm, t, i32, (W,), dev)
    _check("u_e", u_e, i32, (W, F), dev)
    _check("nofit", nofit, b, (W,), dev)
    _check("valid", valid, b, (W,), dev)
    _check_depth(depth)
    if not 1 <= n_levels <= depth:
        raise ValueError(f"n_levels={n_levels} outside [1, depth={depth}]")
    if not 1 <= F <= FS_MAX_F or R < 1 or N < 1:
        raise ValueError(f"F={F} must be in [1, {FS_MAX_F}], R={R} and "
                         f"N={N} at least 1")
    order = torch.empty(W, dtype=i32, device=dev)
    admitted = torch.empty(W, dtype=b, device=dev)
    processed = torch.empty(W, dtype=b, device=dev)
    if W == 0:
        return order, admitted, processed
    lib = load()
    # F <= FS_MAX_F <= FS_MAX_THREADS: a thread for each column
    threads = max(32, -(-min(max(W, N, F), FS_MAX_THREADS) // 32) * 32)
    # usage [N, F], node winners [N], four key minima and the promotion
    # slots [N + 1] each, DRS [W, depth], remaining [W], two scalars
    ints = N * F + N + 5 * (N + 1) + W * depth + W + 2
    smem = ints * 4
    if smem > SMEM_LIMIT:
        smem = 0
        scratch = torch.empty(ints, dtype=i32, device=dev)
    else:
        scratch = torch.empty(1, dtype=i32, device=dev)
    tensors = (usage0, subtree, sq_mask, guaranteed, borrow_cap, has_blim,
               parent, node_level, weights, lendable_r, onehot, child_order,
               wl_cq, u_e, nofit, prio, ts_rank, valid, forest_of_node,
               scratch, order, admitted, processed)
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * 8)(N, F, R, W, depth, n_levels, threads, smem)
    _launch("fs_admit_scan", lib.kq_fs_admit_scan, ptrs, dims)
    return order, admitted, processed


def drs_components(usage, subtree, guaranteed, borrow_cap, has_blim, parent,
                   fr_to_resource, wl_req=None, *, n_resources, depth):
    """CUDA drs_components (kernels/drs_components.cu) → (borrowing
    [N, R] int32, lendable [N, R] int32); arguments as
    ``ops.fairsharing_kernel.drs_components_plain``."""
    dev = usage.device
    if dev.type != "cuda":
        raise ValueError(f"usage on {dev}: the kernels need CUDA tensors")
    N, F = usage.shape
    R = int(n_resources)
    i32 = torch.int32
    for nm, t in (("usage", usage), ("subtree", subtree),
                  ("guaranteed", guaranteed), ("borrow_cap", borrow_cap)):
        _check(nm, t, i32, (N, F), dev)
    _check("has_blim", has_blim, torch.bool, (N, F), dev)
    _check("parent", parent, i32, (N,), dev)
    _check("fr_to_resource", fr_to_resource, i32, (F,), dev)
    if wl_req is not None:
        _check("wl_req", wl_req, i32, (N, F), dev)
    _check_depth(depth)
    if R < 1:
        raise ValueError(f"n_resources={R} must be at least 1")
    borrowing = torch.empty((N, R), dtype=i32, device=dev)
    lendable = torch.empty((N, R), dtype=i32, device=dev)
    if N == 0:
        return borrowing, lendable
    lib = load()
    zeros = torch.zeros((N, F), dtype=i32, device=dev)
    _launch("drs_components", lib.kq_drs_components,
            *_cycle_ptrs(usage, subtree, guaranteed, borrow_cap, has_blim,
                         parent, fr_to_resource),
            _P(wl_req.data_ptr() if wl_req is not None else None),
            *_cycle_ptrs(zeros, borrowing, lendable), N, F, R, depth)
    return borrowing, lendable


# -- topology-aware scheduling ---------------------------------------------------

TAS_MAX_LEVELS = 8      # TAS_MAX_LEVELS in tas.cuh (Kueue allows 8 levels)
TAS_PROFILES = {"bestfit": 0, "mostfree": 1, "leastfree": 2}
TAS_SMEM_SORT = 200 * 1024   # the sort's keys and ties in shared memory


def _tas_checks(leaf_free, per_pod, parents, level_sizes):
    """Checks one query's tensors and returns their device."""
    dev = leaf_free.device
    if dev.type != "cuda":
        raise ValueError(f"leaf_free on {dev}: the kernels need CUDA tensors")
    L = len(level_sizes)
    if not 1 <= L <= TAS_MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernels take 1 to "
                         f"{TAS_MAX_LEVELS}")
    if min(level_sizes) < 1:
        raise ValueError(f"level_sizes={level_sizes}: empty level")
    if len(parents) != L - 1:
        raise ValueError(f"{len(parents)} parent planes for {L} levels")
    i32 = torch.int32
    R = leaf_free.shape[1] if leaf_free.dim() == 2 else -1
    _check("leaf_free", leaf_free, i32, (level_sizes[-1], R), dev)
    _check("per_pod", per_pod, i32, (R,), dev)
    if R < 1:
        raise ValueError("leaf_free needs at least one resource column")
    for lvl, par in enumerate(parents):
        _check(f"parents[{lvl}]", par, i32, (level_sizes[lvl + 1],), dev)
    return dev


def _tas_tree(leaf_free, per_pod, parents, level_sizes):
    """The tree's part of a launch's pointer and dimension arrays."""
    ptrs = ([leaf_free.data_ptr(), per_pod.data_ptr()]
            + [p.data_ptr() for p in parents]
            + [None] * (TAS_MAX_LEVELS - len(parents)))
    dims = ([len(level_sizes), leaf_free.shape[1]] + list(level_sizes)
            + [0] * (TAS_MAX_LEVELS - len(level_sizes)))
    return ptrs, dims


def _tas_launch(name, fn, ptrs, dims) -> None:
    _launch(name, fn, (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(dims))(*dims))


def fill_counts(leaf_free, per_pod, parents, *, level_sizes):
    """CUDA fill_counts (kernels/tas_fill_counts.cu) → per-level states,
    a tuple of int32 tensors (top → bottom); arguments as
    ``ops.tas_kernel.fill_counts_plain``."""
    level_sizes = tuple(level_sizes)
    dev = _tas_checks(leaf_free, per_pod, parents, level_sizes)
    lib = load()
    states = torch.empty(sum(level_sizes), dtype=torch.int32, device=dev)
    ptrs, dims = _tas_tree(leaf_free, per_pod, parents, level_sizes)
    _tas_launch("fill_counts", lib.kq_tas_fill_counts,
                ptrs + [states.data_ptr()], dims)
    return tuple(torch.split(states, list(level_sizes)))


def _tas_query(name, entry, leaf_free, per_pod, parents, level_sizes, count,
               level, profile, descend_profile, sorted_levels):
    """One best_fit_descend / split_across_roots launch → (ok, counts)."""
    for p in (profile, descend_profile):
        if p not in TAS_PROFILES:
            raise ValueError(f"profile {p!r}: one of {tuple(TAS_PROFILES)}")
    if not -2**31 <= count < 2**31:
        raise OverflowError(f"count={count} outside int32")
    dev = _tas_checks(leaf_free, per_pod, parents, level_sizes)
    fn = getattr(load(), entry)
    n = max([level_sizes[d] for d in sorted_levels], default=1)
    P = 1 << max(0, n - 1).bit_length()
    # the largest parent level walked: its segment bounds follow the sort
    Q = max([level_sizes[d - 1] for d in sorted_levels if d > 0], default=0)
    total = sum(level_sizes)
    states = torch.empty(total, dtype=torch.int32, device=dev)
    counts = torch.empty(total, dtype=torch.int32, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    out = torch.empty(level_sizes[-1], dtype=torch.int32, device=dev)
    smem = 12 * P + 8 * Q
    sort_global = None
    if smem > TAS_SMEM_SORT:
        sort_global = torch.empty(smem, dtype=torch.uint8, device=dev)
        smem = 0
    ptrs, dims = _tas_tree(leaf_free, per_pod, parents, level_sizes)
    ptrs += [states.data_ptr(), counts.data_ptr(),
             sort_global.data_ptr() if sort_global is not None else None,
             ok.data_ptr(), out.data_ptr()]
    dims += [count, level, TAS_PROFILES[profile],
             TAS_PROFILES[descend_profile], P, smem]
    _tas_launch(name, fn, ptrs, dims)
    return ok[0], out


def best_fit_descend(leaf_free, per_pod, parents, count, *, level_sizes,
                     level, profile="bestfit"):
    """CUDA best_fit_descend (kernels/tas_descend.cu) → (ok 0-dim bool,
    leaf_counts [N_leaf] int32); arguments as
    ``ops.tas_kernel.best_fit_descend_plain``."""
    level_sizes = tuple(level_sizes)
    if not 0 <= level < len(level_sizes):
        raise ValueError(f"level={level} outside the {len(level_sizes)} "
                         "levels")
    return _tas_query("best_fit_descend", "kq_tas_best_fit_descend",
                      leaf_free, per_pod, parents, level_sizes,
                      int(count), level, profile, profile,
                      range(level + 1, len(level_sizes)))


def split_across_roots(leaf_free, per_pod, parents, count, *, level_sizes,
                       profile="bestfit", descend_profile=None):
    """CUDA split_across_roots (kernels/tas_descend.cu) → (ok 0-dim bool,
    leaf_counts [N_leaf] int32); arguments as
    ``ops.tas_kernel.split_across_roots_plain``."""
    level_sizes = tuple(level_sizes)
    return _tas_query("split_across_roots", "kq_tas_split_across_roots",
                      leaf_free, per_pod, parents, level_sizes,
                      int(count), 0, profile, descend_profile or profile,
                      range(len(level_sizes)))
