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
else is a count taken.  A launch records no CUDA event: device times
come from the profiler's CUDA activity (``profiling.DeviceClock``, which
names each kernel by its launcher through ``SYMBOLS``).

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
           "split_across_roots", "kq_cq_avail", "kq_classify_heads",
           "kq_cycle_order", "kq_scatter_rows", "kq_reduce_dflags",
           "kq_gather_heads", "kq_fs_merge_order")
SOURCES = ("admit_scan.cu", "admit_scan_preempt.cu", "admit_scan_forests.cu",
           "minimal_preemptions.cu", "burst_cycles.cu", "fs_admit_scan.cu",
           "drs_components.cu", "tas_fill_counts.cu", "tas_descend.cu",
           "solve_cycle.cu", "scatter_rows.cu", "mesh_gather.cu")
HEADERS = ("quota.cuh", "admit_entry.cuh", "flat_forest.cuh", "tas.cuh")
MAX_THREADS = 1024
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on H100
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# each kernel's ``__global__`` symbol, as a profiler names it (before its
# template and parameter lists) → its launcher's name
SYMBOLS = {
    "kq_admit_scan_kernel": "admit_scan",
    "kq_admit_scan_preempt_kernel": "admit_scan_preempt",
    "kq_admit_scan_forests_kernel": "admit_scan_forests",
    "kq_minimal_preemptions_kernel": "minimal_preemptions_batch",
    "kq_burst_cycles_kernel": "burst_cycles",
    "kq_fs_admit_scan_kernel": "fs_admit_scan",
    "kq_drs_components_kernel": "drs_components",
    "kq_tas_fill_counts_kernel": "fill_counts",
    "kq_tas_best_fit_descend_kernel": "best_fit_descend",
    "kq_tas_split_across_roots_kernel": "split_across_roots",
    "kq_cq_avail_kernel": "kq_cq_avail",
    "kq_classify_heads_kernel": "kq_classify_heads",
    "kq_cycle_order_kernel": "kq_cycle_order",
    "kq_scatter_rows_kernel": "kq_scatter_rows",
    "kq_reduce_dflags_kernel": "kq_reduce_dflags",
    "kq_gather_heads_kernel": "kq_gather_heads",
    "kq_fs_merge_order_kernel": "kq_fs_merge_order",
}
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
BUILD: dict = {"seconds": None, "library": None}

_SRC_DIR = Path(__file__).resolve().parent
_lib = None
_lock = threading.Lock()


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
    "kq_admit_scan": [_P, _P, _P],
    "kq_admit_scan_forests": [_P, _P, _P],
    "kq_admit_scan_preempt": [_P, _P, _P],
    "kq_minimal_preemptions": [_P, _P, _P],
    "kq_burst_cycles": [_P, _P, _P],
    "kq_fs_admit_scan": [_P, _P, _P],
    "kq_drs_components": [_P] * 11 + [_I] * 4 + [_P],
    "kq_tas_fill_counts": [_P, _P, _P],
    "kq_tas_best_fit_descend": [_P, _P, _P],
    "kq_tas_split_across_roots": [_P, _P, _P],
    "kq_cq_avail": [_P, _P, _P],
    "kq_classify_heads": [_P, _P, _P],
    "kq_cycle_order": [_P, _P, _P],
    "kq_scatter_rows": [_P, _P, _P],
    "kq_reduce_dflags": [_P, _P, _I, _I, _P],
    "kq_gather_heads": [_P, _I, _P, _I, _I, _I, ctypes.c_uint, _P],
    "kq_fs_merge_order": [_P, _P, _P],
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


def launcher_of(symbol: str) -> str | None:
    """The launcher's name of a kernel symbol as a profiler reports it
    (``"void kq_gather_heads_kernel<8>(...)"`` or ``"(anonymous
    namespace)::kq_burst_cycles_kernel(BurstArgs)"`` → the launcher), or
    None for a kernel that is not this library's."""
    base = symbol.replace("(anonymous namespace)::", "")
    base = base.split("(", 1)[0].split("<", 1)[0].strip()
    return SYMBOLS.get(base.rsplit(" ", 1)[-1].rsplit("::", 1)[-1])


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


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


def _check_depth(depth: int) -> None:
    if depth < 1:
        raise ValueError(f"depth={depth}: at least 1")


def _launch(name: str, fn, *args) -> None:
    """Call the C launch function on the current stream; count it."""
    status = fn(*args, _P(torch.cuda.current_stream().cuda_stream))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {status}")
    LAUNCHES[name] += 1


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

FLAT_THREADS = 256       # admit_scan's block: 8 warps, one per forest set
FLAT_STATIC_SMEM = 256  # its static shared bytes, rounded up
# shared bytes an admit_scan block may use; a block whose node rows and
# head list need more takes the global route (0 sends every block
# there); the warps' column rows follow in shared memory where they fit,
# else in a global [blocks, warps, F] scratch
FLAT_SMEM = SMEM_LIMIT
FLAT_ROUTES: dict[str, torch.Tensor] = {}
FLAT_ROUTE_NAMES = ("no heads", "shared", "global")
_SM_COUNT: dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors (cached per device)."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(
            i).multi_processor_count
    return _SM_COUNT[i]


def flat_smem_ints(n_nodes: int, F: int, heads: int, ent: int,
                   threads: int = FLAT_THREADS, planes: int = 1) -> int:
    """The forest-parallel scans' shared working set
    (kernels/flat_forest.cuh) for ``n_nodes`` nodes and ``heads`` list
    entries of ``ent`` ints: per node its index, parent and
    has-borrow-limit words, per cell ``planes`` usage-like rows,
    guaranteed and cap; a column row per warp."""
    words = -(-F // 32)
    return (n_nodes * (2 + words + (planes + 2) * F) + ent * heads
            + (threads // 32) * F)


def _flat_smem(need: int, reserve: int = 0) -> tuple[int, bool]:
    """(dynamic shared bytes, whether a block may take the global route)
    of a forest-parallel launch whose whole working set is ``need``
    ints, with ``reserve`` ints more that always sit in shared memory
    (admit_scan_forests' rank counters)."""
    cap = max(0, (min(FLAT_SMEM, SMEM_LIMIT - reserve * 4)
                  - FLAT_STATIC_SMEM) // 4)
    return (min(need, cap) + reserve) * 4, need > cap


def _forest_tables(forest_of_node, n_forests, N, dev):
    if forest_of_node is None:
        return N
    _check("forest_of_node", forest_of_node, torch.int32, (N,), dev)
    if n_forests is None or n_forests < 1:
        raise ValueError("forest_of_node needs n_forests >= 1")
    return int(n_forests)


def _flat_scan(name: str, fn, args, depth: int, forest_of_node, n_forests,
               max_forest_wl: int = 0):
    """Launch a flat scan (kernels/flat_forest.cuh ``flat_launch``) on
    admit_scan's 17 arrays: a block per forest up to the card's SM
    count, each block's route in ``FLAT_ROUTES[name]``.  With
    ``max_forest_wl`` (admit_scan_forests' rank cap) the warps' rank
    counters take a quarter of shared memory at most, else global
    scratch."""
    dev, N, F, W, rd, rr = _cycle_checks(*args)
    _check_depth(depth)
    groups = _forest_tables(forest_of_node, n_forests, N, dev)
    blocks = max(1, min(groups, sm_count(dev)))
    threads = FLAT_THREADS
    nw = threads // 32
    ent = 3 + 2 * rd
    i32 = torch.int32
    rank, cap_dims, reserve = (), (), 0
    if max_forest_wl:
        per_warp = -(-(-(-groups // blocks)) // nw)
        reserve = nw * per_warp
        rank = (None,)
        if reserve * 4 > SMEM_LIMIT // 4:
            reserve = 0
            rank = (torch.empty((blocks, nw, per_warp), dtype=i32,
                                device=dev),)
        cap_dims = (max_forest_wl, groups, per_warp, reserve)
    smem, wide = _flat_smem(flat_smem_ints(N, F, W, ent, threads), reserve)
    lib = load()
    gusage = torch.empty((N, F) if wide else 1, dtype=i32, device=dev)
    glist = torch.empty(ent * W if wide else 1, dtype=i32, device=dev)
    gcount = torch.empty(1, dtype=i32, device=dev) if wide else None
    gcol = (torch.empty((blocks, nw, F), dtype=i32, device=dev)
            if wide else None)
    gmap = torch.empty(max(N, 1), dtype=i32, device=dev)
    admitted = torch.empty(W, dtype=torch.bool, device=dev)
    route = torch.empty(blocks, dtype=i32, device=dev)
    FLAT_ROUTES[name] = route
    tensors = args + (forest_of_node, gmap, gusage, glist, gcount,
                      admitted, route, gcol) + rank
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    dims = (N, F, W, rd, rr, depth, blocks, threads, smem) + cap_dims
    _launch(name, getattr(lib, fn), ptrs, (ctypes.c_int * len(dims))(*dims))
    return admitted


def admit_scan(usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
               nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
               res_fr, res_amt, res_mask, res_borrows, order, *, depth,
               forest_of_node=None, n_forests=None):
    """CUDA admit_scan (kernels/admit_scan.cu) → admitted [W] bool.

    Cohort forests in parallel: ``forest_of_node`` [N] int32 (every node
    of a tree the same value in [0, ``n_forests``), as the structure
    planes give it) names them; without it the kernel names each forest
    by its root.  A block per forest up to the card's SM count; each
    block's route (``FLAT_ROUTE_NAMES``) lands in
    ``FLAT_ROUTES["admit_scan"]``.  Any F: the warps' column rows go to
    global scratch where shared memory cannot hold them."""
    args = (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
            res_fr, res_amt, res_mask, res_borrows, order)
    return _flat_scan("admit_scan", "kq_admit_scan", args, depth,
                      forest_of_node, n_forests)


def admit_scan_forests(usage0, subtree, guaranteed, borrow_cap, has_blim,
                       parent, nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt,
                       fit_mask, res_fr, res_amt, res_mask, res_borrows,
                       order, forest_of_node, *, depth, n_forests,
                       max_forest_wl):
    """CUDA admit_scan_forests (kernels/admit_scan_forests.cu) →
    admitted [W] bool: admit_scan's layout with the forests named by
    ``forest_of_node`` (values in [0, ``n_forests``)), and a head whose
    rank within its forest, in cycle order, is ``max_forest_wl`` or more
    not admitted.  Each block's route lands in
    ``FLAT_ROUTES["admit_scan_forests"]``."""
    if forest_of_node is None or n_forests < 1 or max_forest_wl < 1:
        raise ValueError("admit_scan_forests needs forest_of_node, and "
                         "n_forests and max_forest_wl >= 1")
    args = (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, fit_mask,
            res_fr, res_amt, res_mask, res_borrows, order)
    return _flat_scan("admit_scan_forests", "kq_admit_scan_forests", args,
                      depth, forest_of_node, n_forests, max_forest_wl)


def admit_scan_preempt(usage0, subtree, guaranteed, borrow_cap, has_blim,
                       parent, nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt,
                       fit_mask, res_fr, res_amt, res_mask, res_borrows,
                       preempt_mask, pre_fr, pre_amt, tgt_mat, tu_cq,
                       tu_delta, order, *, depth, forest_of_node=None,
                       n_forests=None, error=None):
    """CUDA admit_scan_preempt (kernels/admit_scan_preempt.cu) →
    (admitted, preempting, overlap_skip), each [W] bool.

    Cohort forests in parallel, as ``admit_scan``: ``forest_of_node`` /
    ``n_forests`` name them (``ops.cycle.join_target_forests`` merges the
    forests that a preempting head and its targets connect), else each
    forest is named by its root; each block's route lands in
    ``FLAT_ROUTES["admit_scan_preempt"]``.  A target outside its head's
    forest is never removed: it sets ``error``, a zeroed [1] int32 word
    on the device that the caller reads when it fetches the outputs;
    without ``error`` the launcher reads its own word after the launch
    and raises."""
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
    own_error = error is None
    if own_error:
        error = torch.zeros(1, dtype=torch.int32, device=dev)
    _check("error", error, torch.int32, (1,), dev)
    groups = _forest_tables(forest_of_node, n_forests, N, dev)
    blocks = max(1, min(groups, sm_count(dev)))
    threads = FLAT_THREADS
    ent = 3 + 2 * (rd + rp + mt)
    smem, wide = _flat_smem(flat_smem_ints(N, F, W, ent, threads, planes=3))
    lib = load()
    i32 = torch.int32
    gusage = torch.empty((3, N, F) if wide else 1, dtype=i32, device=dev)
    glist = torch.empty(ent * W if wide else 1, dtype=i32, device=dev)
    gcount = torch.empty(1, dtype=i32, device=dev) if wide else None
    gcol = (torch.empty((blocks, threads // 32, F), dtype=i32, device=dev)
            if wide else None)
    gmap = torch.empty(max(N, 1), dtype=i32, device=dev)
    used = torch.empty(max(T, 1), dtype=torch.bool, device=dev)
    admitted = torch.empty(W, dtype=torch.bool, device=dev)
    preempting = torch.empty(W, dtype=torch.bool, device=dev)
    skip = torch.empty(W, dtype=torch.bool, device=dev)
    route = torch.empty(blocks, dtype=i32, device=dev)
    FLAT_ROUTES["admit_scan_preempt"] = route
    tensors = (args[:17] + (forest_of_node, preempt_mask, pre_fr, pre_amt,
                            tgt_mat, tu_cq, tu_delta, gmap, gusage, glist,
                            gcount, gcol, used, admitted, preempting, skip,
                            route, error))
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    dims = (ctypes.c_int * 12)(N, F, W, rd, rr, rp, mt, T, depth, blocks,
                               threads, smem)
    _launch("admit_scan_preempt", lib.kq_admit_scan_preempt, ptrs, dims)
    if own_error:
        check_preempt_error(error)
    return admitted, preempting, skip


def check_preempt_error(error) -> None:
    """Raise when an admit_scan_preempt launch found a preemption target
    outside its head's cohort forest (its error word is set)."""
    if int(error.max().item()) != 0:
        raise RuntimeError("admit_scan_preempt: a preemption target lies "
                           "outside its head's cohort forest; join the "
                           "forests first (ops.cycle.join_target_forests)")


SEARCH_WARPS = 4     # minimal_preemptions_batch: searches per block
# the last launch's routes: the searches' trees and candidates staged in
# shared memory ("shared") or read from the inputs ("global")
SEARCH_ROUTES: dict[str, str] = {}


def search_layout(NL: int, F: int, K: int) -> tuple[int, int, int]:
    """(searches per block, tree ints, candidate ints) of a warp's slice
    of minimal_preemptions_batch's shared memory (0: that part global):
    a tree is NL x (parent, has-borrow-limit words, usage, guaranteed,
    cap, subtree) and its has-borrow-limit bytes, the candidates K x
    (CQ, delta row), the removed bits and the two flag rows' bytes (each
    byte row in the aligned words that hold it).  Fewer searches share
    a block before a part goes global."""
    budget = SMEM_LIMIT // 4
    nf = NL * F
    tree = NL * (1 + -(-F // 32)) + 4 * nf + (nf + 3) // 4 + 1
    cands = K * (1 + F) + -(-K // 32) + 2 * ((K + 3) // 4 + 1)
    warps = SEARCH_WARPS
    while warps > 1 and warps * (tree + cands) > budget:
        warps //= 2
    tree = tree if warps * tree <= budget else 0
    cands = cands if warps * (tree + cands) <= budget else 0
    return warps, tree, cands


def minimal_preemptions_batch(usage0, subtree, guaranteed, borrow_cap,
                              has_blim, parent, pre_cq, wl_usage, frs_mask,
                              cand_cq, cand_delta, cand_other_cq,
                              cand_above_threshold, allow_borrowing0,
                              threshold_enabled, *, depth):
    """CUDA minimal_preemptions_batch (kernels/minimal_preemptions.cu) →
    (fitted [S] bool, target_mask [S, K] bool): a warp per search,
    ``search_layout`` deciding from the shapes what each warp stages;
    the routes taken land in ``SEARCH_ROUTES``."""
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
    warps, tree, cands = search_layout(NL, F, K)
    gusage = (None if tree else
              torch.empty((S, NL, F), dtype=i32, device=dev))
    gbits = (None if cands else
             torch.empty((S, -(-K // 32)), dtype=i32, device=dev))
    SEARCH_ROUTES.update(tree="shared" if tree else "global",
                         candidates="shared" if cands else "global")
    fitted = torch.empty(S, dtype=b, device=dev)
    mask = torch.empty((S, K), dtype=b, device=dev)
    if S == 0:
        return fitted, mask
    tensors = (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
               pre_cq, wl_usage, frs_mask, cand_cq, cand_delta,
               cand_other_cq, cand_above_threshold, allow_borrowing0,
               threshold_enabled, gusage, gbits, fitted, mask)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    dims = (ctypes.c_int * 8)(S, NL, F, K, depth, warps, tree, cands)
    _launch("minimal_preemptions_batch", lib.kq_minimal_preemptions, ptrs,
            dims)
    return fitted, mask


# -- the fused burst ---------------------------------------------------------

BURST_MIN_THREADS = 64  # warp 0 runs the scan, thread 32 the second walk
_BURST_Q_N = 6          # Q_N in burst_cycles.cu: per-member ints of a cycle
# shared bytes a burst block may give its forest state (burst_cycles.cu
# State) beside the candidate sort; past them the state lives in a global
# [G, state] row (0 forces that route)
BURST_STATE_SMEM = SMEM_LIMIT
BURST_STATIC_SMEM = 64  # the kernel's static shared bytes, rounded up
BURST_ROUTES: dict[str, str] = {}
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


def burst_threads(L: int, KC: int) -> int:
    """burst_cycles' block, sized from the forest: a thread per member
    and per compare-exchange of the candidate sort (KCP / 2), at least
    BURST_MIN_THREADS, at most MAX_THREADS (the launch function lowers
    it to what the kernel's registers allow)."""
    kcp = 1 << (KC - 1).bit_length()
    return min(MAX_THREADS, max(BURST_MIN_THREADS,
                                -(-max(L, kcp // 2) // 32) * 32))


def burst_state_ints(NN: int, L: int, F: int, S: int, R: int,
                     KCW: int) -> int:
    """The ints of one forest's state (burst_cycles.cu state_ints): four
    [NN, F] and three [NN] node planes, the [NN, F] borrow-limit bytes,
    fourteen [L, F] member planes, six [L] and the [L, 6] member facts,
    the fit slot's [L, R] columns and amounts, the CQs' [L, S, R] slot
    columns and [L, S] validity, KCW words and KC candidate bytes."""
    return (4 * NN * F + 3 * NN + 6 * L + L * _BURST_Q_N + 14 * L * F
            + 2 * L * R + L * S * R + L * S + 9 * KCW + (NN * F + 3) // 4)


def burst_cycles(*args, K, depth, L, S, KC, n_levels, G, runtime,
                 node_table=None, dflags_out=False, dflags=None):
    """CUDA burst_cycles (kernels/burst_cycles.cu): K fused admission
    cycles, one block per cohort forest.  Arguments and outputs as
    ``ops.burst.burst_cycles_plain`` (with ``dflags_out`` the [K, 4]
    int32 flag block in place of dirty and dirty_reason: ``dflags``, a
    zeroed [K, 4] int32 block on the device such as a row of the sharded
    burst's window, or a fresh one); ``node_table`` as
    ``burst_node_table`` (derived here when not given)."""
    from ..ops.burst import ARG_NAMES, NARROW_ARGS, STATE_NAMES, dirty_flags
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
    if dflags is None:
        dflags = torch.zeros((K, 4), dtype=i32, device=dev)
    _check("dflags", dflags, i32, (K, 4), dev)
    NN = fnodes.shape[1]
    threads = burst_threads(L, KC)
    state = burst_state_ints(NN, L, F, S, R, KCW)
    sort_bytes = kcp * 12 + 2 * KCW * 4
    shared = (state * 4 <= BURST_STATE_SMEM
              and sort_bytes + state * 4 <= SMEM_LIMIT - BURST_STATIC_SMEM)
    BURST_ROUTES["burst_cycles"] = "shared" if shared else "global"
    smem = sort_bytes + (state * 4 if shared else 0)
    gmap = torch.empty(N, dtype=i32, device=dev)
    gstate = None if shared else torch.empty((G, state), dtype=i32,
                                             device=dev)
    tensors = ([a[n] for n in _BURST_INPUTS] + [fnodes, fcount] + carry
               + [head_row, kind, slot, borrows, tgt_words, dflags, gmap,
                  gstate])
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    dims = (ctypes.c_int * 18)(
        C, M, R, N, F, S, L, KC, K, G, depth, n_levels, NN,
        max(0, runtime), int(a["seq_base"]), threads, state, smem)
    _launch("burst_cycles", lib.kq_burst_cycles, ptrs, dims)
    flags = (dflags,) if dflags_out else dirty_flags(dflags)
    return (head_row, kind, slot, borrows, tgt_words) + flags + (
        tuple(carry),)


# -- fair sharing --------------------------------------------------------------

FS_MAX_F = 64           # FS_MAX_F in fs_admit_scan.cu: carry in registers
FS_MIN_THREADS = 128
FS_MAX_THREADS = 256
FS_STATIC_SMEM = 1024   # the kernel's static shared words, rounded up
FS_STRIP = 16           # FS_STRIP in fs_admit_scan.cu: indices per thread


def fs_threads(F: int, max_forest: int) -> int:
    """fs_admit_scan's block size: the threads stride over a forest's
    entries, nodes and the columns, and at least FS_MIN_THREADS over
    the membership pass and the merge."""
    return min(FS_MAX_THREADS,
               max(FS_MIN_THREADS, -(-max(max_forest, F) // 32) * 32))


def fs_admit_scan(usage0, subtree, sq_mask, guaranteed, borrow_cap,
                  has_blim, parent, node_level, weights, lendable_r, onehot,
                  child_order, wl_cq, u_e, nofit, prio, ts_rank, valid,
                  forest_of_node, *, depth, n_levels, n_forests=None,
                  max_forest=None):
    """CUDA fs_admit_scan (kernels/fs_admit_scan.cu) → (order [W] int32,
    admitted [W] bool, processed [W] bool); arguments as
    ``ops.fs_scan.fs_admit_scan_plain``.  A block per cohort forest:
    ``n_forests`` (required here; ``forest_of_node`` takes values in
    [0, n_forests)) is the grid, and ``max_forest``, the most nodes of
    one forest (N when None), sizes the blocks and their shared memory.
    Each CQ holds at most one valid head, as in a cycle's heads."""
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
    if min(F, R, N) < 1:
        raise ValueError(f"F={F}, R={R} and N={N} must be at least 1")
    if n_forests is None or not 1 <= n_forests <= N:
        raise ValueError(f"n_forests={n_forests}: the kernel's grid, one "
                         f"block per cohort forest, in [1, N={N}]")
    cap = N if max_forest is None else int(max_forest)
    if not 1 <= cap <= N:
        raise ValueError(f"max_forest={max_forest} outside [1, N={N}]")
    order = torch.empty(W, dtype=i32, device=dev)
    admitted = torch.empty(W, dtype=b, device=dev)
    processed = torch.empty(W, dtype=b, device=dev)
    if W == 0:
        return order, admitted, processed
    lib = load()
    threads = fs_threads(F, cap)
    # each thread's DRS carry row: registers up to FS_MAX_F columns
    carry = (torch.empty((n_forests * threads, F), dtype=i32, device=dev)
             if F > FS_MAX_F else None)
    # a forest's work arrays (fs_admit_scan.cu FsLocal): F + 8 ints per
    # node, depth + 3 per entry; at most one head per CQ
    cap_e = min(W, cap)
    ints = cap * (F + 8) + cap_e * (depth + 3)
    smem = ints * 4
    scratch = None
    if smem > SMEM_LIMIT - FS_STATIC_SMEM:
        smem = 0
        scratch = torch.empty(N * (F + 8) + W * (depth + 3), dtype=i32,
                              device=dev)
    # per entry its rounds as key, its key and offset; the finished-block
    # count (zeroed by the launch function on the stream)
    aux = torch.empty(3 * W + 1, dtype=i32, device=dev)
    tensors = (usage0, subtree, sq_mask, guaranteed, borrow_cap, has_blim,
               parent, node_level, weights, lendable_r, onehot, child_order,
               wl_cq, u_e, nofit, prio, ts_rank, valid, forest_of_node,
               scratch, carry, aux, order, admitted, processed)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    dims = (ctypes.c_int * 11)(N, F, R, W, depth, n_levels, int(n_forests),
                               threads, cap, cap_e, smem)
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
# dynamic shared memory for a query's working set, then the sort route's
# keys and ties; each past it goes to global scratch
TAS_SMEM_SORT = 200 * 1024
# the route each level of the last launch of a descent kernel took
# (tas.cuh TasRoute: 0 not walked, 1 the warp route, 2 the sort route), a
# uint8 tensor per launcher, on the device
TAS_ROUTES: dict[str, torch.Tensor] = {}
TAS_ROUTE_NAMES = ("not walked", "warp", "sort")


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


def _array_launch(name, fn, ptrs, dims) -> None:
    """A launch whose C function takes a pointer array and an int array
    (ptrs: ints or None; tensors are passed by their data pointers)."""
    ptrs = [p.data_ptr() if isinstance(p, torch.Tensor) else p
            for p in ptrs]
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
    _array_launch("fill_counts", lib.kq_tas_fill_counts,
                  ptrs + [states.data_ptr()], dims)
    return tuple(torch.split(states, list(level_sizes)))


def _tas_query(name, entry, leaf_free, per_pod, parents, level_sizes, count,
               level, profile, descend_profile, walked):
    """One best_fit_descend / split_across_roots launch → (ok, counts);
    ``walked``: the levels the descent allocates."""
    for p in (profile, descend_profile):
        if p not in TAS_PROFILES:
            raise ValueError(f"profile {p!r}: one of {tuple(TAS_PROFILES)}")
    if not -2**31 <= count < 2**31:
        raise OverflowError(f"count={count} outside int32")
    dev = _tas_checks(leaf_free, per_pod, parents, level_sizes)
    fn = getattr(load(), entry)
    # the sort route's scratch, for whichever walked level takes it (the
    # route is decided on the device): P keys and ties of the largest
    # walked level, the segment bounds of the largest parent level
    n = max([level_sizes[d] for d in walked], default=1)
    P = 1 << max(0, n - 1).bit_length()
    Q = max([level_sizes[d - 1] for d in walked if d > 0], default=0)
    sort_bytes = 12 * P + 8 * Q
    # the working set: states of every level, then the inner levels'
    # counts and run bounds (begin, end)
    total = sum(level_sizes)
    work_ints = total + 3 * (total - level_sizes[-1])
    work = sort = None
    smem = 4 * work_ints
    if smem > TAS_SMEM_SORT:
        work = torch.empty(work_ints, dtype=torch.int32, device=dev)
        smem = 0
    if work is not None or smem + sort_bytes > TAS_SMEM_SORT:
        sort = torch.empty(sort_bytes, dtype=torch.uint8, device=dev)
    else:
        smem += sort_bytes
    flags = torch.empty(1 + TAS_MAX_LEVELS, dtype=torch.uint8, device=dev)
    out = torch.empty(level_sizes[-1], dtype=torch.int32, device=dev)
    ptrs, dims = _tas_tree(leaf_free, per_pod, parents, level_sizes)
    ptrs += [work, sort, flags, out]
    dims += [count, level, TAS_PROFILES[profile],
             TAS_PROFILES[descend_profile], P, sort_bytes, smem]
    _array_launch(name, fn, ptrs, dims)
    TAS_ROUTES[name] = flags[1:1 + len(level_sizes)]
    return flags[:1].view(torch.bool)[0], out


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


# -- the one-call cycle solver's phase 1 ----------------------------------

# kq_cycle_order: the registers route sorts P = max(128, 2^k >= W) keys,
# E a thread (4 up to 4,096, 8 at 8,192, 16 at 16,384 = ORDER_CHIP_MAX),
# its key buffers (two, 24 P bytes; one, 12 P, at E = 16) in shared
# memory while they fit in SORT_SMEM; wider, or with SORT_SMEM = 0, the
# global route (2 P int64 of scratch)
SORT_SMEM = SMEM_LIMIT
ORDER_CHIP_MAX = 16384      # KQ_ORDER_CHIP_MAX in solve_cycle.cu
ORDER_MIN_KEYS = 128        # one warp of four keys a lane
# kq_classify_heads: a head's S slots share a group of lanes (S rounded up
# to a power of two), a lane a slot, while S <= CLASSIFY_LANES (at most
# 32); past it (0: always) a warp per head loops over chunks of 32 slots
CLASSIFY_LANES = 32
# kq_cq_avail: each block stages parent[] in shared memory while its 4 N
# bytes fit in the 48 KB a block gets without the opt-in (the staged
# route), else the chain is walked from global memory (the global route)
AVAIL_STAGE_MAX = 12288     # KQ_AVAIL_STAGE_MAX in solve_cycle.cu
# the route of each phase-1 kernel's last launch: kq_cq_avail's "staged"
# or "global", kq_cycle_order's "registers" or "global",
# kq_classify_heads' "group" or "loop"
PHASE1_ROUTES: dict[str, str] = {}


def classify_layout(S: int) -> tuple[int, bool]:
    """(lanes per head, the loop route) of kq_classify_heads for S
    slots."""
    if S <= min(CLASSIFY_LANES, 32):
        return 1 << max(0, S - 1).bit_length(), False
    return 32, True


def cq_avail_route(N: int) -> str:
    """kq_cq_avail's route for N nodes: "staged" or "global"."""
    return "staged" if N <= AVAIL_STAGE_MAX else "global"


def cq_avail_segment(depth: int) -> int:
    """Levels of a chain segment on kq_cq_avail's staged route (the
    kernel's template argument S): the depth rounded up to 1, 2, 4, 8 or
    16, at most 16 (deeper chains run in several segments)."""
    return min(16, 1 << max(0, depth - 1).bit_length())


def order_layout(W: int) -> tuple[int, int, int]:
    """(P, keys a thread E, shared bytes) of kq_cycle_order at W heads:
    E = 0 is the global route, whose P is the power of two >= W."""
    P = 1 << max(0, W - 1).bit_length()
    chip = max(P, ORDER_MIN_KEYS)
    E = 4 if chip <= 4096 else 8 if chip <= 8192 else 16
    smem = (24 if E < 16 else 12) * chip
    if chip > ORDER_CHIP_MAX or smem > SORT_SMEM:
        return P, 0, 0
    return chip, E, smem if chip > 32 * E else 0


def kq_cq_avail(usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
                *, n_cqs, depth):
    """CUDA available() of the CQ rows (kernels/solve_cycle.cu) →
    (avail0 [C, F], potential0 [C, F]) int32; arguments as
    ``ops.cycle.cq_avail_plain``.  The staged route or the global one,
    by N alone (``cq_avail_route``); the route lands in
    ``PHASE1_ROUTES``."""
    dev = usage0.device
    if dev.type != "cuda":
        raise ValueError(f"usage0 on {dev}: the kernels need CUDA tensors")
    N, F = usage0.shape if usage0.dim() == 2 else (-1, -1)
    i32 = torch.int32
    for nm, t in (("usage0", usage0), ("subtree", subtree),
                  ("guaranteed", guaranteed), ("borrow_cap", borrow_cap)):
        _check(nm, t, i32, (N, F), dev)
    _check("has_blim", has_blim, torch.bool, (N, F), dev)
    _check("parent", parent, i32, (N,), dev)
    _check_depth(depth)
    C = int(n_cqs)
    if not 0 <= C <= N:
        raise ValueError(f"n_cqs={C} outside [0, N={N}]")
    avail = torch.empty((C, F), dtype=i32, device=dev)
    potential = torch.empty((C, F), dtype=i32, device=dev)
    route = cq_avail_route(N)
    PHASE1_ROUTES["kq_cq_avail"] = route
    if C * F == 0:
        return avail, potential
    _array_launch("kq_cq_avail", load().kq_cq_avail,
                  [usage0, subtree, guaranteed, borrow_cap, has_blim,
                   parent, avail, potential],
                  [N, F, C, depth,
                   cq_avail_segment(depth) if route == "staged" else 0])
    return avail, potential


def kq_classify_heads(wl_cq, wl_requests, start_slot, slot_fr, slot_valid,
                      nominal_cq, usage0, subtree, parent,
                      cq_can_preempt_borrow, cq_wcb_borrow, cq_wcp_preempt,
                      avail0, potential0, *, pairs):
    """CUDA per-head classify (kernels/solve_cycle.cu) → (fit_slot0 [W]
    int32, borrows0 [W] bool, preempt0 [W] bool) and, with ``pairs``,
    (dec_fr [W, R] int32, dec_amt [W, R] int32, fit_mask [W] bool);
    arguments as ``ops.cycle.classify_heads_plain``.  A group of lanes
    per head, a lane a slot, or a warp per head looping over chunks of
    slots (``classify_layout``); the route lands in
    ``PHASE1_ROUTES``."""
    dev = wl_cq.device
    if dev.type != "cuda":
        raise ValueError(f"wl_cq on {dev}: the kernels need CUDA tensors")
    i32, b = torch.int32, torch.bool
    W = wl_cq.shape[0]
    C, S, R = slot_fr.shape if slot_fr.dim() == 3 else (-1, -1, -1)
    N, F = usage0.shape if usage0.dim() == 2 else (-1, -1)
    _check("wl_cq", wl_cq, i32, (W,), dev)
    _check("wl_requests", wl_requests, i32, (W, R), dev)
    _check("start_slot", start_slot, i32, (W,), dev)
    _check("slot_fr", slot_fr, i32, (C, S, R), dev)
    _check("slot_valid", slot_valid, b, (C, S), dev)
    _check("nominal_cq", nominal_cq, i32, (C, F), dev)
    _check("usage0", usage0, i32, (N, F), dev)
    _check("subtree", subtree, i32, (N, F), dev)
    _check("parent", parent, i32, (N,), dev)
    for nm, t in (("cq_can_preempt_borrow", cq_can_preempt_borrow),
                  ("cq_wcb_borrow", cq_wcb_borrow),
                  ("cq_wcp_preempt", cq_wcp_preempt)):
        _check(nm, t, b, (C,), dev)
    _check("avail0", avail0, i32, (C, F), dev)
    _check("potential0", potential0, i32, (C, F), dev)
    if min(C, S, R, F) < 1 or C > N:
        raise ValueError(f"classify needs C, S, R, F >= 1 and C <= N "
                         f"(C={C}, S={S}, R={R}, F={F}, N={N})")
    fit_slot0 = torch.empty(W, dtype=i32, device=dev)
    borrows0 = torch.empty(W, dtype=b, device=dev)
    preempt0 = torch.empty(W, dtype=b, device=dev)
    outs = [fit_slot0, borrows0, preempt0]
    if pairs:
        outs += [torch.empty((W, R), dtype=i32, device=dev),
                 torch.empty((W, R), dtype=i32, device=dev),
                 torch.empty(W, dtype=b, device=dev)]
    lanes, loop = classify_layout(S)
    PHASE1_ROUTES["kq_classify_heads"] = "loop" if loop else "group"
    if W == 0:
        return tuple(outs)
    _array_launch("kq_classify_heads", load().kq_classify_heads,
                  [wl_cq, wl_requests, start_slot, slot_fr, slot_valid,
                   nominal_cq, usage0, subtree, parent,
                   cq_can_preempt_borrow, cq_wcb_borrow, cq_wcp_preempt,
                   avail0, potential0, *outs] + [None] * (6 - len(outs)),
                  [W, S, R, F, lanes, int(loop)])
    return tuple(outs)


def kq_cycle_order(borrows0, priority, timestamp):
    """CUDA stable cycle order (kernels/solve_cycle.cu) → order [W] int32;
    arguments as ``ops.cycle.cycle_order_plain`` (timestamp float32).
    The registers route or the global one (``order_layout``); the route
    lands in ``PHASE1_ROUTES``."""
    dev = borrows0.device
    if dev.type != "cuda":
        raise ValueError(f"borrows0 on {dev}: the kernels need CUDA tensors")
    W = borrows0.shape[0]
    _check("borrows0", borrows0, torch.bool, (W,), dev)
    _check("priority", priority, torch.int32, (W,), dev)
    _check("timestamp", timestamp, torch.float32, (W,), dev)
    if W >= 2**31 - 1:
        raise ValueError(f"W={W} heads: the sort's index is 32 bits")
    order = torch.empty(W, dtype=torch.int32, device=dev)
    P, E, smem = order_layout(W)
    PHASE1_ROUTES["kq_cycle_order"] = "registers" if E else "global"
    if W == 0:
        return order
    scratch = (None if E else
               torch.empty(2 * P, dtype=torch.int64, device=dev))
    _array_launch("kq_cycle_order", load().kq_cycle_order,
                  [borrows0, priority, timestamp, scratch, order],
                  [W, P, E, smem])
    return order


# -- the forest-sharded burst: resident row scatter, dirty-flag reduction ---

SCATTER_MAX_PLANES = 16     # KQ_SCATTER_MAX_PLANES in scatter_rows.cu


def kq_scatter_rows(planes, buf, count):
    """CUDA row scatter (kernels/scatter_rows.cu), in place:
    ``planes[p][rows[i]] = vals[p][i]`` for every plane p, all planes in
    one launch, a warp a (row, plane); returns ``planes`` as a tuple.
    Arguments as ``parallel.sharded.scatter_rows_plain``: planes [n, ...]
    of any dtype on one CUDA device, and ``buf`` the uint8 buffer of
    ``count`` rows and their values that ``ops.packing.
    pack_scatter_rows`` packs for them, 16-byte aligned, on that
    device."""
    from ..ops.packing import scatter_layout
    planes = tuple(planes)
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"buf on {dev}: the kernels need CUDA tensors")
    P = len(planes)
    if not 1 <= P <= SCATTER_MAX_PLANES:
        raise ValueError(f"{P} planes: 1 to {SCATTER_MAX_PLANES}")
    count = int(count)
    n = planes[0].shape[0]
    offsets, row_bytes, total = scatter_layout(planes, count)
    _check("buf", buf, torch.uint8, (total,), dev)
    if buf.data_ptr() % 16:
        raise ValueError("buf: not 16-byte aligned")
    for k, pl in enumerate(planes):
        _check(f"planes[{k}]", pl, pl.dtype, (n,) + tuple(pl.shape[1:]), dev)
    if count == 0 or n == 0:
        return planes
    if total >= 2**31:
        raise ValueError(f"a {total}-byte buffer: offsets are 32 bits")
    _array_launch("kq_scatter_rows", load().kq_scatter_rows,
                  [*planes, buf], [P, count, n, *offsets, *row_bytes])
    return planes


def kq_reduce_dflags(window):
    """CUDA sum over s of a sharded burst window's [S, K, 4] int32
    dirty-flag rows (kernels/scatter_rows.cu) → [K, 4] int32 on its
    device; arguments as ``parallel.sharded.reduce_dflags_plain``.  The
    kernel reads 16-byte rows, so the window starts 16-byte aligned."""
    dev = window.device
    if dev.type != "cuda":
        raise ValueError(f"window on {dev}: the kernels need CUDA tensors")
    S, K = window.shape[:2] if window.dim() == 3 else (-1, -1)
    _check("window", window, torch.int32, (S, K, 4), dev)
    if S < 1:
        raise ValueError("the window needs at least one shard's row")
    if window.data_ptr() % 16:
        raise ValueError("window: not 16-byte aligned")
    out = torch.empty((K, 4), dtype=torch.int32, device=dev)
    if K == 0:
        return out
    _launch("kq_reduce_dflags", load().kq_reduce_dflags, _ptr(window),
            _ptr(out), S, K)
    return out


# -- the per-cycle mesh: head gather, fair-sharing round merge --------------

MESH_MAX_SHARDS = 32        # KQ_MESH_MAX_SHARDS in mesh_gather.cu
MERGE_SMEM = 48 * 1024      # KQ_MERGE_SMEM: the merge's working set
SRC_SHIFT = 26              # KQ_SRC_SHIFT: src[w] = slot << 26 | row
GATHER_SLOTS = 256          # the largest argument table of the gather


def _mesh_maps(head_of, dev):
    S = len(head_of)
    if not 1 <= S <= MESH_MAX_SHARDS:
        raise ValueError(f"{S} shards: 1 to {MESH_MAX_SHARDS}")
    for s, h in enumerate(head_of):
        n = h.shape[0] if h.dim() == 1 else -1
        _check(f"head_of[{s}]", h, torch.int32, (n,), dev)
    return [int(h.shape[0]) for h in head_of]


def kq_gather_heads(planes, src, fills):
    """CUDA head gather (kernels/mesh_gather.cu) by a source map, one
    launch for all planes → a tuple of [W] tensors: ``out[p][w] =
    planes[p][l][r]`` where ``src[w] = l << SRC_SHIFT | r``, ``fills[p]``
    where ``src[w]`` is -1.  Arguments as
    ``parallel.sharded.gather_src_plain``: planes[p] holds one block
    [W_l] per slot l of the map (bool or int32, one dtype per plane) on
    src's CUDA device, ``src`` [W] int32 (``CycleShardLayout.heads``
    builds it; ``parallel.sharded.source_map`` from the maps).  The
    launch's argument table holds the P x L block pointers, the L block
    lengths, the P outputs and the P fills, and no more."""
    planes = tuple(tuple(b) for b in planes)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"src on {dev}: the kernels need CUDA tensors")
    W = src.shape[0] if src.dim() == 1 else -1
    _check("src", src, torch.int32, (W,), dev)
    P = len(planes)
    if P < 1 or len(fills) != P:
        raise ValueError(f"{P} planes and {len(fills)} fills: one fill "
                         f"per plane, at least one plane")
    L = len(planes[0])
    if not 1 <= L <= MESH_MAX_SHARDS:
        raise ValueError(f"{L} blocks per plane: 1 to {MESH_MAX_SHARDS}")
    n = [int(b.shape[0]) if b.dim() == 1 else -1 for b in planes[0]]
    if max(n) >= 1 << SRC_SHIFT:
        raise ValueError(f"a block of {max(n)} heads: the source map "
                         f"holds rows below 2^{SRC_SHIFT}")
    n_slots = P * L + L + 2 * P
    if n_slots > GATHER_SLOTS:
        raise ValueError(f"{P} planes x {L} blocks need {n_slots} table "
                         f"slots, more than {GATHER_SLOTS}")
    outs, wide = [], 0
    for k, blocks in enumerate(planes):
        if len(blocks) != L:
            raise ValueError(f"planes[{k}]: {len(blocks)} blocks, planes[0]"
                             f" {L}")
        dtype = blocks[0].dtype
        if dtype not in (torch.bool, torch.int32):
            raise TypeError(f"planes[{k}]: dtype {dtype}, expected bool "
                            f"or int32")
        for l, b in enumerate(blocks):
            _check(f"planes[{k}][{l}]", b, dtype, (n[l],), dev)
        wide |= int(dtype == torch.int32) << k
        outs.append(torch.empty(W, dtype=dtype, device=dev))
    if W == 0:
        return tuple(outs)
    slots = ([b.data_ptr() for blocks in planes for b in blocks] + n
             + [o.data_ptr() for o in outs] + [int(f) for f in fills])
    _launch("kq_gather_heads", load().kq_gather_heads,
            (ctypes.c_longlong * n_slots)(*slots), n_slots, _ptr(src), W,
            P, L, wide)
    return tuple(outs)


def kq_fs_merge_order(winners, head_of, W: int):
    """CUDA merge of the shards' fair-sharing winner sequences
    (kernels/mesh_gather.cu) → order [W] int32 of global head indices, -1
    past the last round.  Arguments as
    ``parallel.sharded.fs_merge_order_plain``: winners[s] [W_s] int32
    local ids into shard s's ascending head list head_of[s] [W_s] (-1
    past its last round; the ids before it distinct).  Each emission is
    placed by its rank among the shards' sorted keys; the keys, winners,
    heads and marks (13 bytes a head) sit in shared memory up to
    ``MERGE_SMEM``, past it in global scratch."""
    winners, head_of = tuple(winners), tuple(head_of)
    dev = head_of[0].device if head_of else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"head_of on {dev}: the kernels need CUDA tensors")
    n = _mesh_maps(head_of, dev)
    if len(winners) != len(head_of):
        raise ValueError(f"{len(winners)} winner sequences for "
                         f"{len(head_of)} shards")
    for s, w in enumerate(winners):
        _check(f"winners[{s}]", w, torch.int32, (n[s],), dev)
    order = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return order
    E = sum(n)
    scratch = (torch.empty(3 * E + -(-E // 4), dtype=torch.int32,
                           device=dev)
               if 13 * E > MERGE_SMEM else None)
    _array_launch("kq_fs_merge_order", load().kq_fs_merge_order,
                  [*winners, *head_of, scratch, order], [len(n), W, *n])
    return order
