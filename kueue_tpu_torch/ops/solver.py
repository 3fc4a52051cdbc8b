"""Host wrapper for the device cycle solver.

Per cycle the solver:

1. packs (snapshot, heads) against a CACHED ``PackedStructure`` — the
   static cluster tensors are rebuilt only when the cache structure
   generation changes (and uploaded to the device once per structure),
   so the per-cycle cost is O(usage + heads);
2. runs the vectorized nominate (``ops.cycle.classify_np``) on the host
   for heads whose shape the batched math covers (single resource group,
   single PodSet, plain flavors); the remaining heads are marked SCALAR —
   the scheduler runs the real host FlavorAssigner walk for those few and
   attaches the resulting assignment, so multi-resource-group CQs,
   multi-PodSet workloads, taints/affinity, fungibility resume state and
   partial admission all stay inside a device-decided cycle;
3. launches ONE admit-scan kernel per cycle on the solver's device —
   ``admit_scan``, ``admit_scan_forests`` (>= 64 heads over several
   cohort forests) or ``admit_scan_preempt`` (preempt heads with targets)
   — unless a decision-identical shortcut proves the launch unnecessary.
   The scan consumes per-head (flavor-resource, amount) decision pairs —
   the assignment.Usage map the reference admit loop re-checks
   (scheduler.go:372) — so HOW a head was classified is invisible to the
   kernel.

``device="cuda"`` (the default) runs the hand-written CUDA kernels and
raises when no GPU is present; ``device="cpu"`` runs their plain PyTorch
versions.  The solver falls back entirely (classify returns None) for
inexact int32 scaling, unrepresentable packs and scalar assignments
whose usage can't be encoded exactly — the host path then runs, keeping
decisions bit-identical.

Fair-sharing cycles whose heads are all vector-classified and none
preempt-capable run the whole tournament + admit loop as one
``fs_admit_scan`` launch (``dispatch_fs``; the CUDA kernel
``kernels/fs_admit_scan.cu`` on "cuda").

``backend="native"`` runs the classify (first-fit FlavorFungibility
only; other policies and resumed walks take ``classify_np``, counted in
``native_ff_fallbacks``) and the admit loop of cycles without preempting
heads in the compiled C++ core (``kueue_tpu_torch/native``, host numpy);
cycles with preempting heads keep the device's ``admit_scan_preempt``.

The route of each admit scan (``choose_route``) follows ``backend``:
"auto" (the default) and "accel" launch on the solver's device at every
dispatch, the card's kernels on "cuda"; "native" as above.  On a CPU
solver, "cpu" (the device's name) is "accel", and a calibrated "auto"
picks, per (kernel, W, max_forest_wl) bucket, the faster of the plain
version and the C++ admit loop as ``warmup`` measured them (flat and
forest scans only).  On a card "auto" never leaves it: the warm-up's
table there is a measurement (``fastest_route`` names each bucket's
winner), and the C++ loop runs only when asked for by name.
``warmup`` also measures the round trip of ``kq_add_one`` (``rtt_s``),
launches every kernel once at each shape rung the run can reach, and
persists the table as a sidecar (``compilecache``) that a later process
with the same fingerprint loads instead of measuring.

``set_mesh(mesh)`` (a ``parallel.sharded.CycleMesh``; the Driver sets
one under ``KUEUE_TPU_SHARDS=n``) routes every admit scan and
fair-sharing scan that a shortcut does not prove unnecessary through the
mesh, ahead of the native route: the structure's cohort forests are
partitioned over the ``cq`` axis (``CycleShardLayout``, cached on the
structure per mesh), each shard's kernel runs on its own device and
stream, and ``kq_gather_heads`` (with ``kq_fs_merge_order`` for fair
sharing) rebuilds the head-order outputs.  The fused burst shards on
its own mesh (``ops.burst.BurstSolver.set_shards``).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..api.types import FlavorFungibilityPolicy
from ..cache.snapshot import Snapshot
from ..workload import Info, Ordering
from ..scheduler.flavorassigner import (
    Assignment,
    AssignmentClusterQueueState,
    FlavorAssignmentDecision,
    Mode,
    PodSetAssignmentResult,
)
from ..resources import FlavorResource, Requests
from .packing import (PackedCycle, PackedStructure, _bucket, coarse_bucket,
                      pack_cycle, pack_structure, planes_to_torch)
from .cycle import (admit_scan, admit_scan_forests, admit_scan_preempt,
                    classify_np, cycle_order_np, decision_pairs_from_slots,
                    join_target_forests)


# The flat admit scan decides one head per step; the forest-parallel
# kernel runs one block per cohort forest.  Below this head count the
# flat scan is used (the same gate as the JAX package's solver, so both
# packages launch the same kernel for the same cycle).
_FOREST_MIN_HEADS = 64

# coarse shape ladders for the preempt scan's target tensors (kept from
# the JAX package, where each rung was one XLA compilation; the padding
# does not change any decision)
T_LADDER = (64, 512, 4096)
MT_LADDER = (4, 16)


@dataclass
class ClassifiedCycle:
    """Phase-1 output: fixed per-head assignments for one cycle."""
    packed: PackedCycle
    heads: list[Info]
    snapshot: Snapshot
    fit_slot0: np.ndarray        # [W] int32, -1 = no fit
    borrows0: np.ndarray         # [W] bool
    preempt0: np.ndarray         # [W] bool (no fit, preempt-capable)
    preempt_slot0: np.ndarray    # [W] int32
    preempt_borrows0: np.ndarray  # [W] bool
    preempt_res_fit: np.ndarray  # [W, R] bool
    preempt_slot_count: np.ndarray = None  # [W] int32 preempt-capable slots
    preempt_stopped0: np.ndarray = None    # [W] bool: the fungibility walk
                                           # policy-stopped ON the preempt
                                           # slot (choice is final — no
                                           # reclaim-oracle dependence)
    # heads the vectorized math can't classify: the scheduler runs the
    # host FlavorAssigner walk for these and attaches the assignment
    scalar_mask: np.ndarray = None         # [W] bool
    host_assignments: dict = None          # {wi: Assignment}
    host_pairs: dict = None                # {wi: [(F-index, amount)]}

    @property
    def n(self) -> int:
        return self.packed.wl_count


@dataclass
class PackedTargets:
    """Per-cycle preemption-target tensors for the admit scan."""
    preempt_mask: np.ndarray     # [W] bool
    tgt_mat: np.ndarray          # [W, MT] int32 universe indices, -1 pad
    tu_cq: np.ndarray            # [T] int32 node index
    tu_delta: np.ndarray         # [T, F] int32 scaled usage


@dataclass
class DeviceCycleFinal:
    """Full-cycle device decisions, in cycle order."""
    order: np.ndarray            # [n] head indices, cycle order
    admitted: np.ndarray         # [n] bool (head order)
    reserve_mask: np.ndarray     # [n] bool (head order)
    preempting: np.ndarray = None    # [n] bool: issued preemptions
    overlap_skip: np.ndarray = None  # [n] bool: overlapping targets


@dataclass
class DispatchHandle:
    """An in-flight admit scan: the dispatch has been issued (or decided
    unnecessary) and the host is free to do per-head work while the device
    executes; ``CycleSolver.fetch`` blocks for the decisions."""
    order: np.ndarray
    rmask: np.ndarray            # [W] bool
    n: int
    pending: object = None       # tensor(s) still in flight, or None
    admitted: Optional[np.ndarray] = None  # resolved decisions [W]
    preempting: Optional[np.ndarray] = None
    overlap_skip: Optional[np.ndarray] = None
    fit_mask: Optional[np.ndarray] = None  # [W] bool: vector + scalar fits
    route: str = ""   # "cuda" | "cpu" | "sharded" | "native" | "no_fit"
                      # | "singleton" (the route of a scan: choose_route)
    errors: list = field(default_factory=list)  # admit_scan_preempt's
                      # error words, read by ``fetch``


# static structure planes the admit scans read, uploaded once per structure
_STATIC_PLANES = ("subtree_quota", "guaranteed", "borrow_cap",
                  "has_borrow_limit", "parent", "nominal_cq",
                  "nominal_plus_blimit_cq", "forest_of_node")


# Calibration sidecar schema: bump whenever the table's key layout or
# the measurement protocol changes, so a sidecar written by an older
# build is rejected (re-measured) instead of mis-routing cycles.
CALIB_SCHEMA = 1

# the admit scans the router may send to the C++ loop
_NATIVE_KINDS = ("flat", "forest")


def fastest_route(calibration: dict, device_type: str, kind: str, W: int,
                  mfw: Optional[int]) -> str:
    """The measured faster of the device's kernel (``device_type``) and
    the C++ admit loop ("native") for one flat or forest bucket; the
    device when the bucket has no native entry.

    ``calibration`` is ``{(route, kind, W, key_len): seconds}`` as
    ``CycleSolver.warmup`` fills it; ``mfw`` the forest scan's bucket
    (None for the flat scan).  A forest bucket past the warm-up's ladder
    takes the largest time recorded for the route's forest scans at W
    (the JAX solver's dispatch, kueue_tpu/ops/solver.py:1056-1062)."""
    key_len = mfw if mfw is not None else W

    def lookup(route):
        t = calibration.get((route, kind, W, key_len))
        if t is None and kind == "forest":
            t = max((v for k, v in calibration.items()
                     if k[:3] == (route, "forest", W)), default=None)
        return t

    t_nat = lookup("native")
    if t_nat is None:
        return device_type
    t_dev = lookup(device_type)
    return "native" if t_dev is None or t_nat < t_dev else device_type


def choose_route(calibration: dict, device_type: str, backend: str,
                 kind: str, W: int, mfw: Optional[int]) -> str:
    """The route of one scan dispatch: "native" (the C++ admit loop) or
    the type of the solver's device ("cuda" for the card's kernels,
    "cpu" for the plain versions on a CPU solver).

    ``kind`` is "flat", "forest", "preempt" (a cycle with preempting
    heads) or "fs".  Preempt and fair-sharing scans run on the device
    under every backend; "native" takes the flat and forest scans.
    "auto" on a CPU solver takes ``fastest_route``'s pick (the JAX
    router's on a CPU-only JAX); on a card it stays on the card, so the
    work never moves to the host while the device is a card."""
    if kind not in _NATIVE_KINDS or backend == "accel":
        return device_type
    if backend == "native":
        return "native"
    if device_type != "cpu":
        return device_type
    return fastest_route(calibration, device_type, kind, W, mfw)


def resolve_backend(backend: str, device: torch.device) -> str:
    """The solver's backend: "auto", "accel" or "native", with the
    device's own name ("cuda", "cuda:0", "cpu" on a CPU solver) an alias
    of "accel"; anything else raises."""
    if backend in CycleSolver.BACKENDS:
        return backend
    if backend in (device.type, str(device)):
        return "accel"
    raise ValueError(f"backend {backend!r}: one of {CycleSolver.BACKENDS} "
                     f"or the device's name ({device.type!r})")


# warm-up's repetitions of every timed route: the median of three, so one
# slow call cannot decide a bucket (the median of two is their mean)
_REPS = 3


def _median_wall(fn, reps: int) -> float:
    """The median wall seconds of ``reps`` calls of ``fn``."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def resolve_device(device) -> torch.device:
    """The solver's device; "cuda" without a usable GPU raises — the port
    never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA GPU is available; pass "
                "device='cpu' to run the plain PyTorch kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class CycleSolver:
    """Batched solver for the admission cycle on one device.

    Every dispatch on "cuda" launches a hand-written CUDA kernel; "cpu"
    runs the same function's plain PyTorch version, "native" the C++
    admit loop.  Identical decisions on every route."""

    BACKENDS = ("auto", "accel", "native")

    def __init__(self, ordering: Ordering | None = None,
                 device: str = "cuda", backend: str = "auto"):
        self.ordering = ordering or Ordering()
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        # Disjoint cycle counters: every cycle with heads lands in exactly
        # one of full/classify/host (the scheduler increments them).
        self.stats = {
            "full_cycles": 0,         # fully device-decided cycles
            "fs_full_cycles": 0,      # fair-sharing cycles decided in-scan
            "fs_noop_skips": 0,       # FS cycles with no fit head: the
                                      # tournament dispatch was skipped
            "fs_noop_reuses": 0,      # no-op FS cycles whose per-head
                                      # walks were fingerprint-reused
            "classify_cycles": 0,     # device nominate + host admit loop
            "host_cycles": 0,         # pure host fallback (classify=None)
            "reserve_entries": 0,
            # dispatch routing within full cycles (also disjoint):
            "cuda_dispatches": 0,     # admit kernel launched on the card
            "cpu_dispatches": 0,      # plain PyTorch scan on the CPU
            "native_dispatches": 0,   # admit loop in the C++ core
            "native_ff_fallbacks": 0,  # native classify → classify_np
            "native_calibration_failures": 0,  # warm-up's native timing
            "skipped_dispatches": 0,  # no fit head -> scan provably no-op
            "singleton_dispatches": 0,  # <=1 entry/forest -> no contention
            "structure_rebuilds": 0,
            "calibration_loaded": 0,    # router table read from a sidecar
            "calibration_rejected": 0,  # sidecar of another schema or
                                        # fingerprint: measured again
            "scalar_heads": 0,        # heads classified by the host walk
            # flavor-walk telemetry (heterogeneous fast path):
            "scalar_reasons": {},     # {reason: count} for scalar heads
            "resume_heads": 0,        # heads entering the walk mid-list
            "walk_stop_heads": 0,     # heads whose walk policy-stopped
            # per-kernel CUDA launches (process-wide, kernels.LAUNCHES);
            # device times come from profiling.DeviceClock, not from here
            "kernel_launches": {},
        }
        self._structure: Optional[PackedStructure] = None
        self._potential0 = None
        # optional parallel.sharded.CycleMesh: when set, the admit and
        # fair-sharing scans run forest-sharded over it (set_mesh)
        self.mesh = None
        self._sharded_fns: dict = {}
        # measured per-route admit-scan wall times, filled by warmup:
        # {(route, kind, W, key_len): seconds}
        self.calibration: dict[tuple, float] = {}
        self.rtt_s: Optional[float] = None  # kq_add_one's round trip

    # -- device planes -------------------------------------------------

    def _device_planes(self, st: PackedStructure) -> dict:
        """The structure's static planes on the solver's device (cached
        on the structure: uploaded once per structure generation)."""
        planes = getattr(st, "_device_planes", None)
        if planes is None:
            planes = planes_to_torch(
                {k: getattr(st, k) for k in _STATIC_PLANES}, self.device)
            st._device_planes = planes
        return planes

    def _fs_planes(self, st: PackedStructure, statics) -> dict:
        """The fair-sharing statics and weights on the solver's device,
        and the most nodes of one forest (cached on the structure, like
        ``_device_planes``)."""
        planes = getattr(st, "_fs_device_planes", None)
        if planes is None:
            from .fs_scan import fs_statics_to_torch
            planes = fs_statics_to_torch(statics, self.device)
            planes["weights"] = torch.from_numpy(
                np.ascontiguousarray(st.fair_weight_milli)).to(self.device)
            # the fs kernel's block size: the most nodes of one forest
            planes["max_forest"] = int(np.bincount(st.forest_of_node).max())
            st._fs_device_planes = planes
        return planes

    def _to_device(self, *arrays) -> list:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _scan_args(self, st: PackedStructure, *per_cycle) -> tuple:
        """The 16 leading arguments of the admit scans on the solver's
        device: the cycle's (usage0, wl_cq, dec_fr, dec_amt, fit_mask,
        res_fr, res_amt, res_mask, res_borrows) uploaded, the statics
        cached."""
        planes = self._device_planes(st)
        (usage0, wl_cq, dec_fr, dec_amt, fit, res_fr, res_amt, rmask,
         res_borrows) = self._to_device(*per_cycle)
        return (usage0, planes["subtree_quota"], planes["guaranteed"],
                planes["borrow_cap"], planes["has_borrow_limit"],
                planes["parent"], planes["nominal_cq"],
                planes["nominal_plus_blimit_cq"], wl_cq, dec_fr, dec_amt,
                fit, res_fr, res_amt, rmask, res_borrows)

    def _collect_kernel_stats(self) -> None:
        if self.device.type != "cuda":
            return
        from .. import kernels
        self.stats["kernel_launches"] = dict(kernels.LAUNCHES)

    def set_mesh(self, mesh) -> None:
        """Route the admit scans and the fair-sharing scan through the
        mesh-sharded programs (``parallel.sharded.admit_scan_fns`` /
        ``fs_scan_fn``); None routes them back to the solver's device."""
        self.mesh = mesh
        self._sharded_fns = {}
        for k in ("sharded_dispatches", "sharded_preempt_dispatches",
                  "sharded_fs_dispatches", "sharded_empty_shards"):
            self.stats.setdefault(k, 0)
        # {kernel: [launches of shard j]}: one per shard with heads
        self.stats.setdefault("sharded_shard_launches", {})

    def _count_shards(self, layout, kernel: str) -> None:
        row = self.stats["sharded_shard_launches"].setdefault(
            kernel, [0] * layout.n_shards)
        for j in layout.live:
            row[j] += 1
        self.stats["sharded_empty_shards"] += layout.empty_shards

    def _sharded_for(self, depth: int) -> dict:
        fns = self._sharded_fns.get(depth)
        if fns is None:
            from ..parallel.sharded import admit_scan_fns
            fns = admit_scan_fns(self.mesh, depth)
            self._sharded_fns[depth] = fns
        return fns

    def _mesh_pad(self, st: PackedStructure):
        """The structure's ``CycleShardLayout`` over the mesh's ``cq``
        axis, cached on the structure per mesh (a rebuilt structure gets
        a new one, with fresh device statics).  The JAX solver's
        ``_mesh_pad`` (and its ``_pad_rows``) pads nodes and heads to
        mesh-divisible sizes for GSPMD; a partition of whole forests
        needs no padding, and this layout takes its place."""
        cached = getattr(st, "_mesh_layout", None)
        if cached is None or cached[0] is not self.mesh:
            from ..parallel.sharded import CycleShardLayout
            layout = CycleShardLayout(
                st.parent, len(st.cq_names), self.mesh.shape["cq"],
                st.forest_of_node)
            st._mesh_layout = cached = (self.mesh, layout)
        return cached[1]

    def warmup(self, snapshot: Snapshot, max_heads: int) -> None:
        """One-time setup outside the hot loop (the JAX solver's warmup,
        kueue_tpu/ops/solver.py:352-589): on "cuda", build (when stale)
        and load the kernel library and time ``kq_add_one``'s round trip
        (``rtt_s``); upload the structure's static planes; then, for every
        head-count bucket up to ``max_heads``, launch the device's admit
        scans and record their steady-state wall time (upload, launch,
        readback; the median of 3 reps on every route), time
        the C++ admit loop beside them under "auto", and launch the
        padded-K, preempt (T, MT) and search (S, K) rungs once each, so
        that no live cycle pays a first launch.  A sidecar with
        this fingerprint (``compilecache``) replaces the measurement;
        the launches still run.  Shapes only: no scheduling state is
        touched."""
        from .. import compilecache
        if self.device.type == "cuda":
            from .. import kernels
            from .rtt import round_trip_s
            kernels.load()
            self.rtt_s = round_trip_s(self.device)
        st = self._structure_for(snapshot, [])
        fp_src = self._fingerprint(st, max_heads)
        calib_name = ("calibration-"
                      f"{hashlib.sha1(fp_src.encode()).hexdigest()[:16]}.json")
        loaded = compilecache.load_json(calib_name)
        if loaded is not None and (
                loaded.get("schema") != CALIB_SCHEMA
                or loaded.get("fingerprint") != fp_src):
            # a sidecar from another build, card or structure (or a hash
            # collision) would route by numbers measured elsewhere
            self.stats["calibration_rejected"] = 1
            loaded = None
        measure = loaded is None
        if not measure:
            self.calibration.update(
                {tuple(k): v for k, v in loaded.get("calibration", [])})
            self.stats["calibration_loaded"] = 1
        W = 8
        while True:
            self._warm_bucket(st, W, measure)
            if W >= _bucket(max_heads):
                break
            W *= 2
        self._warm_search(st, max_heads)
        if measure:
            compilecache.save_json(calib_name, {
                "schema": CALIB_SCHEMA, "fingerprint": fp_src,
                "calibration": [[list(k), v]
                                for k, v in self.calibration.items()]})

    def _fingerprint(self, st: PackedStructure, max_heads: int) -> str:
        """What a calibration was measured on: the torch build, the card,
        the kernel and native sources, the backend and the structure's
        shape."""
        from .. import kernels, native
        with open(native._SRC, "rb") as f:
            native_src = hashlib.sha1(f.read()).hexdigest()
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        N, F = st.subtree_quota.shape
        C, S, R = st.slot_fr.shape
        return repr((torch.__version__, torch.version.cuda, name,
                     kernels.source_digest(), native_src, self.backend,
                     N, F, C, S, R, st.depth, st.n_forests,
                     _bucket(max_heads)))

    def _warm_bucket(self, st: PackedStructure, W: int,
                     measure: bool) -> None:
        """One head-count bucket of ``warmup``.  The routes are timed on
        a worst-case sample, every head fitting with all R decision
        pairs valid: the kernels skip work an empty sample lacks (the
        flat scan's blocks without heads), so an empty one would favour
        the card, as a sparse one favoured the native loop in the JAX
        solver."""
        N, F = st.subtree_quota.shape
        R = st.slot_fr.shape[2]
        n_cq = len(st.cq_names)
        busy = (np.zeros((N, F), np.int32),
                (np.arange(W) % max(n_cq, 1)).astype(np.int32),
                np.tile((np.arange(R) % F).astype(np.int32), (W, 1)),
                np.ones((W, R), np.int32), np.ones(W, bool),
                np.full((W, R), -1, np.int32), np.zeros((W, R), np.int32),
                np.zeros(W, bool), np.zeros(W, bool))
        order = np.arange(W, dtype=np.int32)
        # forest scan lengths for this bucket: 4 .. bucket(max CQs per
        # forest); None when the flat scan is the one dispatched
        mfw_ladder = None
        if self._forests_apply(W, st.n_forests):
            per_forest = np.bincount(st.forest_of_node[:n_cq],
                                     minlength=st.n_forests)
            top = _bucket(int(per_forest.max()), minimum=4)
            mfw_ladder, mfw = [], 4
            while True:
                mfw_ladder.append(mfw)
                if mfw >= top:
                    break
                mfw *= 2
        route = self.device.type
        reps = _REPS if measure else 1
        for mfw in mfw_ladder or [None]:
            dt = _median_wall(
                lambda: self._launch_scan(st, busy, order, mfw), reps)
            if measure:
                kind = "flat" if mfw is None else "forest"
                self.calibration[(route, kind, W, mfw or W)] = dt
        if measure and self.backend == "auto":
            self._time_native(st, W, busy, order, mfw_ladder)

        # the first padded-K rung (scalar heads with more decision pairs
        # than R, _build_pair_tensors) and every (T, MT) rung of the
        # preempt scan this head count can reach, on the JAX solver's
        # empty sample; only the smallest rung's time is recorded
        empty = (busy[0], np.full(W, -1, np.int32),
                 np.full((W, R), -1, np.int32), np.zeros((W, R), np.int32),
                 np.zeros(W, bool), np.full((W, R), -1, np.int32),
                 np.zeros((W, R), np.int32), np.zeros(W, bool),
                 np.zeros(W, bool))
        Kpad = _bucket(R + 1, minimum=R if R >= 8 else 8)
        wide = (np.full((W, Kpad), -1, np.int32),
                np.zeros((W, Kpad), np.int32))
        padded = empty[:2] + wide + empty[4:5] + wide + empty[7:]
        t_top = coarse_bucket(4 * W, T_LADDER)
        self._launch_scan(st, padded, order, None)
        for T in [t for t in T_LADDER if t <= t_top]:
            for MT in MT_LADDER if T == T_LADDER[0] else MT_LADDER[:1]:
                timed = measure and (T, MT) == (T_LADDER[0], MT_LADDER[0])
                dt = _median_wall(
                    lambda: self._launch_preempt_rung(st, empty, order, T,
                                                      MT),
                    reps if timed else 1)
                if timed:
                    self.calibration[(route, "preempt", W, W)] = dt

    def _launch_scan(self, st: PackedStructure, per_cycle: tuple,
                     order: np.ndarray, mfw: Optional[int]) -> None:
        """Upload one sample, launch the flat (``mfw`` None) or forest
        scan, read the decisions back."""
        args = self._scan_args(st, *per_cycle)
        t_order = self._to_device(order)[0]
        fon = self._device_planes(st)["forest_of_node"]
        if mfw is None:
            out = admit_scan(*args, t_order, depth=st.depth,
                             forest_of_node=fon, n_forests=st.n_forests)
        else:
            out = admit_scan_forests(*args, t_order, fon, depth=st.depth,
                                     n_forests=st.n_forests,
                                     max_forest_wl=mfw)
        out.cpu()

    def _launch_preempt_rung(self, st: PackedStructure, per_cycle: tuple,
                             order: np.ndarray, T: int, MT: int) -> None:
        """The preempt scan at one (T, MT) rung, no head preempting, read
        back."""
        W = order.shape[0]
        F = st.subtree_quota.shape[1]
        R = per_cycle[2].shape[1]
        args = self._scan_args(st, *per_cycle)
        out = admit_scan_preempt(
            *args, *self._to_device(
                np.zeros(W, bool), np.full((W, R), -1, np.int32),
                np.zeros((W, R), np.int32), np.full((W, MT), -1, np.int32),
                np.zeros(T, np.int32), np.zeros((T, F), np.int32), order),
            depth=st.depth,
            forest_of_node=self._device_planes(st)["forest_of_node"],
            n_forests=st.n_forests)
        for t in out:
            t.cpu()

    def _time_native(self, st: PackedStructure, W: int, busy: tuple,
                     order: np.ndarray, mfw_ladder) -> None:
        """The C++ admit loop on the worst-case sample, in the same table
        (its time does not depend on the forest bucket).  A failure is
        counted in ``native_calibration_failures``; the bucket then has
        no native entry and runs on the device."""
        from .. import native
        try:
            if not native.available():
                return
            statics = [getattr(st, k) for k in _STATIC_PLANES[:7]]
            dt = _median_wall(lambda: native.admit_scan_raw(
                busy[0], *statics, *busy[1:], order), _REPS)
        except Exception:
            self.stats["native_calibration_failures"] += 1
            return
        for mfw in mfw_ladder or [None]:
            kind = "flat" if mfw is None else "forest"
            self.calibration[("native", kind, W, mfw or W)] = dt

    def _warm_search(self, st: PackedStructure, max_heads: int) -> None:
        """Launch the batched preemption search once at every (S, K) rung
        a run of this size can reach (S <= 2 searches a head; K past the
        second rung is rare enough to pay its first launch live)."""
        from .preemption_kernel import minimal_preemptions_batch
        from .preemption_solver import K_LADDER, S_LADDER, _ForestPlanes
        try:
            planes = _ForestPlanes(st)
        except ValueError:
            return
        st._preempt_planes = planes
        NL, F = planes.NL, st.subtree_quota.shape[1]
        s_top = coarse_bucket(2 * max_heads, S_LADDER)
        for S in [s for s in S_LADDER if s <= s_top]:
            for K in K_LADDER[:2]:
                out = minimal_preemptions_batch(*self._to_device(
                    np.zeros((S, NL, F), np.int32),
                    np.zeros((S, NL, F), np.int32),
                    np.zeros((S, NL, F), np.int32),
                    np.full((S, NL, F), 2**30, np.int32),
                    np.zeros((S, NL, F), bool),
                    np.full((S, NL), -1, np.int32),
                    np.full(S, -1, np.int32), np.zeros((S, F), np.int32),
                    np.zeros((S, F), bool), np.full((S, K), -1, np.int32),
                    np.zeros((S, K, F), np.int32), np.zeros((S, K), bool),
                    np.zeros((S, K), bool), np.zeros(S, bool),
                    np.zeros(S, bool)), depth=st.depth)
                for t in out:
                    t.cpu()

    # -- structure cache -----------------------------------------------

    def _structure_for(self, snapshot: Snapshot,
                       heads: list[Info]) -> PackedStructure:
        gen = getattr(snapshot, "structure_generation", -1)
        st = self._structure
        if st is None or st.generation != gen or gen < 0:
            st = pack_structure(snapshot, heads, generation=gen)
            st.cq_vector_ok = self._cq_vector_ok(snapshot, st)
            # the preemption search launches on the solver's device
            st.device = str(self.device)
            self._structure = st
            self._potential0 = None
            self.stats["structure_rebuilds"] += 1
        return st

    # -- eligibility ---------------------------------------------------

    def _cq_vector_ok(self, snapshot: Snapshot,
                      st: PackedStructure) -> np.ndarray:
        """Per-CQ: can the vectorized classify reproduce the host flavor
        walk for heads of this CQ?  Requires a single resource group and
        plain flavors (existing, no taints, no node labels, no topology)
        — everything else routes the head to the scalar host walk instead
        (flavorassigner.go:499-640).  Any FlavorFungibility policy is
        fine: the walk (stop rules + resume index) runs in the vector
        math itself (classify_np / the fused burst kernel)."""
        ok = np.zeros(len(st.cq_names), dtype=bool)
        for ci, name in enumerate(st.cq_names):
            cq = snapshot.cluster_queues[name]
            if len(cq.spec.resource_groups) != 1:
                continue
            plain = True
            for rg in cq.spec.resource_groups:
                for fq in rg.flavors:
                    flavor = snapshot.resource_flavors.get(fq.name)
                    if (flavor is None or flavor.node_taints
                            or flavor.node_labels or flavor.topology_name):
                        plain = False
                        break
            ok[ci] = plain
        return ok

    def _scalar_mask(self, snapshot: Snapshot, heads: list[Info],
                     st: PackedStructure) -> np.ndarray:
        """Per-head: True → the head needs the scalar host walk (the
        vectorized classify's assumptions don't hold).  A mid-list
        fungibility resume state is NOT a scalar reason anymore: it
        becomes the head's vector start slot (``resume_start``)."""
        mask = np.zeros(len(heads), dtype=bool)
        cq_ok = st.cq_vector_ok
        reasons = self.stats["scalar_reasons"]
        for wi, h in enumerate(heads):
            ci = st.cq_index.get(h.cluster_queue, -1)
            if ci < 0 or not cq_ok[ci]:
                mask[wi] = True
                reasons["cq_shape"] = reasons.get("cq_shape", 0) + 1
                continue
            if len(h.obj.pod_sets) != 1:
                # the host can split flavors across pod sets and accounts
                # earlier pod sets' usage in later walks
                mask[wi] = True
                reasons["multi_podset"] = reasons.get("multi_podset", 0) + 1
                continue
            ps = h.obj.pod_sets[0]
            if ps.topology_request is not None:
                mask[wi] = True
                reasons["topology"] = reasons.get("topology", 0) + 1
        return mask

    def _start_slots(self, snapshot: Snapshot, heads: list[Info],
                     st: PackedStructure) -> np.ndarray:
        """Per-head flavor-walk start slot from the fungibility resume
        state (flavorassigner.go:359-366): a head whose last attempt
        stopped mid-list resumes at last_tried_flavor_idx + 1, unless the
        CQ's quota changed since (allocatable_generation moved on)."""
        start = np.zeros(len(heads), dtype=np.int32)
        for wi, h in enumerate(heads):
            s = resume_start(h, snapshot.cq(h.cluster_queue),
                             h.cluster_queue in st.cq_covers_pods)
            if s:
                start[wi] = s
                self.stats["resume_heads"] += 1
        return start

    # -- phase 1 -------------------------------------------------------

    def classify(self, snapshot: Snapshot,
                 heads: list[Info]) -> Optional[ClassifiedCycle]:
        """Pack + vectorized nominate.  None → run the host path.

        Heads the vector math can't cover are flagged in ``scalar_mask``
        (their vector rows are cleared); the scheduler host-walks those
        and attaches the assignments via ``attach_host_assignment``."""
        if not heads:
            return None
        st = self._structure_for(snapshot, heads)
        packed = pack_cycle(snapshot, heads, self.ordering, structure=st)
        if packed is None:
            # topology drifted under an unchanged generation (defensive):
            # rebuild once and retry
            self._structure = None
            st = self._structure_for(snapshot, heads)
            packed = pack_cycle(snapshot, heads, self.ordering, structure=st)
            if packed is None:
                return None
        if not packed.exact:
            # lossy int32 scaling could deny fits the host grants
            return None
        scalar = self._scalar_mask(snapshot, heads, st)
        start = self._start_slots(snapshot, heads, st)
        if self._potential0 is None or self._potential0.shape != packed.usage0.shape:
            from .cycle import available_all_np
            self._potential0 = available_all_np(
                np.zeros_like(packed.usage0), st.subtree_quota, st.guaranteed,
                st.borrow_cap, st.has_borrow_limit, st.parent, st.depth)

        W = packed.wl_cq.shape[0]
        start_pad = np.zeros(W, dtype=np.int32)
        start_pad[:len(heads)] = start
        # the C++ classify core is first-fit-only: any non-default
        # fungibility policy or mid-list resume routes to classify_np
        ff_default = (bool(st.cq_wcb_borrow.all())
                      and not bool(st.cq_wcp_preempt.any()))
        if self.backend == "native" and (not ff_default or start.any()):
            self.stats["native_ff_fallbacks"] += 1
        if self.backend == "native" and ff_default and not start.any():
            from .. import native
            fit_slot0, borrows0, preempt0 = native.classify_cycle(packed)
            n = packed.wl_count
            R = len(st.resource_names)
            out = {
                "fit_slot0": np.asarray(fit_slot0),
                "borrows0": np.asarray(borrows0),
                "preempt0": np.asarray(preempt0),
                "preempt_slot0": np.full(W, -1, np.int32),
                "preempt_borrows0": np.zeros(W, bool),
                "preempt_res_fit": np.ones((W, R), bool),
                "preempt_slot_count": np.zeros(W, np.int32),
                "preempt_stopped0": np.zeros(W, bool),
            }
            if out["preempt0"][:n].any():
                # the C++ core covers fit/borrow/preempt-possible; the
                # preempt-slot details come from the numpy pass on demand
                det = classify_np(packed, potential0=self._potential0)
                for k in ("preempt_slot0", "preempt_borrows0",
                          "preempt_res_fit", "preempt_slot_count",
                          "preempt_stopped0"):
                    out[k] = det[k]
        else:
            out = classify_np(packed, potential0=self._potential0,
                              start_slot=start_pad)
        n = packed.wl_count
        # partial admission: a min_count head whose FULL counts fit is
        # decision-identical to a plain head; otherwise the host runs the
        # PodSetReducer binary search (podset_reducer.go) — scalar walk
        for wi in range(n):
            if scalar[wi] or out["fit_slot0"][wi] >= 0:
                continue
            if any(ps.min_count is not None and ps.min_count < ps.count
                   for ps in heads[wi].obj.pod_sets):
                scalar[wi] = True
        if scalar.any():
            # clear the vector rows for scalar heads: their decisions come
            # from the attached host assignments instead
            sm = np.zeros(W, dtype=bool)
            sm[:n] = scalar
            out = dict(out)
            out["fit_slot0"] = np.where(sm, -1, out["fit_slot0"]).astype(np.int32)
            out["borrows0"] = out["borrows0"] & ~sm
            out["preempt0"] = out["preempt0"] & ~sm
            out["preempt_slot0"] = np.where(sm, -1, out["preempt_slot0"]).astype(np.int32)
            out["preempt_borrows0"] = out["preempt_borrows0"] & ~sm
            out["preempt_stopped0"] = out["preempt_stopped0"] & ~sm
            self.stats["scalar_heads"] += int(scalar.sum())
        else:
            sm = np.zeros(W, dtype=bool)
        self.stats["walk_stop_heads"] += int(
            np.count_nonzero(out["preempt_stopped0"][:n]))
        return ClassifiedCycle(
            packed=packed, heads=heads, snapshot=snapshot,
            fit_slot0=out["fit_slot0"], borrows0=out["borrows0"],
            preempt0=out["preempt0"], preempt_slot0=out["preempt_slot0"],
            preempt_borrows0=out["preempt_borrows0"],
            preempt_res_fit=out["preempt_res_fit"],
            preempt_slot_count=out["preempt_slot_count"],
            preempt_stopped0=out["preempt_stopped0"],
            scalar_mask=sm, host_assignments={}, host_pairs={})

    # -- scalar-head decisions -----------------------------------------

    def attach_host_assignment(self, cls: ClassifiedCycle, wi: int,
                               assignment) -> bool:
        """Record a host-walked head's assignment for the admit scan.

        The assignment's usage map becomes the head's decision pairs.
        Returns False when the usage can't be represented in the cached
        structure (unknown flavor-resource or inexact scaling) — the
        caller then falls the whole cycle back to the host."""
        pairs = self._assignment_pairs(cls, assignment)
        if pairs is None:
            return False
        cls.host_assignments[wi] = assignment
        cls.host_pairs[wi] = pairs
        return True

    def _assignment_pairs(self, cls: ClassifiedCycle, assignment
                          ) -> Optional[list[tuple[int, int]]]:
        """assignment.usage → [(F-index, scaled amount)], or None."""
        st = cls.packed.structure
        scale_of = {r: int(st.resource_scale[i])
                    for i, r in enumerate(st.resource_names)}
        pairs = []
        for fr, v in assignment.usage.items():
            fi = st.fr_index.get(fr)
            if fi is None:
                return None
            s = scale_of.get(fr.resource)
            if s is None or v % s:
                return None
            q = v // s
            if q > 2**31 - 1:
                return None
            pairs.append((fi, int(q)))
        return pairs

    def _build_pair_tensors(self, cls: ClassifiedCycle,
                            rmask: np.ndarray, pmask: np.ndarray):
        """Merge vector and scalar classifications into the scan's
        decision-pair tensors.

        Returns (dec_fr, dec_amt, fit_mask, res_fr, res_amt, res_borrows,
        pre_fr, pre_amt, borrows) — all [W, K] / [W]."""
        packed = cls.packed
        st = packed.structure
        W = packed.wl_cq.shape[0]
        R = len(st.resource_names)

        # vector fit heads: pairs from the chosen slot (batched)
        dec_fr, dec_amt, fit_mask = decision_pairs_from_slots(
            st.slot_fr, packed.wl_cq, packed.wl_requests, cls.fit_slot0)
        # vector reserve/preempt entries: pairs from the preempt slot
        pre_on = rmask | pmask
        pslot = np.where(pre_on & (cls.preempt_slot0 >= 0),
                         cls.preempt_slot0, -1).astype(np.int32)
        res_fr, res_amt, _ = decision_pairs_from_slots(
            st.slot_fr, packed.wl_cq, packed.wl_requests, pslot)
        res_borrows = cls.preempt_borrows0 & pre_on
        borrows = cls.borrows0.copy()
        borrows |= res_borrows

        scalar_pairs = cls.host_pairs
        max_k = R
        for pairs in scalar_pairs.values():
            max_k = max(max_k, len(pairs))
        if max_k > R:
            K = _bucket(max_k, minimum=R if R >= 8 else 8)
            pad = np.full((W, K - R), -1, np.int32)
            zpad = np.zeros((W, K - R), np.int32)
            dec_fr = np.concatenate([dec_fr, pad], axis=1)
            dec_amt = np.concatenate([dec_amt, zpad], axis=1)
            res_fr = np.concatenate([res_fr, pad], axis=1)
            res_amt = np.concatenate([res_amt, zpad], axis=1)

        for wi, assignment in cls.host_assignments.items():
            pairs = scalar_pairs[wi]
            mode = assignment.representative_mode()
            is_fit = mode == Mode.FIT
            fit_mask[wi] = is_fit
            dec_fr[wi] = -1
            dec_amt[wi] = 0
            res_fr[wi] = -1
            res_amt[wi] = 0
            if is_fit:
                for k, (fi, q) in enumerate(pairs):
                    dec_fr[wi, k] = fi
                    dec_amt[wi, k] = q
            elif rmask[wi] or pmask[wi]:
                for k, (fi, q) in enumerate(pairs):
                    res_fr[wi, k] = fi
                    res_amt[wi, k] = q
                res_borrows[wi] = assignment.borrows()
            borrows[wi] = assignment.borrows()
        # preempt entries re-check fits on the same pairs they charge
        pre_fr, pre_amt = res_fr, res_amt
        return (dec_fr, dec_amt, fit_mask, res_fr, res_amt, res_borrows,
                pre_fr, pre_amt, borrows)

    # -- phase 2 -------------------------------------------------------

    def pack_targets(self, cls: ClassifiedCycle,
                     targets_by_wi: dict) -> Optional[PackedTargets]:
        """Pack per-head preemption-target lists into scan tensors.

        ``targets_by_wi``: {head index: [Target]} from the preemptor's
        nominate-time searches.  Returns None when a target's usage can't
        be represented exactly in the cached structure (host fallback)."""
        packed = cls.packed
        st = packed.structure
        W = packed.wl_cq.shape[0]
        F = packed.usage0.shape[1]
        universe: list = []
        uni_idx: dict[str, int] = {}
        scale_of = {r: int(st.resource_scale[i])
                    for i, r in enumerate(st.resource_names)}

        def to_f_vec(frq) -> Optional[np.ndarray]:
            vec = np.zeros(F, dtype=np.int64)
            for fr, v in frq.items():
                fi = st.fr_index.get(fr)
                if fi is None:
                    return None
                s = scale_of[fr.resource]
                if v % s:
                    return None
                vec[fi] += v // s
            if vec.max(initial=0) > 2**31 - 1:
                return None
            return vec.astype(np.int32)

        deltas: list[np.ndarray] = []
        cqs: list[int] = []
        per_wi: dict[int, list[int]] = {}
        for wi, targets in targets_by_wi.items():
            idxs = []
            for t in targets:
                key = t.info.key
                ti = uni_idx.get(key)
                if ti is None:
                    ci = st.cq_index.get(t.info.cluster_queue)
                    if ci is None:
                        return None
                    delta = to_f_vec(t.info.usage())
                    if delta is None:
                        return None
                    ti = len(universe)
                    uni_idx[key] = ti
                    universe.append(t.info)
                    deltas.append(delta)
                    cqs.append(ci)
                idxs.append(ti)
            per_wi[wi] = idxs

        n_universe = max(1, len(universe))
        n_per_head = max(1, max(len(v) for v in per_wi.values()))
        if n_universe > T_LADDER[-1] or n_per_head > MT_LADDER[-1]:
            return None   # beyond the shape ladders: host path
        T = coarse_bucket(n_universe, T_LADDER)
        MT = coarse_bucket(n_per_head, MT_LADDER)
        tu_cq = np.zeros(T, dtype=np.int32)
        tu_delta = np.zeros((T, F), dtype=np.int32)
        tu_cq[:len(cqs)] = cqs
        if deltas:
            tu_delta[:len(deltas)] = np.stack(deltas)
        tgt_mat = np.full((W, MT), -1, dtype=np.int32)
        preempt_mask = np.zeros(W, dtype=bool)
        for wi, idxs in per_wi.items():
            preempt_mask[wi] = True
            tgt_mat[wi, :len(idxs)] = idxs
        return PackedTargets(preempt_mask=preempt_mask, tgt_mat=tgt_mat,
                             tu_cq=tu_cq, tu_delta=tu_delta)

    def dispatch(self, cls: ClassifiedCycle, reserve_mask: np.ndarray,
                 targets: Optional[PackedTargets] = None) -> DispatchHandle:
        """Issue the admit scan (async) — or prove it unnecessary.

        ``reserve_mask`` (head order) marks preempt-classified entries the
        scheduler verified have zero preemption candidates — they reserve
        capacity in-scan (resourcesToReserve) and requeue.  ``targets``
        carries the packed preemption targets for preempt heads WITH
        candidates; those entries preempt in-scan (the reference admit
        loop's IssuePreemptions branch, scheduler.go:176-284).

        Decision-identical shortcuts (no dispatch issued):
        - no fit head and no preempt entry → nothing can be admitted,
          reserves requeue anyway;
        - ≤1 entry per cohort forest (and no preempt entry) → zero
          within-cycle contention, every fit head keeps its fit.
        Otherwise the scan runs on the route ``choose_route`` picks: one
        kernel launched on the solver's device (the CUDA kernel on
        "cuda", the plain version on "cpu"), or the C++ admit loop,
        synchronously; the host overlaps per-head work with a launch
        until ``fetch``."""
        packed = cls.packed
        st = packed.structure
        W = packed.wl_cq.shape[0]
        n = cls.n
        rmask = np.zeros(W, dtype=bool)
        rmask[:len(reserve_mask)] = reserve_mask
        pmask = (targets.preempt_mask if targets is not None
                 else np.zeros(W, dtype=bool))
        (dec_fr, dec_amt, fit_mask, res_fr, res_amt, res_borrows,
         pre_fr, pre_amt, borrows) = self._build_pair_tensors(
            cls, rmask, pmask)
        order = cycle_order_np(borrows, packed.wl_priority,
                               packed.wl_timestamp)
        self.stats["reserve_entries"] += int(rmask[:n].sum())
        handle = DispatchHandle(order=order, rmask=rmask, n=n)
        handle.fit_mask = fit_mask
        zeros = np.zeros(W, dtype=bool)

        if not pmask.any():
            handle.preempting = zeros
            handle.overlap_skip = zeros
            if not fit_mask[:n].any():
                self.stats["skipped_dispatches"] += 1
                handle.admitted = zeros
                handle.route = "no_fit"
                return handle
            entry_mask = fit_mask | rmask
            entry_cqs = packed.wl_cq[entry_mask]
            if len(entry_cqs):
                forests = st.forest_of_node[np.maximum(entry_cqs, 0)]
                if np.bincount(forests, minlength=st.n_forests).max() <= 1:
                    # one entry per independent quota forest: the scan's
                    # only job (usage mutation between entries) is a no-op
                    self.stats["singleton_dispatches"] += 1
                    handle.admitted = fit_mask & (packed.wl_cq >= 0)
                    handle.route = "singleton"
                    return handle

        has_preempt = bool(pmask.any())
        mfw = self._forest_bucket(packed) if not has_preempt else None
        if self.mesh is not None:
            # the mesh route takes precedence over the native one, as in
            # the JAX solver
            return self._dispatch_sharded(
                handle, st, has_preempt, mfw, order, targets,
                (packed.usage0, st.subtree_quota, st.guaranteed,
                 st.borrow_cap, st.has_borrow_limit, st.parent,
                 st.nominal_cq, st.nominal_plus_blimit_cq, packed.wl_cq,
                 dec_fr, dec_amt, fit_mask, res_fr, res_amt, rmask,
                 res_borrows), (pmask, pre_fr, pre_amt))
        kind = ("preempt" if has_preempt
                else "flat" if mfw is None else "forest")
        route = choose_route(self.calibration, self.device.type,
                             self.backend, kind, W, mfw)
        if route == "native":
            # the C++ core runs the admit loop synchronously on the host
            # (cycles with preempting heads keep the device scan)
            from .. import native
            handle.admitted = native.admit_scan(
                packed, dec_fr, dec_amt, fit_mask, res_fr, res_amt,
                rmask, res_borrows, order)
            handle.preempting = zeros
            handle.overlap_skip = zeros
            handle.route = "native"
            self.stats["native_dispatches"] += 1
            return handle
        kernel = ("admit_scan_preempt" if has_preempt
                  else "admit_scan" if mfw is None else "admit_scan_forests")
        statics = self._device_planes(st)
        args = self._scan_args(st, packed.usage0, packed.wl_cq, dec_fr,
                               dec_amt, fit_mask, res_fr, res_amt, rmask,
                               res_borrows)
        t_order = self._to_device(order)[0]
        handle.route = route
        self.stats[f"{route}_dispatches"] += 1
        from ..profiling import annotation
        with annotation(f"admit_scan:{kernel}"):
            if has_preempt:
                # a Kueue cycle's targets lie in their heads' forests: the
                # statics' labels serve; otherwise the joined ones
                labels, joined = join_target_forests(
                    st.forest_of_node, st.n_forests, packed.wl_cq, pmask,
                    targets.tgt_mat, targets.tu_cq)
                fon = (self._to_device(labels)[0] if joined
                       else statics["forest_of_node"])
                error = None
                if self.device.type == "cuda":
                    error = torch.zeros(1, dtype=torch.int32,
                                        device=self.device)
                    handle.errors.append(error)
                handle.pending = admit_scan_preempt(
                    *args, *self._to_device(
                        pmask, pre_fr, pre_amt, targets.tgt_mat,
                        targets.tu_cq, targets.tu_delta),
                    t_order, depth=st.depth, forest_of_node=fon,
                    n_forests=st.n_forests, error=error)
            elif mfw is not None:
                handle.pending = admit_scan_forests(
                    *args, t_order, statics["forest_of_node"],
                    depth=st.depth, n_forests=st.n_forests,
                    max_forest_wl=mfw)
            else:
                handle.pending = admit_scan(
                    *args, t_order, depth=st.depth,
                    forest_of_node=statics["forest_of_node"],
                    n_forests=st.n_forests)
        return handle

    def _dispatch_sharded(self, handle, st, has_preempt, mfw, order,
                          targets, args, pre) -> DispatchHandle:
        """The admit scan over the mesh: flat, forest or preempt, as the
        unsharded dispatch picks it (``handle.route = "sharded"``)."""
        fns = self._sharded_for(st.depth)
        layout = self._mesh_pad(st)
        self.stats["sharded_dispatches"] += 1
        handle.route = "sharded"
        from ..profiling import annotation
        if has_preempt:
            kernel = "admit_scan_preempt"
            self.stats["sharded_preempt_dispatches"] += 1
            with annotation("admit_scan_sharded:preempt"):
                handle.pending = fns["preempt"](
                    *args, *pre, targets.tgt_mat, targets.tu_cq,
                    targets.tu_delta, order, layout=layout,
                    errors=handle.errors)
        elif mfw is None:
            kernel = "admit_scan"
            with annotation("admit_scan_sharded:flat"):
                handle.pending = fns["flat"](*args, order, layout=layout)
        else:
            kernel = "admit_scan_forests"
            with annotation("admit_scan_sharded:forest"):
                handle.pending = fns["forest"](
                    *args, order, forest_of_node=st.forest_of_node,
                    n_forests=st.n_forests, max_forest_wl=mfw,
                    layout=layout)
        self._count_shards(layout, kernel)
        return handle

    def dispatch_fs(self, cls: ClassifiedCycle) -> Optional[DispatchHandle]:
        """Dispatch a fair-sharing cycle's tournament + admit loop as one
        ``fs_admit_scan`` launch (ops/fs_scan.py) — FULL-mode FS.

        Returns None when the FS statics can't be built or the scaled
        DRS math could overflow (host tournament runs instead).  The
        caller guarantees: no scalar heads, no preempt-capable heads, no
        admission-block gate.  The statics are uploaded once per
        structure; each cycle uploads usage and the per-head tensors."""
        from .fs_scan import build_fs_statics, fs_admit_scan, fs_bounds_ok
        packed = cls.packed
        st = packed.structure
        statics = getattr(st, "_fs_statics", "unset")
        if isinstance(statics, str):
            statics = build_fs_statics(cls.snapshot, st)
            st._fs_statics = statics
        if statics is None:
            return None
        W = packed.wl_cq.shape[0]
        F = packed.usage0.shape[1]
        dec_fr, dec_amt, fit_mask = decision_pairs_from_slots(
            st.slot_fr, packed.wl_cq, packed.wl_requests, cls.fit_slot0)
        u_e = np.zeros((W, F), dtype=np.int32)
        rows, cols = np.nonzero(dec_fr >= 0)
        np.add.at(u_e, (rows, dec_fr[rows, cols]), dec_amt[rows, cols])
        if not fs_bounds_ok(statics, packed.usage0, u_e):
            return None
        valid = packed.wl_cq >= 0
        nofit = ~fit_mask
        # equality-preserving timestamp rank (ties must stay ties for
        # entryComparer.less parity)
        _, ts_rank = np.unique(packed.wl_timestamp, return_inverse=True)
        ts_rank = ts_rank.astype(np.int32)
        handle = DispatchHandle(order=np.arange(W, dtype=np.int32),
                                rmask=np.zeros(W, dtype=bool), n=cls.n)
        handle.fit_mask = fit_mask
        handle.route = self.device.type
        self.stats[f"{self.device.type}_dispatches"] += 1
        if self.mesh is not None:
            # the same kernel per cq shard of whole cohort forests, the
            # rounds merged back into the reference's global order
            key = ("fs", st.depth, statics.n_levels)
            fn = self._sharded_fns.get(key)
            if fn is None:
                from ..parallel.sharded import fs_scan_fn
                fn = fs_scan_fn(self.mesh, st.depth, statics.n_levels)
                self._sharded_fns[key] = fn
            self.stats["sharded_fs_dispatches"] += 1
            layout = self._mesh_pad(st)
            from ..profiling import annotation
            with annotation("fs_admit_scan"):
                handle.pending = ("fs", fn(
                    packed.usage0, st.subtree_quota, statics.sq_mask,
                    st.guaranteed, st.borrow_cap, st.has_borrow_limit,
                    st.parent, statics.node_level, st.fair_weight_milli,
                    statics.lendable_r, statics.onehot, statics.child_order,
                    packed.wl_cq, u_e, nofit, packed.wl_priority, ts_rank,
                    valid, st.forest_of_node, layout=layout))
            self._count_shards(layout, "fs_admit_scan")
            return handle
        planes = self._device_planes(st)
        fs = self._fs_planes(st, statics)
        usage0, wl_cq, t_u_e, t_nofit, prio, t_ts, t_valid = self._to_device(
            packed.usage0, packed.wl_cq, u_e, nofit, packed.wl_priority,
            ts_rank, valid)
        from ..profiling import annotation
        with annotation("fs_admit_scan"):
            handle.pending = ("fs", fs_admit_scan(
                usage0, planes["subtree_quota"], fs["sq_mask"],
                planes["guaranteed"], planes["borrow_cap"],
                planes["has_borrow_limit"], planes["parent"],
                fs["node_level"], fs["weights"], fs["lendable_r"],
                fs["onehot"], fs["child_order"], wl_cq, t_u_e, t_nofit,
                prio, t_ts, t_valid, planes["forest_of_node"],
                depth=st.depth, n_levels=statics.n_levels,
                n_forests=st.n_forests, max_forest=fs["max_forest"]))
        return handle

    def fetch(self, handle: DispatchHandle) -> DeviceCycleFinal:
        """Block for an in-flight scan's decisions (head order)."""
        if (handle.admitted is None and isinstance(handle.pending, tuple)
                and handle.pending[0] == "fs"):
            order, admitted, _ = (t.cpu().numpy()
                                  for t in handle.pending[1])
            handle.pending = None
            W = len(handle.rmask)
            handle.admitted = admitted
            handle.preempting = np.zeros(W, dtype=bool)
            handle.overlap_skip = np.zeros(W, dtype=bool)
            handle.order = order
            self._collect_kernel_stats()
            n = handle.n
            return DeviceCycleFinal(
                order=order[(order >= 0) & (order < n)],
                admitted=admitted[:n], reserve_mask=handle.rmask[:n],
                preempting=handle.preempting[:n],
                overlap_skip=handle.overlap_skip[:n])
        if handle.admitted is None:
            out = handle.pending
            handle.pending = None
            W = len(handle.rmask)
            if isinstance(out, tuple):
                handle.admitted, handle.preempting, handle.overlap_skip = (
                    t.cpu().numpy() for t in out)
                if handle.errors:
                    from .. import kernels
                    for error in handle.errors:
                        kernels.check_preempt_error(error)
            else:
                handle.admitted = out.cpu().numpy()
                handle.preempting = np.zeros(W, dtype=bool)
                handle.overlap_skip = np.zeros(W, dtype=bool)
            self._collect_kernel_stats()
        n = handle.n
        return DeviceCycleFinal(
            order=handle.order[handle.order < n],
            admitted=handle.admitted[:n], reserve_mask=handle.rmask[:n],
            preempting=handle.preempting[:n],
            overlap_skip=handle.overlap_skip[:n])

    def solve_full(self, cls: ClassifiedCycle,
                   reserve_mask: np.ndarray) -> DeviceCycleFinal:
        """dispatch + fetch in one call (tests/probes)."""
        return self.fetch(self.dispatch(cls, reserve_mask))

    @staticmethod
    def _forests_apply(W: int, n_forests: int) -> bool:
        """Single gate for forest-vs-flat scan dispatch (warmup must
        compile exactly what solve_full will run)."""
        return n_forests > 1 and W >= _FOREST_MIN_HEADS

    def _forest_bucket(self, packed: PackedCycle) -> Optional[int]:
        """Power-of-two scan length for the forest-parallel admit scan, or
        None when the flat scan is the better dispatch."""
        st = packed.structure
        if not self._forests_apply(packed.wl_cq.shape[0], st.n_forests):
            return None
        valid = packed.wl_cq >= 0
        if not valid.any():
            return None
        f_of = st.forest_of_node[np.maximum(packed.wl_cq, 0)]
        counts = np.bincount(f_of[valid], minlength=st.n_forests)
        return _bucket(int(counts.max()), minimum=4)

    # -- assignment reconstruction -------------------------------------

    def build_fit_assignment(self, cls: ClassifiedCycle,
                             wi) -> Assignment:
        """Host Assignment for a device-classified Fit head, including the
        fungibility resume state the host walk would record."""
        slot = int(cls.fit_slot0[wi])
        borrow = bool(cls.borrows0[wi])
        return self._build_assignment(cls, wi, slot, Mode.FIT, borrow)

    def _build_assignment(self, cls: ClassifiedCycle, wi: int, slot: int,
                          mode: Mode, borrow: bool,
                          res_modes: Optional[dict] = None) -> Assignment:
        h = cls.heads[wi]
        cq = cls.snapshot.cq(h.cluster_queue)
        return build_slot_assignment(h, cq, slot, mode, borrow,
                                     res_modes=res_modes)

    def build_preempt_assignment(self, cls: ClassifiedCycle,
                                 wi: int) -> Assignment:
        """Host Assignment for a preempt-classified head with per-resource
        modes (resources fitting on the preempt slot are FIT, the
        shortfall resources PREEMPT — flavorassigner.go:692), as the
        preemptor's target search expects (preemption.go:466)."""
        slot = int(cls.preempt_slot0[wi])
        borrow = bool(cls.preempt_borrows0[wi])
        st = cls.packed.structure
        res_modes = {res: (Mode.FIT if cls.preempt_res_fit[wi][ri]
                           else Mode.PREEMPT)
                     for res, ri in st.r_index.items()}
        return self._build_assignment(cls, wi, slot, Mode.PREEMPT, borrow,
                                      res_modes=res_modes)

    def reserve_details(self, cls: ClassifiedCycle, wi: int
                        ) -> tuple[Assignment, str]:
        """Assignment + inadmissible message for a preempt-classified head
        with no candidates (reachable whenever exactly one slot is
        preempt-capable, including multi-flavor CQs whose other slots are
        NoFit), replicating the host walk's reasons (flavorassigner.go:692
        messages)."""
        h = cls.heads[wi]
        assignment = self.build_preempt_assignment(cls, wi)
        cq = cls.snapshot.cq(h.cluster_queue)
        ps = assignment.pod_sets[0]
        reasons = []
        for res in sorted(ps.requests):
            val = ps.requests[res]
            fr = FlavorResource(ps.flavors[res].name, res)
            avail = cq.available(fr)
            if val > avail:
                reasons.append(
                    f"insufficient unused quota for {res} in flavor "
                    f"{fr.flavor}, {val - avail} more needed")
        ps.reasons = reasons
        return assignment, assignment.message()

    # -- back-compat one-shot API (tests/probes) -----------------------

    def try_solve(self, snapshot: Snapshot, heads: list[Info]
                  ) -> Optional[dict[str, Assignment]]:
        """Classify-only: {workload_key: Fit Assignment} for heads that fit
        at snapshot usage, or None when the host path must run (any
        preempt-capable head, or unsupported semantics)."""
        cls = self.classify(snapshot, heads)
        if cls is None:
            self.stats["host_cycles"] += 1
            return None
        if cls.preempt0[:cls.n].any() or cls.scalar_mask[:cls.n].any():
            self.stats["host_cycles"] += 1
            return None
        self.stats["classify_cycles"] += 1
        out: dict[str, Assignment] = {}
        for wi in range(cls.n):
            if cls.fit_slot0[wi] >= 0:
                out[cls.heads[wi].key] = self.build_fit_assignment(cls, wi)
        return out


def build_slot_assignment(info: Info, cq, slot: int, mode: Mode,
                          borrow: bool,
                          res_modes: Optional[dict] = None) -> Assignment:
    """Reconstruct the host Assignment a device-classified head would get
    from the flavor walk: single resource group, slot = flavor index,
    including the fungibility resume state (flavorassigner.go:499).
    ``cq`` is any CQState (snapshot or live cache) carrying .spec and
    .allocatable_generation."""
    slot = int(slot)
    rg = cq.spec.resource_groups[0]
    covers_pods = "pods" in rg.covered_resources
    flavor_name = rg.flavors[slot].name
    n_slots = len(rg.flavors)
    # the host records attempted_idx = the slot the walk STOPPED on, or
    # the last slot when it scanned to the end and kept the best
    # (flavorassigner.go:386-390 + shouldTryNextFlavor); tried = -1 when
    # the whole list was attempted
    ff = cq.spec.flavor_fungibility
    wcb = ff.when_can_borrow == FlavorFungibilityPolicy.BORROW
    wcp = ff.when_can_preempt == FlavorFungibilityPolicy.PREEMPT
    stopped = ((not borrow or wcb)
               and (mode == Mode.FIT
                    or (mode == Mode.PREEMPT and wcp)))
    attempted = slot if stopped else n_slots - 1
    tried = -1 if attempted == n_slots - 1 else attempted

    assignment = Assignment()
    assignment.borrowing = borrow
    assignment.last_state = AssignmentClusterQueueState(
        cluster_queue_generation=cq.allocatable_generation)
    for psr in info.total_requests:
        # mirror the host's implicit "pods" handling
        # (flavorassigner.go:226 / _assign_flavors)
        reqs = dict(psr.requests)
        if covers_pods:
            reqs["pods"] = psr.count
        else:
            reqs.pop("pods", None)
        ps_res = PodSetAssignmentResult(
            name=psr.name, requests=Requests(reqs), count=psr.count)
        flavor_idx: dict[str, int] = {}
        for res in reqs:
            res_mode = mode if res_modes is None else res_modes.get(
                res, mode)
            ps_res.flavors[res] = FlavorAssignmentDecision(
                name=flavor_name, mode=res_mode, borrow=borrow,
                tried_flavor_idx=tried)
            flavor_idx[res] = tried
            fr = FlavorResource(flavor_name, res)
            assignment.usage[fr] = (assignment.usage.get(fr, 0)
                                    + reqs[res])
        assignment.pod_sets.append(ps_res)
        assignment.last_state.last_tried_flavor_idx.append(flavor_idx)
    return assignment


def resume_start(info: Info, cq, covers_pods: bool) -> int:
    """Flavor-walk start slot for a head with fungibility resume state.

    Mirrors the host's entry into the walk (flavorassigner.go:359-366 via
    next_flavor_to_try of the first resource in sorted request order): 0
    when there is no usable resume state, last_tried + 1 otherwise.  The
    state is void when the CQ's quota changed since it was recorded
    (assign() clears it on allocatable_generation advance)."""
    last = info.last_assignment
    if last is None or cq is None:
        return 0
    if cq.allocatable_generation > last.cluster_queue_generation:
        return 0
    if not info.total_requests:
        return 0
    psr = info.total_requests[0]
    reqs = set(psr.requests)
    if covers_pods:
        reqs.add("pods")
    else:
        reqs.discard("pods")
    if not reqs:
        return 0
    return max(0, int(last.next_flavor_to_try(0, sorted(reqs)[0])))
