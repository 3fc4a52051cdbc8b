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

from dataclasses import dataclass
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
                    classify_np, cycle_order_np, decision_pairs_from_slots)


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
                      # | "singleton"


# static structure planes the admit scans read, uploaded once per structure
_STATIC_PLANES = ("subtree_quota", "guaranteed", "borrow_cap",
                  "has_borrow_limit", "parent", "nominal_cq",
                  "nominal_plus_blimit_cq", "forest_of_node")


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

    Every dispatch on "cuda" launches a hand-written CUDA kernel;
    "cpu" runs the same function's plain PyTorch version.  Identical
    decisions on both."""

    BACKENDS = ("auto", "native")

    def __init__(self, ordering: Ordering | None = None,
                 device: str = "cuda", backend: str = "auto"):
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {self.BACKENDS}")
        self.ordering = ordering or Ordering()
        self.device = resolve_device(device)
        self.backend = backend
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
            "skipped_dispatches": 0,  # no fit head -> scan provably no-op
            "singleton_dispatches": 0,  # <=1 entry/forest -> no contention
            "structure_rebuilds": 0,
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
        """The fair-sharing statics and weights on the solver's device
        (cached on the structure, like ``_device_planes``)."""
        planes = getattr(st, "_fs_device_planes", None)
        if planes is None:
            from .fs_scan import fs_statics_to_torch
            planes = fs_statics_to_torch(statics, self.device)
            planes["weights"] = torch.from_numpy(
                np.ascontiguousarray(st.fair_weight_milli)).to(self.device)
            st._fs_device_planes = planes
        return planes

    def _to_device(self, *arrays) -> list:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

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
        """One-time setup outside the hot loop: on "cuda", build (when
        stale) and load the kernel library; upload the structure's static
        planes.  No scheduling state is touched."""
        if self.device.type == "cuda":
            from .. import kernels
            kernels.load()
        self._device_planes(self._structure_for(snapshot, []))

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
        Otherwise one kernel is launched on the solver's device (the
        CUDA kernel on "cuda", the plain version on "cpu"); the host
        overlaps per-head work until ``fetch``."""
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
        if self.backend == "native" and not has_preempt:
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
        (usage0, wl_cq, t_dec_fr, t_dec_amt, t_fit, t_res_fr, t_res_amt,
         t_rmask, t_res_borrows, t_order) = self._to_device(
            packed.usage0, packed.wl_cq, dec_fr, dec_amt, fit_mask, res_fr,
            res_amt, rmask, res_borrows, order)
        args = (usage0, statics["subtree_quota"], statics["guaranteed"],
                statics["borrow_cap"], statics["has_borrow_limit"],
                statics["parent"], statics["nominal_cq"],
                statics["nominal_plus_blimit_cq"], wl_cq, t_dec_fr,
                t_dec_amt, t_fit, t_res_fr, t_res_amt, t_rmask,
                t_res_borrows)
        handle.route = self.device.type
        self.stats[f"{self.device.type}_dispatches"] += 1
        from ..profiling import annotation
        with annotation(f"admit_scan:{kernel}"):
            if has_preempt:
                handle.pending = admit_scan_preempt(
                    *args, *self._to_device(
                        pmask, pre_fr, pre_amt, targets.tgt_mat,
                        targets.tu_cq, targets.tu_delta),
                    t_order, depth=st.depth)
            elif mfw is not None:
                handle.pending = admit_scan_forests(
                    *args, t_order, statics["forest_of_node"],
                    depth=st.depth, n_forests=st.n_forests,
                    max_forest_wl=mfw)
            else:
                handle.pending = admit_scan(*args, t_order, depth=st.depth)
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
                    targets.tu_delta, order, layout=layout)
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
                depth=st.depth, n_levels=statics.n_levels))
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
