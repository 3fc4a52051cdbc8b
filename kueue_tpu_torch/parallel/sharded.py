"""The per-cycle mesh and the forest-sharded fused burst: the port of the
JAX package's ``parallel/sharded.py`` — ``make_mesh`` (:30-48),
``cycle_args`` (:51-57), ``cycle_shardings`` (:60-68),
``sharded_cycle_fn`` (:71-83), ``admit_scan_fns`` (:90-130),
``fs_scan_fn`` (:137-197), ``make_burst_mesh`` (:204-213), the fill
tables (:216-265), ``BurstShardLayout`` (:266-485), ``sharded_burst_fn``
(:487-511) and ``make_hybrid_mesh`` (:514-553).

One process drives every mesh: the JAX reference is single-controller
(one solver dispatches each program across the whole mesh), so the port
launches each shard's kernel on its own device, on that shard's own CUDA
stream, from the same host thread.  A real mesh is ``cuda:0 ..
cuda:n-1``.  A virtual mesh repeats one device n times: the counterpart
of the JAX tests' 8 virtual XLA CPU devices.  Only ``virtual_mesh`` turns
it on, and nothing in the package does: tests and ``chip_smoke.py`` do.

Where GSPMD splits the quota plane by node-index range over ``cq`` (so a
head's cohort chain crosses shards and the scan's carried usage needs a
collective at every step), the port partitions whole cohort forests
over ``cq`` (``ForestPartition``, shared by both layouts).  Every
``available_at``, usage chain, target removal and DRS tournament stays
inside one forest, so each shard runs the unsharded kernel on its own
forests with no collective, and ``kq_gather_heads`` (and, for fair
sharing, ``kq_fs_merge_order``) rebuild the outputs in head order: the
reference's decisions, not a copy of its program."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

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


# ---------------------------------------------------------------------------
# The meshes
# ---------------------------------------------------------------------------

_VIRTUAL = None     # (device, count) while a virtual mesh is on


@contextlib.contextmanager
def virtual_mesh(device, count: int = 8):
    """Within the block, ``make_burst_mesh``, ``make_mesh`` and
    ``make_hybrid_mesh`` build their meshes from ``count`` copies of
    ``device`` (e.g. "cpu" in the CPU tests, "cuda:0" on one card)
    instead of the machine's CUDA devices."""
    global _VIRTUAL
    prev = _VIRTUAL
    _VIRTUAL = (torch.device(device), int(count))
    try:
        yield
    finally:
        _VIRTUAL = prev


def _mesh_devices(device) -> list:
    """The virtual mesh's devices when one is on, else ``cuda:0 ..
    cuda:n-1`` for a CUDA ``device``; the CPU is one device."""
    if _VIRTUAL is not None:
        return [_VIRTUAL[0]] * _VIRTUAL[1]
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


@dataclass
class _StreamMesh:
    """An ordered list of devices, one CUDA stream per entry (on CUDA):
    entry s runs on ``devices[s]`` and ``streams[s]``."""
    devices: tuple
    streams: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.devices = tuple(torch.device(d) for d in self.devices)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, s: int):
        """Entry s's device and stream as the current ones."""
        st = self.streams[s]
        if st is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.devices[s]))
        stack.enter_context(torch.cuda.stream(st))
        return stack

    def fetch(self, s: int, t: torch.Tensor) -> np.ndarray:
        with self.on(s):
            return t.cpu().numpy()

    def synchronize(self, s: int) -> None:
        if self.streams[s] is not None:
            self.streams[s].synchronize()


@dataclass
class BurstMesh(_StreamMesh):
    """A 1-D mesh on the axis ``cq``: shard s runs on ``devices[s]`` and,
    on CUDA, on its own stream ``streams[s]``."""
    axis_names: tuple = ("cq",)

    def put(self, arr: np.ndarray, timers=None) -> tuple:
        """A [S * B, ...] host plane → S tensors [B, ...], block s on
        shard s's device (uploaded on its stream)."""
        arr = np.asarray(arr)
        B = arr.shape[0] // self.size
        out = []
        for s in range(self.size):
            t0 = time.perf_counter()
            with self.on(s):
                out.append(torch.from_numpy(np.ascontiguousarray(
                    arr[s * B:(s + 1) * B])).to(self.devices[s]))
            if timers is not None and s < len(timers):
                timers[s] += time.perf_counter() - t0
        return tuple(out)

    def put_ax1(self, arr: np.ndarray) -> tuple:
        """An event schedule [K, S * B, ...] → S tensors [K, B, ...]."""
        arr = np.asarray(arr)
        B = arr.shape[1] // self.size
        out = []
        for s in range(self.size):
            with self.on(s):
                out.append(torch.from_numpy(np.ascontiguousarray(
                    arr[:, s * B:(s + 1) * B])).to(self.devices[s]))
        return tuple(out)

    def gather(self, blocks) -> np.ndarray:
        """S tensors [B, ...] → one host array [S * B, ...] (each block
        read on its own stream)."""
        return np.concatenate(
            [self.fetch(s, b) for s, b in enumerate(blocks)], axis=0)


def make_burst_mesh(n_devices: int, device="cuda"):
    """A 1-D ``("cq",)`` mesh for the forest-partitioned burst kernel,
    or None when ``n_devices < 2`` or fewer devices exist (the caller
    degrades to the serial path); the devices are ``_mesh_devices``'."""
    if n_devices is None or n_devices < 2:
        return None
    devices = _mesh_devices(device)
    if len(devices) < n_devices:
        return None
    return BurstMesh(tuple(devices[:n_devices]))


@dataclass
class CycleMesh(_StreamMesh):
    """The 2-D (wl, cq) mesh of the per-cycle route: ``devices`` row-major
    over ``n_wl`` rows, so cell (i, j) is entry ``cell(i, j)``.  Row i
    takes a slice of a column's heads (``sharded_cycle_fn``'s phase 1),
    column j a shard of the quota plane (whole cohort forests); the
    scans of column j run on its row-0 cell, and cell 0 gathers."""
    n_wl: int = 1
    axis_names: tuple = ("wl", "cq")
    # per CUDA cell: a pinned staging buffer and the event of its last copy
    _stage: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return {"wl": self.n_wl, "cq": self.size // self.n_wl}

    @property
    def grid(self) -> tuple:
        cq = self.shape["cq"]
        return tuple(self.devices[i * cq:(i + 1) * cq]
                     for i in range(self.n_wl))

    def cell(self, i: int, j: int) -> int:
        return i * self.shape["cq"] + j

    def put(self, s: int, *arrays) -> list:
        """Host arrays on cell s's device in one upload on its stream: the
        arrays packed into one byte buffer (each at a 16-byte offset),
        one copy, and each tensor a typed view of its bytes.  A CUDA
        cell stages the bytes in its own pinned buffer, reused once its
        last copy is done, so the copy is asynchronous."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offsets, n = [], 0
        for a in arrays:
            offsets.append(n)
            n += -(-a.nbytes // 16) * 16
        n = max(n, 16)
        if self.streams[s] is None:
            buf = torch.empty(n, dtype=torch.uint8)
        else:
            buf, done = self._stage.get(s, (None, None))
            if buf is None or buf.numel() < n:
                buf = torch.empty(1 << max(12, (n - 1).bit_length()),
                                  dtype=torch.uint8, pin_memory=True)
            elif done is not None:
                done.synchronize()
        host = buf.numpy()
        for a, o in zip(arrays, offsets):
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        with self.on(s):
            dev = buf[:n].to(self.devices[s],
                             non_blocking=self.streams[s] is not None)
            if self.streams[s] is not None:
                done = torch.cuda.Event()
                done.record()
                self._stage[s] = (buf, done)
        return [dev[o:o + a.nbytes].view(_TORCH_DTYPE[a.dtype.str])
                .view(a.shape) for a, o in zip(arrays, offsets)]

    def move(self, ts, src: int, dst: int) -> list:
        """Tensors made on cell src's stream, ready for cell dst's
        stream: one event on src's stream and one wait on dst's, after a
        peer copy of each on src's stream when the devices differ (on a
        virtual mesh they are one device)."""
        ts = list(ts)
        a, b = self.streams[src], self.streams[dst]
        if src != dst and a is not None:
            if self.devices[src] != self.devices[dst]:
                with torch.cuda.stream(a):
                    ts = [t.to(self.devices[dst]) for t in ts]
            ev = torch.cuda.Event()
            ev.record(a)
            b.wait_event(ev)
            for t in ts:
                t.record_stream(b)
        return ts

    def release(self, tensors) -> None:
        """Hand tensors made on cell 0's stream to the caller's current
        stream on that device."""
        st = self.streams[0]
        if st is None:
            return
        cur = torch.cuda.current_stream(self.devices[0])
        cur.wait_stream(st)
        for t in tensors:
            t.record_stream(cur)


_TORCH_DTYPE = {np.dtype(k).str: v for k, v in (
    (np.bool_, torch.bool), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.float32, torch.float32),
    (np.float64, torch.float64))}


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> CycleMesh | None:
    """A 2-D (wl, cq) mesh over the first ``n_devices`` devices
    (``_mesh_devices(device)`` unless ``devices`` are given), factored as
    the JAX package factors it (8 → 4×2, 4 → 2×2, prime p → p×1); None
    when fewer devices exist than asked (the Driver stays serial)."""
    devices = list(_mesh_devices(device) if devices is None else devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            return None
        devices = devices[:n_devices]
    n = len(devices)
    wl = n
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            wl = n // cand
            break
    return CycleMesh(tuple(devices), n_wl=wl)


def make_hybrid_mesh(n_hosts: int | None = None, devices=None,
                     device="cuda") -> CycleMesh:
    """The two-tier layout of the JAX package: each row of the grid is
    one host's devices (the ``cq`` axis stays within a host), the rows
    are the hosts (``wl``).  One process is one host, so with
    ``n_hosts=None`` the shape is {"wl": 1, "cq": n}; ``n_hosts`` splits
    the devices into equal groups, and raises ``ValueError`` when they
    do not split evenly."""
    devices = list(_mesh_devices(device) if devices is None else devices)
    n = len(devices)
    if n_hosts is None:
        n_hosts = 1
    elif n % n_hosts:
        raise ValueError(f"{n} devices do not split into {n_hosts} hosts")
    return CycleMesh(tuple(devices), n_wl=n_hosts)


def cycle_shardings(mesh: CycleMesh) -> tuple:
    """The mesh axis each ``cycle_args`` plane splits on, in signature
    order (the JAX NamedShardings, :60-68): "cq" for the quota-node
    planes (usage0 .. has_blim) and the per-CQ planes (nominal_cq ..
    cq_can_preempt_borrow), None for ``parent`` (replicated there; here
    each shard takes its forests' rows, value-remapped), "wl" for the
    four head planes.  ``CycleShardLayout.column`` splits by it."""
    axes = ("cq",) * 5 + (None,) + ("cq",) * 4 + ("wl",) * 4
    if not {a for a in axes if a} <= set(mesh.axis_names):
        raise ValueError(f"mesh axes {mesh.axis_names}: need wl and cq")
    return axes


# ---------------------------------------------------------------------------
# Fill tables and the forest-partition layout (host numpy, as the JAX
# package's)
# ---------------------------------------------------------------------------

_I32_MAX = np.int32(2**31 - 1)

# pad fills per kernel input: a padded CQ row must never grow a head
# (wl_rank=INF), never hold quota, and never enter any forest's member
# or candidate tables — everything else about it is then inert
_C_FILLS = {
    "wl_req": 0, "wl_rank": _I32_MAX, "wl_cycle_rank": 0, "wl_prio": 0,
    "wl_uidrank": 0, "vec_ok": False,
    "elig0": False, "parked0": False, "resume0": 0, "adm0": False,
    "adm_seq0": 0, "adm_usage0": 0, "adm_uses0": False,
    "death0": _I32_MAX, "u_cq0": 0,
    "nominal_cq": 0, "npb_cq": 0, "slot_fr": -1, "slot_valid": False,
    "cq_can_preempt_borrow": False, "strict_cq": False,
    "cq_wcb_borrow": True, "cq_wcp_preempt": False,
    "wcq_lower": False, "rwc_enabled": False, "rwc_only_lower": False,
    "preempt_ok": False, "self_lmem": 0,
}
_N_FILLS = {
    "potential0": 0, "subtree": 0, "guaranteed": 0, "borrow_cap": 0,
    "has_blim": False,
}
_STATE_FILLS = (False, False, 0, False, 0, 0, False, _I32_MAX, 0)
_STATE_NAMES = ("elig0", "parked0", "resume0", "adm0", "adm_seq0",
                "adm_usage0", "adm_uses0", "death0", "u_cq0")

# Residency tiers for the shard-resident boundary (BurstSolver keeps the
# permuted kernel inputs on the mesh between windows; only the tier that
# actually changed crosses the host→device boundary at a fresh pack):
#
# - STATIC:  pure functions of (structure generation, M, KC) — the
#   layout's value-remapped tables plus the quota plane and per-CQ
#   structure facts.  Permuted + uploaded once per layout lifetime.
# - SCATTER: per-record row facts.  The delta pack re-walks only
#   journal-dirty CQs and splices every other record verbatim
#   (_concat_row_fields), so for a chained delta pack these planes are
#   bit-identical outside the dirty rows — only those rows scatter.
# - GLOBAL:  globally recomputed each pack — dense cross-CQ ranks
#   (cycle/uid), the reservation-seq plane, and the modeling envelope
#   (preempt_ok depends on global scalars).  Always re-uploaded; all
#   are small relative to the row tier.
_ROW_STATIC = ("nominal_cq", "npb_cq", "slot_fr", "slot_valid",
               "cq_can_preempt_borrow", "cq_wcb_borrow",
               "cq_wcp_preempt", "wcq_lower", "rwc_enabled",
               "rwc_only_lower", "self_lmem")
SCATTER_PLANES = ("wl_req", "wl_rank", "wl_prio", "vec_ok", "strict_cq",
                  "elig0", "parked0", "resume0", "adm0", "adm_usage0",
                  "adm_uses0", "death0", "u_cq0")
GLOBAL_PLANES = ("wl_cycle_rank", "wl_uidrank", "adm_seq0", "preempt_ok")


class ForestPartition:
    """Whole cohort forests on the shards of a ``cq`` axis, and each
    shard's local index spaces: the one partition behind both the burst
    layout (``BurstShardLayout``) and the per-cycle layout
    (``CycleShardLayout``).

    Greedy LPT: forests in falling ``weight`` (ties by index) each go to
    the least-loaded shard (ties by shard index); each shard's forests
    are then sorted.  Every shard gets equally padded spaces: Cs CQ
    slots (its forests' CQs in forest order, each forest's in
    ``cqs_of_forest`` order), Gs forest rows, Ns = Cs + Hs quota nodes
    with the CQ nodes first, and ``local_cq`` / ``local_node`` /
    ``local_forest`` give each global id's local one."""

    def __init__(self, weight, n_shards: int, cqs_of_forest,
                 forest_of_node, n_cqs: int):
        S = int(n_shards)
        G = len(weight)
        C = int(n_cqs)
        N = len(forest_of_node)
        load = [0.0] * S
        forests_of: list[list[int]] = [[] for _ in range(S)]
        for g in sorted(range(G), key=lambda g: (-float(weight[g]), g)):
            s = min(range(S), key=lambda i: (load[i], i))
            forests_of[s].append(g)
            load[s] += float(weight[g])
        self.shard_cost = [round(x, 6) for x in load]
        mean_load = sum(load) / max(1, S)
        self.cost_ratio = (round(max(load) / mean_load, 4)
                           if mean_load > 0 else 1.0)
        for fl in forests_of:
            fl.sort()
        self.forests_of = forests_of
        shard_of_forest = np.zeros(max(G, 1), dtype=np.int32)
        local_forest = np.zeros(max(G, 1), dtype=np.int32)
        for s, fl in enumerate(forests_of):
            for j, g in enumerate(fl):
                shard_of_forest[g] = s
                local_forest[g] = j
        self.shard_of_forest = shard_of_forest
        self.local_forest = local_forest

        cqs_of: list[list[int]] = [[] for _ in range(S)]
        for s, fl in enumerate(forests_of):
            for g in fl:
                cqs_of[s].extend(cqs_of_forest[g])
        cohorts_of: list[list[int]] = [[] for _ in range(S)]
        for nd in range(C, N):
            f = int(forest_of_node[nd])
            s = int(shard_of_forest[f]) if 0 <= f < G else 0
            cohorts_of[s].append(nd)

        Cs = max(1, max(len(x) for x in cqs_of))
        Gs = max(1, max(len(x) for x in forests_of))
        Hs = max(len(x) for x in cohorts_of)
        self.Cs, self.Gs, self.Ns = Cs, Gs, Cs + Hs
        cq_perm = np.full((S, Cs), -1, dtype=np.int32)
        cq_pos = np.zeros(C, dtype=np.int64)
        local_cq = np.zeros(C, dtype=np.int32)
        for s, cqs in enumerate(cqs_of):
            for j, cq in enumerate(cqs):
                cq_perm[s, j] = cq
                cq_pos[cq] = s * Cs + j
                local_cq[cq] = j
        node_perm = np.full((S, self.Ns), -1, dtype=np.int32)
        node_perm[:, :Cs] = cq_perm
        local_node = np.zeros(N, dtype=np.int32)
        local_node[:C] = local_cq
        for s, cohs in enumerate(cohorts_of):
            for j, nd in enumerate(cohs):
                node_perm[s, Cs + j] = nd
                local_node[nd] = Cs + j
        forest_perm = np.full((S, Gs), -1, dtype=np.int32)
        for s, fl in enumerate(forests_of):
            for j, g in enumerate(fl):
                forest_perm[s, j] = g
        self.cq_perm, self.cq_pos, self.local_cq = cq_perm, cq_pos, local_cq
        self.node_perm, self.local_node = node_perm, local_node
        self.forest_perm = forest_perm


class BurstShardLayout:
    """Forest-partition of a burst plan across a 1-D ``cq`` mesh.

    Cohort forests are the fused kernel's independence boundary: every
    comparison it makes (heads argmin, candidate ordering, the
    entryOrdering sort, the admit scan's lanes) stays inside one forest,
    and all ordering keys are host-precomputed GLOBAL ranks carried by
    value — so partitioning whole forests onto shards, with the dirty
    reduction as a psum, reproduces the serial decisions bit-for-bit.

    The layout assigns forests to shards greedily onto the least-loaded
    shard — by CQ count, or by measured per-forest cycle cost when the
    solver has an EWMA from prior windows (``forest_cost``; assignment
    never affects decisions, every rank is carried by value).  It gives
    every shard equally padded
    local index spaces (Cs CQ slots, Gs forest rows, Ns = Cs + Hs quota
    nodes with CQ nodes first — the kernel's ``usage[:C]`` convention),
    and VALUE-REMAPS the member/candidate tables into local ids at
    identical slot positions, so ``tgt_words`` bit j still means global
    candidate slot j and the driver's apply path is untouched."""

    def __init__(self, plan, n_shards: int, forest_cost=None):
        a = plan.arrays
        st = plan.structure
        C, M, G, L, KC = plan.C, plan.M, plan.G, plan.L, plan.KC
        S = int(n_shards)
        self.n_shards = S
        self.M = M
        self._static_dev = None   # device-resident statics (solver tier)
        forest_of_cq = np.asarray(a["forest_of_cq"])
        parent = np.asarray(a["parent"])
        node_level = np.asarray(a["node_level"])
        members = np.asarray(a["members"])
        cand_rows = np.asarray(a["cand_rows"])
        cand_lmem = np.asarray(a["cand_lmem"])

        # "big" is CQ count by default; with a measured per-forest cycle
        # cost (EWMA of decided heads per window) the cost is the load,
        # with a small size term so never-fired forests still spread
        counts = np.bincount(forest_of_cq, minlength=G)
        if forest_cost is not None and len(forest_cost) == G:
            weight = (np.asarray(forest_cost, dtype=np.float64)
                      + 1e-6 * counts)
            self.cost_balanced = True
        else:
            weight = counts.astype(np.float64)
            self.cost_balanced = False
        part = ForestPartition(
            weight, S, [[int(cq) for cq in members[g] if cq >= 0]
                        for g in range(G)],
            np.asarray(st.forest_of_node), C)
        self.shard_cost, self.cost_ratio = part.shard_cost, part.cost_ratio
        self.Cs, self.Gs, self.Ns = part.Cs, part.Gs, part.Ns
        self.cq_perm, self.cq_pos = part.cq_perm, part.cq_pos
        self.node_perm, self.forest_perm = part.node_perm, part.forest_perm
        forests_of, local_cq = part.forests_of, part.local_cq
        local_node, local_forest = part.local_node, part.local_forest
        Cs, Gs, Ns = self.Cs, self.Gs, self.Ns
        node_perm, cq_perm = self.node_perm, self.cq_perm

        # value-remapped static tables (slot positions preserved)
        members_l = np.full((S * Gs, L), -1, dtype=np.int32)
        cand_rows_l = np.full((S * Gs, KC), -1, dtype=np.int32)
        cand_lmem_l = np.zeros((S * Gs, KC), dtype=np.int32)
        for s, fl in enumerate(forests_of):
            for j, g in enumerate(fl):
                r = s * Gs + j
                mrow = members[g]
                mv = mrow >= 0
                members_l[r][mv] = local_cq[mrow[mv]]
                crow = cand_rows[g]
                cv = crow >= 0
                crs = crow[cv]
                cand_rows_l[r][cv] = (local_cq[crs // M] * M
                                      + crs % M).astype(np.int32)
                cand_lmem_l[r] = cand_lmem[g]
        parent_l = np.full(S * Ns, -1, dtype=np.int32)
        node_level_l = np.zeros(S * Ns, dtype=np.int32)
        flat_nodes = node_perm.ravel()
        nv = flat_nodes >= 0
        pv = parent[flat_nodes[nv]]
        parent_l[nv] = np.where(pv >= 0, local_node[np.maximum(pv, 0)],
                                -1).astype(np.int32)
        node_level_l[nv] = node_level[flat_nodes[nv]]
        forest_of_cq_l = np.zeros(S * Cs, dtype=np.int32)
        fc = cq_perm.ravel()
        cvv = fc >= 0
        forest_of_cq_l[cvv] = local_forest[forest_of_cq[fc[cvv]]]
        self._static = {
            "members": members_l, "cand_rows": cand_rows_l,
            "cand_lmem": cand_lmem_l, "parent": parent_l,
            "node_level": node_level_l, "forest_of_cq": forest_of_cq_l,
        }

    # -- per-shard-timed permutation helpers ---------------------------
    def _permute(self, src, perm, fill, timers):
        import time as _time
        S, B = perm.shape
        out = np.full((S * B,) + src.shape[1:], fill, dtype=src.dtype)
        for s in range(S):
            t0 = _time.perf_counter()
            row = perm[s]
            v = row >= 0
            out[s * B:(s + 1) * B][v] = src[row[v]]
            if timers is not None and s < len(timers):
                timers[s] += _time.perf_counter() - t0
        return out

    def permute_rows(self, arr, fill=0, timers=None):
        """[C, ...] → [S*Cs, ...] (pad rows filled)."""
        return self._permute(np.asarray(arr), self.cq_perm, fill, timers)

    def permute_nodes(self, arr, fill=0, timers=None):
        """[N, ...] → [S*Ns, ...] (CQ nodes first per shard)."""
        return self._permute(np.asarray(arr), self.node_perm, fill,
                             timers)

    def permute_state(self, state, timers=None):
        """The 9-tuple of scan-state arrays, global → shard layout."""
        return tuple(
            self.permute_rows(arr, fill, timers)
            for arr, fill in zip(state, _STATE_FILLS))

    def permute_ext(self, ext_release, ext_unpark):
        """Event schedules [K, C, F] / [K, G] → shard layout on axis 1."""
        def ax1(arr, perm, fill):
            flat = perm.ravel()
            out = np.full((arr.shape[0], flat.size) + arr.shape[2:],
                          fill, dtype=arr.dtype)
            v = flat >= 0
            out[:, v] = arr[:, flat[v]]
            return out
        return (ax1(np.asarray(ext_release), self.cq_perm, 0),
                ax1(np.asarray(ext_unpark), self.forest_perm, False))

    def static_arrays(self, plan, timers=None):
        """The permuted STATIC-tier planes: the value-remapped layout
        tables plus every input that is a pure function of (structure
        generation, M, KC).  Cached on the layout — valid for its whole
        lifetime, which is exactly one (generation, C, M, G, L, KC)."""
        cached = getattr(self, "_static_host", None)
        if cached is not None:
            return cached
        a = plan.arrays
        out = dict(self._static)
        for name in _ROW_STATIC:
            out[name] = self.permute_rows(a[name], _C_FILLS[name], timers)
        for name, fill in _N_FILLS.items():
            out[name] = self.permute_nodes(a[name], fill, timers)
        self._static_host = out
        return out

    def plan_arrays(self, plan, timers=None):
        """The permuted kernel-input dict for ``plan``, cached on the
        plan object (chained windows reuse it untouched).  Scan-state
        planes flow through permute_state, not this dict."""
        cached = getattr(plan, "_shard_arrays", None)
        if cached is not None and cached[0] is self:
            return cached[1]
        a = plan.arrays
        out = dict(self.static_arrays(plan, timers))
        for name in SCATTER_PLANES + GLOBAL_PLANES:
            if name in _STATE_NAMES:
                continue   # scan state flows through permute_state
            out[name] = self.permute_rows(a[name], _C_FILLS[name], timers)
        plan._shard_arrays = (self, out)
        return out


# ---------------------------------------------------------------------------
# The two kernels around the per-shard burst, with their plain versions
# ---------------------------------------------------------------------------

def unpack_scatter_rows(planes, buf, count: int):
    """Typed views of a packed row-scatter buffer
    (``ops.packing.pack_scatter_rows``) laid out for ``planes``: (rows
    int32 [count], each plane's value rows [count, ...])."""
    from ..ops.packing import scatter_layout
    offsets, row_bytes, n = scatter_layout(planes, count)
    if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.numel() != n:
        raise ValueError(f"buffer {buf.dtype}{tuple(buf.shape)}: expected "
                         f"uint8 [{n}] for {count} rows")
    rows = buf[:4 * count].view(torch.int32)
    vals = [buf[o:o + count * rb].view(p.dtype).view(
        (count,) + tuple(p.shape[1:]))
        for p, o, rb in zip(planes, offsets, row_bytes)]
    return rows, vals


def scatter_rows_plain(planes, buf, count: int):
    """``plane[rows[i]] = vals[i]`` for every plane, in place, where the
    rows and values come packed in ``buf`` (``unpack_scatter_rows``); a
    row r in [-n, 0) writes row n + r, and a row below -n or at n and
    past it is dropped, as NumPy indexing does.  Returns the planes as a
    tuple (kueue_tpu/ops/burst.py ``_scatter_rows_fn``, whose
    ``a.at[rows].set(v)`` returns new arrays with the same values,
    wraps a negative index once and drops one out of range)."""
    rows, vals = unpack_scatter_rows(planes, buf, count)
    n = planes[0].shape[0]
    keep = (rows >= -n) & (rows < n)
    r = rows[keep].long()
    idx = torch.where(r < 0, r + n, r)
    for p, v in zip(planes, vals):
        p[idx] = v[keep]
    return tuple(planes)


def scatter_rows(planes, buf, count: int):
    """The resident row scatter of ``count`` packed rows: one
    ``kernels.kq_scatter_rows`` launch for all planes of a CUDA buffer,
    ``scatter_rows_plain`` for a CPU one; raises for any other
    device."""
    if buf.device.type == "cuda":
        from .. import kernels
        return kernels.kq_scatter_rows(planes, buf, count)
    if buf.device.type != "cpu":
        raise ValueError(f"no scatter kernel for device {buf.device}")
    return scatter_rows_plain(planes, buf, count)


def reduce_dflags_plain(window):
    """The sum over s of a window's [S, K, 4] int32 dirty-flag rows, one
    per shard: [K, 4] int32, wrapping (the ``psum`` at
    kueue_tpu/ops/burst.py:789-790)."""
    return window.sum(0, dtype=torch.int32)


def reduce_dflags(window):
    """The cross-shard dirty-flag reduction: ``kernels.kq_reduce_dflags``
    for a CUDA window, ``reduce_dflags_plain`` for a CPU one."""
    if window.device.type == "cuda":
        from .. import kernels
        return kernels.kq_reduce_dflags(window)
    if window.device.type != "cpu":
        raise ValueError(f"no reduction kernel for device {window.device}")
    return reduce_dflags_plain(window)


def shard_node_tables(mesh: BurstMesh, layout: BurstShardLayout) -> list:
    """Each shard's per-forest node table for the CUDA burst kernel
    (``kernels.burst_node_table`` of its local parent / node_level /
    forest_of_cq), on its device; None entries on CPU shards."""
    from .. import kernels
    st = layout._static
    Ns, Cs, Gs = layout.Ns, layout.Cs, layout.Gs
    out = []
    for s, dev in enumerate(mesh.devices):
        if dev.type != "cuda":
            out.append(None)
            continue
        with mesh.on(s):
            out.append(kernels.burst_node_table(
                st["parent"][s * Ns:(s + 1) * Ns],
                st["node_level"][s * Ns:(s + 1) * Ns],
                st["forest_of_cq"][s * Cs:(s + 1) * Cs], Gs, dev))
    return out


def sharded_burst(mesh: BurstMesh, arrays: dict, state, seq_base: int,
                  ext, *, K: int, depth: int, L: int, S: int, KC: int,
                  n_levels: int, G: int, runtime: int, node_tables=None):
    """The fused burst over a forest-sharded plan (the JAX
    ``sharded_burst_fn``): shard s's block of every CQ-, node- and
    forest-indexed input (``arrays[name][s]``, ``state[i][s]``,
    ``ext[i][s]``; local C = Cs, N = Ns, G = Gs) goes to
    ``ops.burst.burst_cycles`` on shard s's device and stream, with
    ``seq_base`` replicated; then ``reduce_dflags`` sums the window's
    S [K, 4] flag rows on shard 0's device.  The window [S, K, 4] int32
    is zeroed once on shard 0's stream; a shard on shard 0's device
    writes its flags straight into its row, another device's block
    arrives with one peer copy; shard 0's stream waits on every shard's.

    Returns ``(outs, dirty, dirty_reason)``: ``outs[s]`` is shard s's
    ``(head_row, kind, slot, borrows, tgt_words, dflags, carry)`` on its
    device, and the flags are shard 0's."""
    from ..ops import burst as _burst
    from ..ops.burst import ARG_NAMES
    dev0 = mesh.devices[0]
    with mesh.on(0):
        window = torch.zeros((mesh.size, K, 4), dtype=torch.int32,
                             device=dev0)
        zeroed = None
        if mesh.streams[0] is not None:
            zeroed = torch.cuda.Event()
            zeroed.record()
    outs = []
    for s in range(mesh.size):
        vals = {n: state[i][s] for i, n in enumerate(_STATE_NAMES)}
        vals["seq_base"] = int(seq_base)
        vals["ext_release"], vals["ext_unpark"] = ext[0][s], ext[1][s]
        args = [vals[n] if n in vals else arrays[n][s] for n in ARG_NAMES]
        kw = dict(K=K, depth=depth, L=L, S=S, KC=KC, n_levels=n_levels,
                  G=G, runtime=runtime, dflags_out=True)
        if node_tables is not None and node_tables[s] is not None:
            kw["node_table"] = node_tables[s]
        if mesh.devices[s] == dev0:
            kw["dflags"] = window[s]
        with mesh.on(s):
            if s and zeroed is not None and mesh.devices[s] == dev0:
                mesh.streams[s].wait_event(zeroed)
            outs.append(_burst.burst_cycles(*args, **kw))
    with mesh.on(0):
        for s in range(1, mesh.size):
            if mesh.streams[s] is None:
                continue
            if mesh.devices[s] != dev0:
                # a peer copy of the [K, 4] block (16 x K bytes: 512 at
                # K = 32) into row s, on shard s's stream after the zeroing
                with torch.cuda.stream(mesh.streams[s]):
                    mesh.streams[s].wait_event(zeroed)
                    window[s].copy_(outs[s][5])
            ev = torch.cuda.Event()
            ev.record(mesh.streams[s])
            mesh.streams[0].wait_event(ev)
        dflags = reduce_dflags(window)
        dirty, dirty_reason = _burst.dirty_flags(dflags)
    return outs, dirty, dirty_reason


# ---------------------------------------------------------------------------
# The per-cycle mesh: the forest layout of one structure, the sharded admit
# scans, fair-sharing scan and one-call solver
# ---------------------------------------------------------------------------

# the fill of a padded row of each node-indexed (CQ nodes first) and
# CQ-indexed plane the per-cycle programs take: the JAX _mesh_pad and
# fs_scan_fn fills; SOLVE_NAMES names the cycle_args planes in order
_NODE_FILLS = {"usage0": 0, "subtree": 0, "guaranteed": 0, "borrow_cap": 0,
               "has_blim": False, "sq_mask": False, "node_level": 0,
               "weights": 1, "lendable_r": 0, "child_order": 0}
_CQ_FILLS = {"nominal_cq": 0, "npb_cq": 0, "slot_fr": -1,
             "slot_valid": False, "cq_can_preempt_borrow": False}
SOLVE_NAMES = ("usage0", "subtree", "guaranteed", "borrow_cap", "has_blim",
               "parent", "nominal_cq", "slot_fr", "slot_valid",
               "cq_can_preempt_borrow", "wl_cq", "wl_requests",
               "wl_priority", "wl_timestamp")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def forests_of_parent(parent) -> np.ndarray:
    """forest_of_node [N] from a parent table, numbered as the packer
    numbers them: forests in the order of their first node."""
    parent = np.asarray(parent)
    root = np.arange(len(parent))
    for _ in range(len(parent)):
        up = parent[root]
        if not (up >= 0).any():
            break
        root = np.where(up >= 0, up, root)
    _, first, forest = np.unique(root, return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(first), dtype=np.int32)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[forest].astype(np.int32)


class CycleShardLayout:
    """Whole cohort forests of one quota structure on the ``cq`` shards.

    Built per structure (the solver caches it on its ``PackedStructure``
    per mesh) from ``parent`` and ``forest_of_node`` (derived from
    ``parent`` when not given), with the CQ count ``n_cqs`` (all nodes
    when None: fair sharing indexes its heads' CQs as nodes).  Shard j
    owns the padded local index spaces of ``ForestPartition`` (Cs CQ
    slots, then its cohorts): its node and CQ rows, ``parent``
    value-remapped to local ids, its local ``forest_of_node``, its
    forest count and the most local nodes of one forest.  Per cycle,
    ``heads`` routes each head to the shard of its CQ's forest, in
    ascending global index; a head with ``wl_cq < 0`` belongs to no
    shard.  While it routes them it builds ``src``, the
    head gather's source map over the shards with heads (``live``).

    Device copies of the statics (``static``) are cached per cell of a
    mesh: a layout must only be given the planes of its own structure."""

    def __init__(self, parent, n_cqs: int | None, n_shards: int,
                 forest_of_node=None):
        parent = np.asarray(parent)
        N = len(parent)
        C = N if n_cqs is None else int(n_cqs)
        fon = (forests_of_parent(parent) if forest_of_node is None
               else np.asarray(forest_of_node))
        G = max(int(fon.max(initial=-1)) + 1, 1)
        cqs_of_forest: list[list[int]] = [[] for _ in range(G)]
        for cq in range(C):
            cqs_of_forest[int(fon[cq])].append(cq)
        part = ForestPartition(
            np.bincount(fon[:C], minlength=G).astype(np.float64),
            n_shards, cqs_of_forest, fon, C)
        self.part = part
        self.n_shards = int(n_shards)
        self.forest_of_node = fon
        self.shard_of_cq = part.shard_of_forest[fon[:C]]
        self.n_forests = [len(fl) for fl in part.forests_of]
        self.parent_local, self.forest_local = [], []
        for s in range(self.n_shards):
            nodes = part.node_perm[s]
            v = nodes >= 0
            pl = np.full(part.Ns, -1, dtype=np.int32)
            pv = parent[nodes[v]]
            pl[v] = np.where(pv >= 0, part.local_node[np.maximum(pv, 0)], -1)
            fl = np.zeros(part.Ns, dtype=np.int32)
            fl[v] = part.local_forest[fon[nodes[v]]]
            self.parent_local.append(pl)
            self.forest_local.append(fl)
        # the most local nodes of one forest per shard (padding rows sit
        # in local forest 0): the fair-sharing kernel's block size
        self.max_forest = [int(np.bincount(fl).max()) if len(fl) else 1
                           for fl in self.forest_local]
        self.live: list = []        # shards with heads, last ``heads``
        self.empty_shards = 0       # shards without, last ``heads``
        self.src = np.zeros(0, dtype=np.int32)  # source map, last ``heads``
        self._dev: dict = {}

    # -- host routing ---------------------------------------------------
    def heads(self, wl_cq, valid=None) -> list:
        """Each shard's heads (global indices, ascending, int32); sets
        ``live`` and ``src``, the source map of the live shards' heads
        in that order (``source_map``)."""
        wl_cq = np.asarray(wl_cq)
        ok = wl_cq >= 0
        if valid is not None:
            ok &= np.asarray(valid)
        shard = np.where(ok, self.shard_of_cq[np.maximum(wl_cq, 0)], -1)
        out = [np.flatnonzero(shard == s).astype(np.int32)
               for s in range(self.n_shards)]
        self.live = [s for s, h in enumerate(out) if len(h)]
        self.empty_shards = self.n_shards - len(self.live)
        self.src = source_map([out[s] for s in self.live], len(wl_cq))
        return out

    def rows(self, arr, s: int, name: str) -> np.ndarray:
        """Shard s's rows of a node or CQ plane (padded rows filled)."""
        arr = np.asarray(arr)
        if name in _NODE_FILLS:
            perm, fill = self.part.node_perm[s], _NODE_FILLS[name]
        else:
            perm, fill = self.part.cq_perm[s], _CQ_FILLS[name]
        out = np.full((len(perm),) + arr.shape[1:], fill, dtype=arr.dtype)
        v = perm >= 0
        out[v] = arr[perm[v]]
        return out

    def local_cq(self, wl_cq, h) -> np.ndarray:
        return self.part.local_cq[np.asarray(wl_cq)[h]]

    @staticmethod
    def local_order(order, h, W: int) -> np.ndarray:
        """The global ``order`` restricted to heads ``h``, as local ids:
        ranks are carried by value, so no sort runs per shard."""
        pos = np.full(W, -1, dtype=np.int32)
        pos[h] = np.arange(len(h), dtype=np.int32)
        o = pos[np.asarray(order)]
        return o[o >= 0]

    def targets(self, h, wl_cq, tgt_mat, tu_cq, tu_delta):
        """Shard rows of the preemption targets of heads ``h``: (tgt_mat
        [W_s, MT] value-remapped to local target ids, tu_cq [T_s] local
        CQs, tu_delta [T_s, F]).  A target outside its head's cohort
        forest raises ``ValueError``: a Kueue cycle never has one
        (preemption stays within the preemptor's cohort tree)."""
        tgt = np.asarray(tgt_mat)[h]
        tu_cq, tu_delta = np.asarray(tu_cq), np.asarray(tu_delta)
        on = tgt >= 0
        fon = self.forest_of_node
        head_f = np.broadcast_to(fon[np.asarray(wl_cq)[h]][:, None],
                                 tgt.shape)
        tgt_f = fon[tu_cq[np.maximum(tgt, 0)]]
        bad = on & (tgt_f != head_f)
        if bad.any():
            r, c = np.argwhere(bad)[0]
            raise ValueError(
                f"head {int(h[r])}: preemption target {int(tgt[r, c])} in "
                f"cohort forest {int(tgt_f[r, c])}, not its own "
                f"{int(head_f[r, c])}; a forest-sharded scan cannot "
                f"remove it")
        used = np.unique(tgt[on])
        local = np.full(len(tu_cq), -1, dtype=np.int32)
        local[used] = np.arange(len(used), dtype=np.int32)
        tgt_l = np.where(on, local[np.maximum(tgt, 0)], -1).astype(np.int32)
        T = max(1, len(used))
        cq_l = np.zeros(T, dtype=np.int32)
        cq_l[:len(used)] = self.part.local_cq[tu_cq[used]]
        delta_l = np.zeros((T,) + tu_delta.shape[1:], dtype=tu_delta.dtype)
        delta_l[:len(used)] = tu_delta[used]
        return tgt_l, cq_l, delta_l

    # -- device planes --------------------------------------------------
    def static(self, mesh: CycleMesh, cell: int, s: int, name: str,
               arr=None) -> torch.Tensor:
        """Shard s's rows of a structure plane on ``cell`` (uploaded once
        per mesh cell): "parent" and "forest_of_node" are the layout's
        own tables, "onehot" is whole, the rest are ``rows(arr, s)``."""
        key = (id(mesh), cell, name)
        t = self._dev.get(key)
        if t is None:
            if name == "parent":
                host = self.parent_local[s]
            elif name == "forest_of_node":
                host = self.forest_local[s]
            elif name == "onehot":
                host = np.asarray(arr)
            else:
                host = self.rows(arr, s, name)
            t = self._dev[key] = mesh.put(cell, host)[0]
        return t

    def column(self, mesh: CycleMesh, cell: int, s: int, args, h) -> list:
        """The 14 ``solve_cycle`` planes of shard s's heads ``h`` on
        ``cell`` (one upload), split by ``cycle_shardings``: "cq" planes
        by rows, ``parent`` value-remapped, "wl" planes by heads
        (``wl_cq`` remapped to local CQs)."""
        host = []
        for name, a, axis in zip(SOLVE_NAMES, args,
                                 cycle_shardings(mesh)):
            if axis == "wl":
                host.append(self.local_cq(a, h) if name == "wl_cq"
                            else a[h])
            elif axis is None:
                host.append(self.parent_local[s])
            else:
                host.append(self.rows(a, s, name))
        return mesh.put(cell, *host)


def _gather(mesh: CycleMesh, done: list, fills, src) -> tuple:
    """Per-head outputs back in head order on cell 0 → (the [W] planes,
    each shard's outputs on cell 0).  ``done`` holds (cell, outputs) per
    shard that ran, in the slot order of ``src``, the layout's source map
    [W] (a tensor on cell 0, else uploaded here).  Each shard's outputs
    reach cell 0 in one move, and ``gather_heads`` launches once for the
    first ``len(fills)`` outputs of every shard.  With no shard run (no
    head in any forest) the planes are the fills."""
    moved = []
    with mesh.on(0):
        if not done:
            out = tuple(torch.full(
                (len(src),), f, dtype=torch.bool if isinstance(f, bool)
                else torch.int32, device=mesh.devices[0]) for f in fills)
        else:
            if not isinstance(src, torch.Tensor):
                src = mesh.put(0, src)[0]
            moved = [mesh.move(outs, cell, 0) for cell, outs in done]
            out = gather_heads(tuple(tuple(m[p] for m in moved)
                                     for p in range(len(fills))),
                               src, fills)
    mesh.release(out)
    return out, moved


def _put_with_src(mesh: CycleMesh, cell: int, layout, *host):
    """``mesh.put(cell, *host)``, with the layout's source map in the same
    upload when the cell is cell 0 → (tensors, the map: a tensor on cell
    0, or the host array for ``_gather`` to upload)."""
    if cell != 0:
        return mesh.put(cell, *host), layout.src
    *up, src = mesh.put(cell, *host, layout.src)
    return up, src


def _admit_sharded(mesh: CycleMesh, depth: int, kind: str, base, order, *,
                   layout=None, preempt=None, forest_of_node=None,
                   max_forest_wl=None, errors=None):
    """One admit scan over the mesh: shard j's heads on its row-0 cell,
    on its stream, with the kernel of ``kind``; then the head gather.
    The preempt kernel gets its shard's forest tables; with ``errors`` (a
    list) each CUDA launch's error word is appended to it for the caller
    to read, else the launcher reads it."""
    from ..ops import cycle as _cycle
    base = tuple(_host(a) for a in base)
    order = _host(order)
    (usage0, subtree, guaranteed, borrow_cap, has_blim, parent, nominal_cq,
     npb_cq, wl_cq) = base[:9]
    if layout is None:
        layout = CycleShardLayout(parent, nominal_cq.shape[0],
                                  mesh.shape["cq"], forest_of_node)
    W = wl_cq.shape[0]
    if kind == "preempt":
        pmask, pre_fr, pre_amt, tgt_mat, tu_cq, tu_delta = (
            _host(a) for a in preempt)
    done = []
    heads = layout.heads(wl_cq)
    src = layout.src
    for j, h in enumerate(heads):
        if not len(h):
            continue
        cell = mesh.cell(0, j)
        with mesh.on(cell):
            stat = [layout.static(mesh, cell, j, name, a) for name, a in (
                ("subtree", subtree), ("guaranteed", guaranteed),
                ("borrow_cap", borrow_cap), ("has_blim", has_blim),
                ("parent", None), ("nominal_cq", nominal_cq),
                ("npb_cq", npb_cq))]
            host = ([layout.rows(usage0, j, "usage0"),
                     layout.local_cq(wl_cq, h)]
                    + [a[h] for a in base[9:]]
                    + [layout.local_order(order, h, W)])
            if kind == "preempt":
                host += [pmask[h], pre_fr[h], pre_amt[h],
                         *layout.targets(h, wl_cq, tgt_mat, tu_cq, tu_delta)]
            (usage, wl, *dev), src = _put_with_src(mesh, cell, layout,
                                                   *host)
            args = [usage] + stat + [wl] + dev[:7]
            ordr = dev[7]
            if kind == "preempt":
                error = None
                if errors is not None and usage.device.type == "cuda":
                    error = torch.zeros(1, dtype=torch.int32,
                                        device=usage.device)
                    errors.append(error)
                out = _cycle.admit_scan_preempt(
                    *args, *dev[8:], ordr, depth=depth,
                    forest_of_node=layout.static(mesh, cell, j,
                                                 "forest_of_node"),
                    n_forests=layout.n_forests[j], error=error)
            elif kind == "forest":
                out = (_cycle.admit_scan_forests(
                    *args, ordr,
                    layout.static(mesh, cell, j, "forest_of_node"),
                    depth=depth, n_forests=layout.n_forests[j],
                    max_forest_wl=max_forest_wl),)
            else:
                out = (_cycle.admit_scan(*args, ordr, depth=depth),)
        done.append((cell, out))
    out, _ = _gather(mesh, done, (False,) * (3 if kind == "preempt" else 1),
                     src)
    return out if kind == "preempt" else out[0]


def admit_scan_fns(mesh: CycleMesh, depth: int) -> dict:
    """The production admit scans over the mesh (the JAX
    ``admit_scan_fns``): {"flat", "forest", "preempt"}, each with the
    positional signature of its unsharded kernel (numpy arrays or
    tensors), the forest one with ``forest_of_node=``, ``n_forests=``
    and ``max_forest_wl=`` keywords (``n_forests`` is the global count
    of the reference's signature: each shard launches with its own).  Each call routes the heads to
    their forests' shards, uploads each shard's sub-problem on its
    stream (the structure planes once per ``layout=`` and cell, when the
    caller passes its structure's ``CycleShardLayout``), launches the
    unsharded kernel per shard that has heads (``max_forest_wl`` is the
    global bucket, at least each shard's own), and gathers the [W]
    outputs into head order on cell 0.  Preemption targets go with their
    forests (the reference replicates the target universe); the preempt
    call takes ``errors=`` as ``_admit_sharded``."""
    def flat(*args, layout=None):
        return _admit_sharded(mesh, depth, "flat", args[:16], args[16],
                              layout=layout)

    def forests(*args, forest_of_node, n_forests, max_forest_wl,
                layout=None):
        del n_forests     # each shard launches with its own count
        return _admit_sharded(mesh, depth, "forest", args[:16], args[16],
                              layout=layout, forest_of_node=forest_of_node,
                              max_forest_wl=max_forest_wl)

    def preempt(*args, layout=None, errors=None):
        return _admit_sharded(mesh, depth, "preempt", args[:16], args[22],
                              layout=layout, preempt=args[16:22],
                              errors=errors)

    return {"flat": flat, "forest": forests, "preempt": preempt}


_FS_STATICS = ("subtree", "sq_mask", "guaranteed", "borrow_cap",
               "has_blim", "parent", "node_level", "weights", "lendable_r",
               "onehot", "child_order")


def fs_scan_fn(mesh: CycleMesh, depth: int, n_levels: int):
    """``fs_admit_scan`` over the mesh (the JAX ``fs_scan_fn``): per
    ``cq`` shard, the kernel on its forests' node rows and its valid
    heads (ascending global index, so ``e0``, the tournament's ties and
    every rank, all carried by value, give the global answer);
    ``onehot`` whole.  ``admitted`` and ``processed`` come back through
    ``gather_heads``, ``order`` through ``fs_merge_order``.  The call
    takes ``fs_admit_scan``'s positional arguments (``forest_of_node``
    last, optional) and ``layout=``.  The reference pads nodes and heads
    to mesh-divisible sizes for GSPMD (:171-190); a forest layout needs
    no such padding, and the outputs are [W] for W heads."""
    def call(usage0, subtree, sq_mask, guaranteed, borrow_cap, has_blim,
             parent, node_level, weights, lendable_r, onehot, child_order,
             wl_cq, u_e, nofit, prio, ts_rank, valid, forest_of_node=None,
             *, layout=None):
        from ..ops import fs_scan as _fs
        planes = dict(zip(_FS_STATICS, (
            subtree, sq_mask, guaranteed, borrow_cap, has_blim, parent,
            node_level, weights, lendable_r, onehot, child_order)))
        usage0, wl_cq, valid = _host(usage0), _host(wl_cq), _host(valid)
        heads_planes = [_host(a) for a in (u_e, nofit, prio, ts_rank)]
        if layout is None:
            layout = CycleShardLayout(_host(parent), None, mesh.shape["cq"],
                                      None if forest_of_node is None
                                      else _host(forest_of_node))
        W = wl_cq.shape[0]
        done = []
        heads = layout.heads(wl_cq, valid)
        src = layout.src
        for j, h in enumerate(heads):
            if not len(h):
                continue
            cell = mesh.cell(0, j)
            with mesh.on(cell):
                stat = [layout.static(mesh, cell, j, name,
                                      None if name == "parent"
                                      else _host(planes[name]))
                        for name in _FS_STATICS]
                (h_dev, usage, wl, *dev), src = _put_with_src(
                    mesh, cell, layout, h, layout.rows(usage0, j, "usage0"),
                    layout.local_cq(wl_cq, h),
                    *(a[h] for a in heads_planes),
                    np.ones(len(h), dtype=bool))
                order, admitted, processed = _fs.fs_admit_scan(
                    usage, *stat, wl, *dev,
                    layout.static(mesh, cell, j, "forest_of_node"),
                    depth=depth, n_levels=n_levels,
                    n_forests=layout.n_forests[j],
                    max_forest=layout.max_forest[j])
            done.append((cell, (admitted, processed, order, h_dev)))
        (admitted, processed), moved = _gather(mesh, done, (False, False),
                                               src)
        with mesh.on(0):
            if done:
                order = fs_merge_order(tuple(m[2] for m in moved),
                                       tuple(m[3] for m in moved), W)
            else:
                order = torch.full((W,), -1, dtype=torch.int32,
                                   device=mesh.devices[0])
        mesh.release((order,))
        return order, admitted, processed

    return call


def sharded_cycle_fn(mesh: CycleMesh, depth: int, run_scan: bool = True):
    """``solve_cycle`` over the mesh (the JAX ``sharded_cycle_fn``): a
    step taking the 14 ``cycle_args`` planes (numpy arrays or tensors)
    and returning its six [W] outputs (admitted, slots, borrows,
    preempt0, fit_slot0, borrows0) on cell 0.

    Column j holds whole cohort forests (``cycle_shardings`` splits each
    plane); its heads, in ascending global index, are split over ``wl``
    in slices, and cell (i, j) runs phase 1 on slice i: ``kq_cq_avail``
    over the column's CQs, then ``kq_classify_heads``.  The slices are
    gathered on (0, j), where ``kq_cycle_order`` and the flat admit scan
    run over the column's heads (local index order is global order, so
    the stable sort and every rank give the global answer); then
    ``kq_gather_heads`` puts the six outputs into head order."""
    from ..ops import cycle as _cycle

    def step(*args):
        if len(args) != 14:
            raise TypeError(f"sharded_cycle_fn takes the 14 cycle_args "
                            f"planes, got {len(args)}")
        a = [_host(x) for x in args]
        layout = CycleShardLayout(a[5], a[6].shape[0], mesh.shape["cq"])
        done = []
        heads = layout.heads(a[10])
        src = layout.src
        for j, h in enumerate(heads):
            if not len(h):
                continue
            parts = []
            for i, hs in enumerate(np.array_split(h, mesh.n_wl)):
                if not len(hs):
                    continue
                cell = mesh.cell(i, j)
                with mesh.on(cell):
                    planes = layout.column(mesh, cell, j, a, hs)
                    out, ts = _cycle._phase1(planes, None, None, None, depth,
                                             run_scan, plain=False)
                parts.append((cell, planes, out + (ts,)))
            top = mesh.cell(0, j)
            with mesh.on(top):
                part_outs = [mesh.move(p[2], p[0], top) for p in parts]
                cols = [torch.cat([o[k] for o in part_outs])
                        for k in range(len(parts[0][2]))]
                fit_slot0, borrows0, preempt0 = cols[:3]
                (prio, wl), src = _put_with_src(mesh, top, layout, a[12][h],
                                                layout.local_cq(a[10], h))
                if run_scan:
                    dec_fr, dec_amt, fit_mask, ts = cols[3:]
                    planes = parts[0][1]
                    order = _cycle.cycle_order(borrows0, prio, ts)
                    no_res = torch.zeros_like(fit_mask)
                    admitted = _cycle.admit_scan(
                        *planes[:7], torch.zeros_like(planes[6]), wl, dec_fr,
                        dec_amt, fit_mask, torch.full_like(dec_fr, -1),
                        torch.zeros_like(dec_amt), no_res, no_res, order,
                        depth=depth)
                    out = _cycle._scan_outputs(admitted, fit_slot0, borrows0,
                                               preempt0)
                else:
                    zeros = torch.zeros_like(borrows0)
                    out = (zeros, torch.full_like(fit_slot0, -1), zeros,
                           preempt0, fit_slot0, borrows0)
            done.append((top, out))
        return _gather(mesh, done, (False, -1, False, False, -1, False),
                       src)[0]

    return step


# -- the two kernels of the per-cycle mesh, with their plain versions -------

def source_map(head_of, W: int) -> np.ndarray:
    """The head gather's source map [W] int32 of L maps (global head
    indices, ascending): ``src[head_of[l][r]] = l << SRC_SHIFT | r``, -1
    for a head in no map."""
    from ..kernels import SRC_SHIFT
    src = np.full(W, -1, dtype=np.int32)
    for l, h in enumerate(head_of):
        h = _host(h)
        src[h] = (l << SRC_SHIFT) | np.arange(len(h), dtype=np.int32)
    return src


def maps_of_source(src: torch.Tensor, lengths) -> tuple:
    """The L maps [W_l] int32 that ``source_map`` made ``src`` from, on
    src's device (``lengths``: W_l of each slot)."""
    from ..kernels import SRC_SHIFT
    w = torch.nonzero(src >= 0).flatten()
    slot = src[w] >> SRC_SHIFT
    row = (src[w] & ((1 << SRC_SHIFT) - 1)).long()
    maps = []
    for l, n in enumerate(lengths):
        m = torch.empty(int(n), dtype=torch.int32, device=src.device)
        sel = slot == l
        m[row[sel]] = w[sel].to(torch.int32)
        maps.append(m)
    return tuple(maps)


def gather_heads_plain(planes, head_of, W: int, fills) -> tuple:
    """``out[p][head_of[s][i]] = planes[p][s][i]``, every other row
    ``fills[p]``: the all-gather that ends each GSPMD program of the JAX
    mesh route.  planes[p] holds S blocks [W_s] of one dtype, head_of S
    int32 maps [W_s] → P tensors [W] on the maps' device."""
    dev = head_of[0].device
    out = []
    for blocks, fill in zip(planes, fills):
        o = torch.full((W,), fill, dtype=blocks[0].dtype, device=dev)
        for b, h in zip(blocks, head_of):
            o[h.long()] = b
        out.append(o)
    return tuple(out)


def gather_src_plain(planes, src, fills) -> tuple:
    """The head gather by a source map (``kernels.kq_gather_heads``'
    arguments): ``gather_heads_plain`` over the maps read back from
    ``src`` [W] int32; planes[p] holds one block per slot."""
    maps = maps_of_source(src, [b.shape[0] for b in planes[0]])
    return gather_heads_plain(planes, maps, src.shape[0], fills)


def gather_heads(planes, src, fills) -> tuple:
    """The head gather: ``kernels.kq_gather_heads`` for CUDA tensors (one
    launch for all planes), ``gather_src_plain`` for CPU tensors."""
    if src.device.type == "cuda":
        from .. import kernels
        return kernels.kq_gather_heads(planes, src, fills)
    if src.device.type != "cpu":
        raise ValueError(f"no gather kernel for device {src.device}")
    return gather_src_plain(planes, src, fills)


def fs_merge_order_plain(winners, head_of, W: int) -> torch.Tensor:
    """The global fair-sharing winner sequence [W] int32 from the shards'
    sequences: ``winners[s]`` [W_s] local ids into shard s's ascending
    head list ``head_of[s]`` (-1 past its last round).  Each reference
    round serves the forest of the lowest-index remaining valid head, so
    at each step the shard whose lowest remaining head is smallest emits
    its next winner; a shard whose sequence ends serves no more; -1
    after the last winner."""
    wins = [w.tolist() for w in winners]
    heads = [h.tolist() for h in head_of]
    done = [set() for _ in heads]
    cur = [0] * len(heads)
    nxt = [0] * len(heads)
    order = [-1] * W
    r = 0
    while r < W:
        live = [s for s in range(len(heads)) if cur[s] < len(heads[s])]
        if not live:
            break
        s = min(live, key=lambda k: heads[k][cur[k]])
        n = len(heads[s])
        loc = wins[s][nxt[s]] if nxt[s] < n else -1
        if not 0 <= loc < n:
            cur[s] = n
            continue
        nxt[s] += 1
        order[r] = heads[s][loc]
        r += 1
        done[s].add(loc)
        while cur[s] < n and cur[s] in done[s]:
            cur[s] += 1
    return torch.tensor(order, dtype=torch.int32, device=head_of[0].device)


def fs_merge_order(winners, head_of, W: int) -> torch.Tensor:
    """The round merge: ``kernels.kq_fs_merge_order`` for CUDA tensors,
    ``fs_merge_order_plain`` for CPU tensors."""
    dev = head_of[0].device
    if dev.type == "cuda":
        from .. import kernels
        return kernels.kq_fs_merge_order(winners, head_of, W)
    if dev.type != "cpu":
        raise ValueError(f"no merge kernel for device {dev}")
    return fs_merge_order_plain(winners, head_of, W)
