"""The forest-sharded fused burst, and the cycle arguments of the one-call
solver: the port of the JAX package's ``parallel/sharded.py``
``cycle_args`` (:51-57), ``make_burst_mesh`` (:204-213), the fill tables
(:216-265), ``BurstShardLayout`` (:266-485) and ``sharded_burst_fn``
(:487-511).

A burst mesh is an ordered list of torch devices on one 1-D axis named
``cq``.  One process drives all of it: the JAX reference is
single-controller (one ``BurstSolver`` dispatches the shard_map program
across the whole mesh), so the port launches each shard's block on its
own device, on that shard's own CUDA stream, from the same host thread,
and reduces the [K, 4] dirty flags on shard 0's device.  A real mesh is
``cuda:0 .. cuda:n-1``.  A virtual mesh repeats one device n times: the
counterpart of the JAX tests' 8 virtual XLA CPU devices.  Only
``virtual_mesh`` turns it on, and nothing in the package does: tests
and ``chip_smoke.py`` do.

The per-cycle mesh programs of the JAX module (``make_mesh``,
``sharded_cycle_fn``, ``admit_scan_fns``, ``fs_scan_fn``,
``make_hybrid_mesh``) are not ported yet (ROADMAP Queue 1 item 9, the
next slice)."""

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
# The burst mesh
# ---------------------------------------------------------------------------

_VIRTUAL = None     # (device, count) while a virtual mesh is on


@contextlib.contextmanager
def virtual_mesh(device, count: int = 8):
    """Within the block, ``make_burst_mesh`` builds its meshes from
    ``count`` copies of ``device`` (e.g. "cpu" in the CPU tests,
    "cuda:0" on one card) instead of the machine's CUDA devices."""
    global _VIRTUAL
    prev = _VIRTUAL
    _VIRTUAL = (torch.device(device), int(count))
    try:
        yield
    finally:
        _VIRTUAL = prev


@dataclass
class BurstMesh:
    """A 1-D mesh on the axis ``cq``: shard s runs on ``devices[s]`` and,
    on CUDA, on its own stream ``streams[s]``."""
    devices: tuple
    axis_names: tuple = ("cq",)
    streams: list = field(default_factory=list)

    def __post_init__(self):
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, s: int):
        """Shard s's device and stream as the current ones."""
        st = self.streams[s]
        if st is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.devices[s]))
        stack.enter_context(torch.cuda.stream(st))
        return stack

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

    def fetch(self, s: int, t: torch.Tensor) -> np.ndarray:
        with self.on(s):
            return t.cpu().numpy()

    def synchronize(self, s: int) -> None:
        if self.streams[s] is not None:
            self.streams[s].synchronize()


def make_burst_mesh(n_devices: int, device="cuda"):
    """A 1-D ``("cq",)`` mesh for the forest-partitioned burst kernel,
    or None when ``n_devices < 2`` or fewer devices exist (the caller
    degrades to the serial path).  The devices are the virtual mesh's
    when one is on, else ``cuda:0 .. cuda:n-1`` for a CUDA ``device``;
    the CPU is one device."""
    if n_devices is None or n_devices < 2:
        return None
    if _VIRTUAL is not None:
        devices = [_VIRTUAL[0]] * _VIRTUAL[1]
    elif torch.device(device).type == "cuda" and torch.cuda.is_available():
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(device)]
    if len(devices) < n_devices:
        return None
    return BurstMesh(tuple(devices[:n_devices]))


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
        N = parent.shape[0]
        forest_of_node = np.asarray(st.forest_of_node)

        # greedy LPT: big forests first onto the least-loaded shard.
        # "Big" is CQ count by default; with a measured per-forest cycle
        # cost (EWMA of decided heads per window) the cost is the load,
        # with a small size term so never-fired forests still spread.
        counts = np.bincount(forest_of_cq, minlength=G)
        if forest_cost is not None and len(forest_cost) == G:
            weight = (np.asarray(forest_cost, dtype=np.float64)
                      + 1e-6 * counts)
            self.cost_balanced = True
        else:
            weight = counts.astype(np.float64)
            self.cost_balanced = False
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
        shard_of_forest = np.zeros(max(G, 1), dtype=np.int32)
        local_forest = np.zeros(max(G, 1), dtype=np.int32)
        for s, fl in enumerate(forests_of):
            for j, g in enumerate(fl):
                shard_of_forest[g] = s
                local_forest[g] = j

        cqs_of: list[list[int]] = [[] for _ in range(S)]
        for s, fl in enumerate(forests_of):
            for g in fl:
                for cq in members[g]:
                    if cq >= 0:
                        cqs_of[s].append(int(cq))
        cohorts_of: list[list[int]] = [[] for _ in range(S)]
        for nd in range(C, N):
            f = int(forest_of_node[nd])
            s = int(shard_of_forest[f]) if 0 <= f < G else 0
            cohorts_of[s].append(nd)

        Cs = max(1, max(len(x) for x in cqs_of))
        Gs = max(1, max(len(x) for x in forests_of))
        Hs = max(len(x) for x in cohorts_of)
        self.Cs, self.Gs, self.Ns = Cs, Gs, Cs + Hs
        Ns = self.Ns

        cq_perm = np.full((S, Cs), -1, dtype=np.int32)
        cq_pos = np.zeros(C, dtype=np.int64)
        local_cq = np.zeros(C, dtype=np.int32)
        for s, cqs in enumerate(cqs_of):
            for j, cq in enumerate(cqs):
                cq_perm[s, j] = cq
                cq_pos[cq] = s * Cs + j
                local_cq[cq] = j
        node_perm = np.full((S, Ns), -1, dtype=np.int32)
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
        self.cq_perm = cq_perm
        self.cq_pos = cq_pos
        self.node_perm = node_perm
        self.forest_perm = forest_perm

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

def scatter_rows_plain(planes, rows, vals):
    """``plane[rows[i]] = vals[i]`` for every plane, in place; returns
    the planes as a tuple (kueue_tpu/ops/burst.py ``_scatter_rows_fn``,
    whose ``a.at[rows].set(v)`` returns new arrays with the same
    values)."""
    idx = rows.long()
    for p, v in zip(planes, vals):
        p[idx] = v
    return tuple(planes)


def scatter_rows(planes, rows, vals):
    """The resident row scatter: ``kernels.kq_scatter_rows`` for CUDA
    tensors (one launch for all planes), ``scatter_rows_plain`` for CPU
    tensors; raises for any other device."""
    if rows.device.type == "cuda":
        from .. import kernels
        return kernels.kq_scatter_rows(planes, rows, vals)
    if rows.device.type != "cpu":
        raise ValueError(f"no scatter kernel for device {rows.device}")
    return scatter_rows_plain(planes, rows, vals)


def reduce_dflags_plain(blocks):
    """The sum of S [K, 4] int32 dirty-flag blocks, [K, 4] int32 (the
    ``psum`` at kueue_tpu/ops/burst.py:789-790)."""
    return torch.stack(tuple(blocks)).sum(0, dtype=torch.int32)


def reduce_dflags(blocks):
    """The cross-shard dirty-flag reduction: ``kernels.kq_reduce_dflags``
    for CUDA tensors, ``reduce_dflags_plain`` for CPU tensors."""
    blocks = tuple(blocks)
    if blocks[0].device.type == "cuda":
        from .. import kernels
        return kernels.kq_reduce_dflags(blocks)
    if blocks[0].device.type != "cpu":
        raise ValueError(f"no reduction kernel for device "
                         f"{blocks[0].device}")
    return reduce_dflags_plain(blocks)


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
    ``seq_base`` replicated; then ``reduce_dflags`` sums the S [K, 4]
    flag blocks on shard 0's device (copied there first from another
    device; shard 0's stream waits on every shard's).

    Returns ``(outs, dirty, dirty_reason)``: ``outs[s]`` is shard s's
    ``(head_row, kind, slot, borrows, tgt_words, dflags, carry)`` on its
    device, and the flags are shard 0's."""
    from ..ops import burst as _burst
    from ..ops.burst import ARG_NAMES
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
        with mesh.on(s):
            outs.append(_burst.burst_cycles(*args, **kw))
    dev0 = mesh.devices[0]
    blocks = []
    with mesh.on(0):
        for s, out in enumerate(outs):
            blk = out[5]
            if s == 0 or mesh.streams[s] is None:
                blocks.append(blk)
            elif mesh.devices[s] == dev0:
                # a virtual mesh: another stream of the same device
                ev = torch.cuda.Event()
                ev.record(mesh.streams[s])
                mesh.streams[0].wait_event(ev)
                blk.record_stream(mesh.streams[0])
                blocks.append(blk)
            else:
                # a peer copy of 16 K bytes, issued on shard s's stream;
                # shard 0's stream waits for it
                with torch.cuda.stream(mesh.streams[s]):
                    blocks.append(blk.to(dev0))
        dflags = reduce_dflags(blocks)
        dirty, dirty_reason = _burst.dirty_flags(dflags)
    return outs, dirty, dirty_reason
