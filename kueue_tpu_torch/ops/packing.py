"""Snapshot → packed device arrays.

The deterministic codec from a cache Snapshot + cycle heads into static-
shaped integer tensors (SURVEY §7 stage 1).  Axes:

- N: quota nodes = ClusterQueues then Cohorts (parent-pointer forest)
- F: distinct (flavor, resource) pairs appearing in any quota
- W: cycle heads, padded to a bucket size (power of two) to bound
  recompilation
- S: flavor slots per resource group (max flavor-list length)
- R: distinct resource names

The codec is split in two so the per-cycle cost is O(usage + heads), not
O(cluster):

- ``PackedStructure`` — everything derived from specs (quota tensors,
  flavor slots, the cohort forest, int32 scaling).  Rebuilt only when the
  cache's structure generation changes (a CQ/cohort/flavor apply), and
  cached by the solver across cycles.
- ``pack_cycle`` — fills the per-cycle usage [N, F] and workload [W, R]
  tensors against a cached structure.

Quantities are canonical integers scaled per-resource so that everything
fits int32 (TPU-native); per-cycle values that don't divide the cached
scale mark the pack inexact and the solver defers to the host (int64
milli-quanta on TPU is hard part (e) in SURVEY §7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..cache.snapshot import Snapshot
from ..cache.state import CohortState, CQState
from ..resources import FlavorResource
from ..workload import Info

INT_INF = np.int64(2**62)  # "no limit" sentinel before scaling
I32_MAX = 2**31 - 1
_LIMIT = I32_MAX // 64     # ×64 headroom for sums across the tree


@dataclass
class PackedStructure:
    """Static cluster structure: valid while the cache structure
    generation is unchanged (no CQ/cohort/flavor spec edits)."""
    generation: int
    cq_names: list[str]
    cohort_names: list[str]
    node_count: int                      # N = len(cq_names) + cohorts
    parent: np.ndarray                   # [N] int32, -1 for roots
    depth: int
    fr_index: dict[FlavorResource, int]  # (flavor, resource) -> F
    resource_names: list[str]            # R axis
    r_index: dict[str, int]
    resource_scale: np.ndarray           # [R] int64 divisor per resource
    scale_is_one: bool
    exact_static: bool                   # static tensors scaled losslessly

    subtree_quota: np.ndarray            # [N, F] int32 (scaled)
    guaranteed: np.ndarray               # [N, F] int32
    borrow_cap: np.ndarray               # [N, F] int32
    has_borrow_limit: np.ndarray         # [N, F] bool
    nominal_cq: np.ndarray               # [C, F] int32
    nominal_plus_blimit_cq: np.ndarray   # [C, F] int32 (INT "inf" when unlimited)
    slot_fr: np.ndarray                  # [C, S, R] int32 F-index or -1
    slot_valid: np.ndarray               # [C, S] bool
    slot_count_cq: np.ndarray            # [C] int32: len(rg.flavors)
    cq_can_preempt_borrow: np.ndarray    # [C] bool
    cq_wcb_borrow: np.ndarray            # [C] bool: whenCanBorrow == Borrow
    cq_wcp_preempt: np.ndarray           # [C] bool: whenCanPreempt == Preempt
    fair_weight_milli: np.ndarray        # [N] int32
    forest_of_node: np.ndarray           # [N] int32
    n_forests: int
    cq_index: dict[str, int] = field(default_factory=dict)
    cq_covers_pods: set = field(default_factory=set)


@dataclass
class PackedCycle:
    """A cycle = structure + per-cycle usage and workload tensors."""
    structure: PackedStructure

    usage0: np.ndarray                   # [N, F] int32: usage at snapshot time
    wl_count: int                        # true number of heads (<= W)
    wl_cq: np.ndarray                    # [W] int32 CQ index (-1 pad)
    wl_requests: np.ndarray              # [W, R] int32 total requests (scaled)
    wl_priority: np.ndarray              # [W] int32
    wl_timestamp: np.ndarray             # [W] float64 queue-order timestamp
    wl_keys: list[str] = field(default_factory=list)
    exact: bool = True                   # scaled comparisons are lossless

    # --- structure passthroughs (stable codec surface) ---
    @property
    def cq_names(self): return self.structure.cq_names
    @property
    def node_count(self): return self.structure.node_count
    @property
    def parent(self): return self.structure.parent
    @property
    def depth(self): return self.structure.depth
    @property
    def fr_index(self): return self.structure.fr_index
    @property
    def resource_names(self): return self.structure.resource_names
    @property
    def resource_scale(self): return self.structure.resource_scale
    @property
    def subtree_quota(self): return self.structure.subtree_quota
    @property
    def guaranteed(self): return self.structure.guaranteed
    @property
    def borrow_cap(self): return self.structure.borrow_cap
    @property
    def has_borrow_limit(self): return self.structure.has_borrow_limit
    @property
    def nominal_cq(self): return self.structure.nominal_cq
    @property
    def slot_fr(self): return self.structure.slot_fr
    @property
    def slot_valid(self): return self.structure.slot_valid
    @property
    def cq_can_preempt_borrow(self): return self.structure.cq_can_preempt_borrow
    @property
    def cq_wcb_borrow(self): return self.structure.cq_wcb_borrow
    @property
    def cq_wcp_preempt(self): return self.structure.cq_wcp_preempt
    @property
    def fair_weight_milli(self): return self.structure.fair_weight_milli
    @property
    def forest_of_node(self): return self.structure.forest_of_node
    @property
    def n_forests(self): return self.structure.n_forests


def _bucket(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(1, n))))


def scatter_pad(n: int, minimum: int = 8) -> int:
    """Padded row count for a dirty-row scatter onto device-resident
    state: every distinct update size is an XLA compilation, so the
    count is bucketed to powers of two and the tail padded with
    repeated last-row writes (idempotent — same index, same value)."""
    return _bucket(n, minimum=minimum)


def scaled_usage_row(st: PackedStructure, cq_live) -> Optional[np.ndarray]:
    """One CQ's live usage scaled onto the packed flavor-resource axis:
    [F] int32, or None when not exactly representable (unknown
    flavor-resource, a remainder under the scale, or int32 overflow) —
    any None fails the whole burst pack, matching the host path."""
    F = max(1, len(st.fr_index))
    row = np.zeros(F, dtype=np.int32)
    scale = st.resource_scale
    for fr, v in cq_live.resource_node.usage.items():
        fi = st.fr_index.get(fr)
        if fi is None:
            return None
        if st.scale_is_one:
            q_ = int(v)
        else:
            s = int(scale[st.r_index[fr.resource]])
            q_, rem = divmod(int(v), s)
            if rem:
                return None
        if q_ > I32_MAX:
            return None
        row[fi] = q_
    return row


def coarse_bucket(n: int, ladder: tuple[int, ...]) -> int:
    """Smallest ladder rung >= n (last rung if none).  Coarse ladders
    keep the number of DISTINCT compiled shapes small — each new shape
    is a full XLA compilation (~1s on this CPU) that would otherwise
    land inside a scheduling cycle."""
    for rung in ladder:
        if n <= rung:
            return rung
    return ladder[-1]


def _iter_nodes(snapshot: Snapshot):
    """CQs first, then cohorts (stable order)."""
    cq_names = sorted(snapshot.cluster_queues)
    cohorts: list[CohortState] = []
    seen = set()

    def walk(c: CohortState):
        if id(c) in seen:
            return
        seen.add(id(c))
        cohorts.append(c)
        for ch in c.child_cohorts:
            walk(ch)

    for root in snapshot.roots:
        walk(root)
    # cohorts reachable only via CQ parents (defensive)
    for name in cq_names:
        c = snapshot.cluster_queues[name].parent
        while c is not None and id(c) not in seen:
            walk(c)
            c = c.parent
    return cq_names, cohorts


def snapshot_fair_sharing(snapshot: Snapshot) -> bool:
    return bool(getattr(snapshot, "fair_sharing_enabled", False))


def _snapshot_nodes(snapshot: Snapshot, structure: PackedStructure):
    """Resolve the structure's node order against a fresh snapshot, or
    None if the topology changed under us (caller rebuilds)."""
    by_name: dict[str, CohortState] = {}

    def walk(c: CohortState):
        by_name[c.name] = c
        for ch in c.child_cohorts:
            walk(ch)

    for root in snapshot.roots:
        walk(root)
    nodes = []
    for name in structure.cq_names:
        cq = snapshot.cluster_queues.get(name)
        if cq is None:
            return None
        nodes.append(cq)
    for name in structure.cohort_names:
        c = by_name.get(name)
        if c is None:
            return None
        nodes.append(c)
    return nodes


def _choose_scale(max_val: int, gcd_val: int) -> tuple[int, bool]:
    """Pick a per-resource divisor so max_val/scale fits int32 with
    headroom.  Prefer a scale dividing every observed static value (exact);
    fall back to a power of two marked inexact (hard part (e))."""
    if max_val <= _LIMIT:
        return 1, True
    need = -(-max_val // _LIMIT)          # ceil
    p2 = 1
    while p2 < need:
        p2 *= 2
    cand = math.gcd(int(gcd_val), p2 * (1 << 20))  # pow2 component of gcd
    if cand >= need and max_val // cand <= _LIMIT:
        return cand, True
    if gcd_val >= need and max_val // gcd_val <= _LIMIT:
        return int(gcd_val), True
    scale = p2
    while max_val // scale > _LIMIT:
        scale *= 2
    return scale, gcd_val % scale == 0


def pack_structure(snapshot: Snapshot, heads: list[Info] = (),
                   generation: int = -1) -> PackedStructure:
    """Build the static structure tensors from a snapshot.  ``heads``
    (optional) contributes request quantities to the scale choice so a
    one-shot pack stays exact."""
    cq_names, cohorts = _iter_nodes(snapshot)
    cohort_names = [c.name for c in cohorts]
    cq_idx = {n: i for i, n in enumerate(cq_names)}
    C = len(cq_names)
    N = C + len(cohorts)

    nodes: list = [snapshot.cluster_queues[n] for n in cq_names] + cohorts

    # F axis: quota frs ∪ current usage frs
    frs: set[FlavorResource] = set()
    for node in nodes:
        frs.update(node.resource_node.quotas)
        frs.update(node.resource_node.usage)
    fr_list = sorted(frs)
    fr_index = {fr: i for i, fr in enumerate(fr_list)}
    F = max(1, len(fr_list))

    cq_covers_pods = {
        name for name in cq_names
        if any("pods" in rg.covered_resources
               for rg in snapshot.cluster_queues[name].spec.resource_groups)}

    resource_names = sorted({fr.resource for fr in fr_list}
                            | {r for h in heads for psr in h.total_requests
                               for r in psr.requests}
                            | ({"pods"} if cq_covers_pods else set()))
    r_index = {r: i for i, r in enumerate(resource_names)}
    R = max(1, len(resource_names))

    # resource scaling to int32
    max_per_resource = np.zeros(R, dtype=np.int64)
    gcd_per_resource = np.zeros(R, dtype=np.int64)

    def note(r: str, v: int):
        if r in r_index and v < INT_INF:
            i = r_index[r]
            av = abs(int(v))
            max_per_resource[i] = max(max_per_resource[i], av)
            gcd_per_resource[i] = math.gcd(int(gcd_per_resource[i]), av)

    for node in nodes:
        for fr, q in node.resource_node.quotas.items():
            note(fr.resource, q.nominal)
            if q.borrowing_limit is not None:
                note(fr.resource, q.borrowing_limit)
        for fr, v in node.resource_node.subtree_quota.items():
            note(fr.resource, v)
        for fr, v in node.resource_node.usage.items():
            note(fr.resource, v)
    for h in heads:
        for psr in h.total_requests:
            for r, v in psr.requests.items():
                note(r, v)

    scale = np.ones(R, dtype=np.int64)
    exact_static = True
    for i in range(R):
        s, ok = _choose_scale(int(max_per_resource[i]),
                              int(gcd_per_resource[i]))
        scale[i] = s
        exact_static = exact_static and ok
    scale_is_one = bool((scale == 1).all())

    def scaled(r: str, v) -> int:
        if v >= INT_INF:
            return int(_LIMIT)
        s = int(scale[r_index[r]])
        return int(v) // s if v >= 0 else -((-int(v)) // s)

    # node tensors
    subtree = np.zeros((N, F), dtype=np.int32)
    guaranteed = np.zeros((N, F), dtype=np.int32)
    borrow_cap = np.full((N, F), int(_LIMIT), dtype=np.int32)
    has_blim = np.zeros((N, F), dtype=bool)
    parent = np.full(N, -1, dtype=np.int32)
    nominal_cq = np.zeros((C, F), dtype=np.int32)
    nominal_plus_blimit = np.full((C, F), int(_LIMIT), dtype=np.int32)
    fair_weight = np.full(N, 1000, dtype=np.int32)

    cohort_idx = {id(c): C + i for i, c in enumerate(cohorts)}
    for ni, node in enumerate(nodes):
        p = node.parent
        parent[ni] = cohort_idx[id(p)] if p is not None else -1
        fair_weight[ni] = getattr(node, "fair_weight_milli", 1000)
        rn = node.resource_node
        for fr, fi in fr_index.items():
            sq = rn.subtree_quota.get(fr, 0)
            subtree[ni, fi] = scaled(fr.resource, sq)
            guaranteed[ni, fi] = scaled(fr.resource, rn.guaranteed_quota(fr))
            q = rn.quotas.get(fr)
            if ni < C and q is not None:
                nominal_cq[ni, fi] = scaled(fr.resource, q.nominal)
                if q.borrowing_limit is not None:
                    nominal_plus_blimit[ni, fi] = scaled(
                        fr.resource, q.nominal + q.borrowing_limit)
            if q is not None and q.borrowing_limit is not None:
                has_blim[ni, fi] = True
                stored = sq - rn.guaranteed_quota(fr)
                borrow_cap[ni, fi] = scaled(fr.resource,
                                            stored + q.borrowing_limit)

    # depth + forest partition (each parent-pointer root is independent)
    depth = 1
    forest_of_node = np.zeros(N, dtype=np.int32)
    root_forest: dict[int, int] = {}
    for ni in range(N):
        d, p, cur = 1, parent[ni], ni
        while p >= 0:
            d += 1
            cur = p
            p = parent[p]
        depth = max(depth, d)
        forest_of_node[ni] = root_forest.setdefault(cur, len(root_forest))
    n_forests = max(1, len(root_forest))

    # flavor slots per CQ
    S = 1
    for name in cq_names:
        for rg in snapshot.cluster_queues[name].spec.resource_groups:
            S = max(S, len(rg.flavors))
    slot_fr = np.full((C, S, R), -1, dtype=np.int32)
    slot_valid = np.zeros((C, S), dtype=bool)
    slot_count = np.zeros(C, dtype=np.int32)
    cq_can_preempt_borrow = np.zeros(C, dtype=bool)
    cq_wcb_borrow = np.zeros(C, dtype=bool)
    cq_wcp_preempt = np.zeros(C, dtype=bool)
    from ..api.types import (BorrowWithinCohortPolicy,
                             FlavorFungibilityPolicy, ReclaimWithinCohort)
    for ci, name in enumerate(cq_names):
        spec = snapshot.cluster_queues[name].spec
        p = spec.preemption
        cq_can_preempt_borrow[ci] = (
            p.borrow_within_cohort.policy != BorrowWithinCohortPolicy.NEVER
            or (snapshot_fair_sharing(snapshot)
                and p.reclaim_within_cohort != ReclaimWithinCohort.NEVER))
        ff = spec.flavor_fungibility
        cq_wcb_borrow[ci] = (
            ff.when_can_borrow == FlavorFungibilityPolicy.BORROW)
        cq_wcp_preempt[ci] = (
            ff.when_can_preempt == FlavorFungibilityPolicy.PREEMPT)
    for ci, name in enumerate(cq_names):
        cq = snapshot.cluster_queues[name]
        for rg in cq.spec.resource_groups:
            slot_count[ci] = max(slot_count[ci], len(rg.flavors))
            for si, fq in enumerate(rg.flavors):
                exists = fq.name in snapshot.resource_flavors
                slot_valid[ci, si] = slot_valid[ci, si] or exists
                for rname in rg.covered_resources:
                    if rname in r_index:
                        fr = FlavorResource(fq.name, rname)
                        if fr in fr_index and exists:
                            slot_fr[ci, si, r_index[rname]] = fr_index[fr]

    return PackedStructure(
        generation=generation, cq_names=cq_names, cohort_names=cohort_names,
        node_count=N, parent=parent, depth=depth, fr_index=fr_index,
        resource_names=resource_names, r_index=r_index,
        resource_scale=scale, scale_is_one=scale_is_one,
        exact_static=exact_static,
        subtree_quota=subtree, guaranteed=guaranteed, borrow_cap=borrow_cap,
        has_borrow_limit=has_blim, nominal_cq=nominal_cq,
        nominal_plus_blimit_cq=nominal_plus_blimit,
        slot_fr=slot_fr, slot_valid=slot_valid, slot_count_cq=slot_count,
        cq_can_preempt_borrow=cq_can_preempt_borrow,
        cq_wcb_borrow=cq_wcb_borrow, cq_wcp_preempt=cq_wcp_preempt,
        fair_weight_milli=fair_weight, forest_of_node=forest_of_node,
        n_forests=n_forests, cq_index=cq_idx, cq_covers_pods=cq_covers_pods,
    )


def pack_cycle(snapshot: Snapshot, heads: list[Info], ordering=None,
               structure: Optional[PackedStructure] = None
               ) -> Optional[PackedCycle]:
    """Fill the per-cycle tensors.  With a cached ``structure`` this is
    O(usage entries + heads); without one the structure is built fresh
    (one-shot codec, used by tests/probes).

    Returns None when the cached structure no longer describes the
    snapshot (new flavor-resource or node appeared) — the caller rebuilds
    and retries."""
    fresh = structure is None
    if fresh:
        structure = pack_structure(snapshot, heads)
    st = structure
    nodes = _snapshot_nodes(snapshot, st)
    if nodes is None:
        return None

    N, F = st.node_count, max(1, len(st.fr_index))
    R = len(st.resource_names)
    scale = st.resource_scale
    exact = st.exact_static

    usage0 = np.zeros((N, F), dtype=np.int32)
    if st.scale_is_one:
        for ni, node in enumerate(nodes):
            for fr, v in node.resource_node.usage.items():
                fi = st.fr_index.get(fr)
                if fi is None:
                    return None
                usage0[ni, fi] = v
    else:
        for ni, node in enumerate(nodes):
            for fr, v in node.resource_node.usage.items():
                fi = st.fr_index.get(fr)
                if fi is None:
                    return None
                s = int(scale[st.r_index[fr.resource]])
                q, rem = divmod(int(v), s)
                if rem:
                    exact = False
                    q += 1  # conservative ceil
                usage0[ni, fi] = q

    W = _bucket(len(heads))
    wl_cq = np.full(W, -1, dtype=np.int32)
    # accumulate in int64: a cached structure's scale was chosen without
    # this cycle's requests, so scaled sums may exceed int32 — that marks
    # the pack inexact (host fallback) instead of wrapping
    wl_requests64 = np.zeros((W, R), dtype=np.int64)
    wl_priority = np.zeros(W, dtype=np.int32)
    wl_timestamp = np.zeros(W, dtype=np.float64)
    wl_keys = []
    for wi, h in enumerate(heads):
        wl_keys.append(h.key)
        wl_cq[wi] = st.cq_index.get(h.cluster_queue, -1)
        covers_pods = h.cluster_queue in st.cq_covers_pods
        for psr in h.total_requests:
            for r, v in psr.requests.items():
                # the implicit "pods" request only participates when the
                # head's CQ covers it (flavorassigner.go:226)
                if r == "pods" and not covers_pods:
                    continue
                ri = st.r_index.get(r)
                if ri is None:
                    return None
                if st.scale_is_one:
                    wl_requests64[wi, ri] += int(v)
                else:
                    s = int(scale[ri])
                    q, rem = divmod(int(v), s)
                    if rem:
                        exact = False
                        q += 1
                    wl_requests64[wi, ri] += q
        wl_priority[wi] = h.obj.priority
        wl_timestamp[wi] = (ordering.queue_order_timestamp(h.obj)
                            if ordering is not None else h.obj.creation_time)
    if wl_requests64.max(initial=0) > _LIMIT:
        exact = False
        np.clip(wl_requests64, None, _LIMIT, out=wl_requests64)
    wl_requests = wl_requests64.astype(np.int32)

    return PackedCycle(
        structure=st, usage0=usage0,
        wl_count=len(heads), wl_cq=wl_cq, wl_requests=wl_requests,
        wl_priority=wl_priority, wl_timestamp=wl_timestamp, wl_keys=wl_keys,
        exact=exact,
    )


# ---------------------------------------------------------------------------
# Dtype tightening of packed planes (host→device transfer compression)
# ---------------------------------------------------------------------------

# Planes the serial burst launch may narrow below int32 when their value
# range permits.  Only *rank/index/request* planes qualify: sentinel
# planes (wl_rank's INF_I32, death0's I32_MAX) and the chained scan-state
# 9-tuple are excluded — a chained window receives the previous window's
# device outputs, so alternating their dtypes would recompile every
# boundary.  Quota planes holding _LIMIT-scaled sums stay int32 too.
TIGHTEN_PLANES = ("wl_req", "wl_cycle_rank", "wl_prio", "wl_uidrank",
                  "parent", "node_level", "nominal_cq", "slot_fr",
                  "forest_of_cq", "members", "cand_rows", "cand_lmem",
                  "self_lmem")

_WIDTH_DT = {1: np.int8, 2: np.int16, 4: np.int32}


class TightenState:
    """Sticky per-plane narrow widths.  Widths only ever widen: a plane
    that once overflowed int16 stays int32 for the solver's lifetime,
    so the jit cache sees at most a couple of dtype signatures per
    plane instead of oscillating (every signature is a compilation)."""
    __slots__ = ("width", "widen_events")

    def __init__(self):
        self.width: dict[str, int] = {}
        self.widen_events = 0


def _needed_width(arr: np.ndarray) -> int:
    if arr.size == 0:
        return 1
    lo, hi = int(arr.min()), int(arr.max())
    if -128 <= lo and hi <= 127:
        return 1
    if -32768 <= lo and hi <= 32767:
        return 2
    return 4


def tighten_arrays(arrays: dict, state: TightenState,
                   stats: dict = None) -> dict:
    """Return a shallow copy of ``arrays`` with the TIGHTEN_PLANES
    narrowed to the smallest sticky width their values fit (range
    measured per call — the assert is the measurement; overflow never
    truncates, it widens).  The input dict is never mutated: plan
    arrays keep their reference int32 dtypes for parity checks and the
    resident scatter path."""
    out = dict(arrays)
    saved = 0
    for name in TIGHTEN_PLANES:
        a = out.get(name)
        if a is None or a.dtype != np.int32:
            continue
        need = _needed_width(a)
        prev = state.width.get(name)
        if prev is not None and need > prev:
            state.widen_events += 1
            if stats is not None:
                stats["pack_tighten_widened"] = (
                    stats.get("pack_tighten_widened", 0) + 1)
        width = max(need, prev or 1)
        state.width[name] = width
        if width < 4:
            out[name] = a.astype(_WIDTH_DT[width])
            saved += a.nbytes - out[name].nbytes
    if stats is not None and saved:
        stats["pack_tighten_bytes_saved"] = (
            stats.get("pack_tighten_bytes_saved", 0) + saved)
    return out


# ----------------------------------------------------------------------
# Carry-over into the PyTorch port
# ----------------------------------------------------------------------

def planes_to_torch(packed_or_arrays, device) -> dict:
    """Packed planes → ``{name: torch.Tensor}`` on ``device``, same dtypes.

    Takes a ``PackedStructure``, a ``PackedCycle`` (its per-cycle arrays
    plus its structure's) or a dict of arrays, from this package or from
    the JAX package's packer (the same dataclass layout), so both compute
    on identical inputs.  Non-array fields are skipped; every array keeps
    its numpy dtype (int32 stays int32, bool stays bool)."""
    import dataclasses

    import torch

    if isinstance(packed_or_arrays, dict):
        items = dict(packed_or_arrays)
    else:
        items = {}
        st = getattr(packed_or_arrays, "structure", None)
        if st is not None:
            items.update((f.name, getattr(st, f.name))
                         for f in dataclasses.fields(st))
        items.update((f.name, getattr(packed_or_arrays, f.name))
                     for f in dataclasses.fields(packed_or_arrays))
    out = {}
    for name, v in items.items():
        if not hasattr(v, "__array__"):
            continue
        a = np.ascontiguousarray(v)
        if a.dtype != object:
            out[name] = torch.from_numpy(a.copy()).to(device)
    return out


def plan_to_torch(plan_or_arrays, device) -> dict:
    """A burst plan's arrays → ``{name: torch.Tensor}`` on ``device``,
    same dtypes: the tensors ``ops.burst.burst_cycles`` takes.

    Takes a ``BurstPlan`` (its ``arrays``) or a dict of arrays, from this
    package's packer or from the JAX package's (the same plan layout), so
    both packages' kernels compute on identical inputs."""
    arrays = getattr(plan_or_arrays, "arrays", plan_or_arrays)
    return planes_to_torch(dict(arrays), device)


def scatter_layout(planes, count: int) -> tuple[list[int], list[int], int]:
    """The packed buffer of a resident row scatter of ``count`` rows
    into ``planes`` (numpy arrays or tensors [n, ...]; a plane's values
    [count, ...] lay out alike): the rows as int32 [count] at byte 0,
    then each plane's ``count`` value rows, every segment at a 16-byte
    boundary → (each plane's segment offset, its bytes a row, the
    buffer's bytes)."""
    offsets, row_bytes, n = [], [], -(-4 * count // 16) * 16
    for p in planes:
        rb = math.prod(p.shape[1:]) * p.itemsize
        offsets.append(n)
        row_bytes.append(rb)
        n += -(-rb * count // 16) * 16
    return offsets, row_bytes, max(n, 16)


def pack_scatter_rows(rows: np.ndarray, vals, out=None) -> np.ndarray:
    """Rows int32 [count] and each plane's value rows [count, ...] packed
    into one uint8 buffer as ``scatter_layout`` lays it out (``out``: a
    uint8 array of at least its bytes to fill, say a pinned tensor's
    numpy view) → the buffer; the padding between segments is zero."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    vals = [np.ascontiguousarray(v) for v in vals]
    count = rows.shape[0]
    offsets, _, n = scatter_layout(vals, count)
    buf = np.zeros(n, dtype=np.uint8) if out is None else out[:n]
    if out is not None:
        buf[:] = 0
    buf[:rows.nbytes] = rows.view(np.uint8)
    for v, o in zip(vals, offsets):
        buf[o:o + v.nbytes] = v.reshape(-1).view(np.uint8)
    return buf
