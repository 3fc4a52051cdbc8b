"""Host wrapper for the device preemption search.

Packs the snapshot + candidate list and runs
ops.preemption_kernel.minimal_preemptions(_batch) on the solver's device
(the ``device`` the CycleSolver stamped on the cached PackedStructure;
"cuda" when no solver packed it): the CUDA kernel there, the plain
PyTorch version on "cpu".  Returns the Target list in host semantics, or
None when the scenario needs the host path (inexact scaling, unknown
flavor-resources).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api.types import (
    IN_CLUSTER_QUEUE_REASON,
    IN_COHORT_RECLAIM_WHILE_BORROWING_REASON,
    IN_COHORT_RECLAMATION_REASON,
)
from .packing import pack_cycle
from .preemption_kernel import (minimal_preemptions,
                                minimal_preemptions_batch)

# shape ladders for the batched search (see coarse_bucket)
S_LADDER = (32, 256, 1024, 4096)
K_LADDER = (16, 128, 1024)


def _device_of(packed) -> torch.device:
    """The device the admission solver runs on (stamped on the cached
    structure); the card when nothing says otherwise."""
    st = getattr(packed, "structure", None)
    return torch.device(getattr(st, "device", None) or "cuda")


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _fetch(*tensors):
    return [t.cpu().numpy() for t in tensors]


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class _ForestPlanes:
    """Per-forest compact quota planes, cached per PackedStructure.

    Each cohort forest's nodes are remapped to a dense local index space
    (bucketed to NL) so a preemption search carries [NL, F] instead of
    the whole [N, F] cluster."""

    def __init__(self, st):
        forest = np.asarray(st.forest_of_node)
        N, F = st.subtree_quota.shape
        per_forest: list[list[int]] = [[] for _ in range(st.n_forests)]
        for ni in range(N):
            per_forest[int(forest[ni])].append(ni)
        self.NL = _bucket(max(1, max(len(v) for v in per_forest)),
                          minimum=4)
        G = st.n_forests
        self.glob_idx = np.full((G, self.NL), -1, dtype=np.int32)
        self.parent = np.full((G, self.NL), -1, dtype=np.int32)
        self.subtree = np.zeros((G, self.NL, F), dtype=np.int32)
        self.guaranteed = np.zeros((G, self.NL, F), dtype=np.int32)
        self.borrow_cap = np.full((G, self.NL, F), 2**30, dtype=np.int32)
        self.has_blim = np.zeros((G, self.NL, F), dtype=bool)
        self.local: dict[int, tuple[int, int]] = {}   # global → (f, local)
        for f, nodes in enumerate(per_forest):
            if len(nodes) > self.NL:
                raise ValueError("forest exceeds bucket")
            loc = {g: i for i, g in enumerate(nodes)}
            for i, g in enumerate(nodes):
                self.glob_idx[f, i] = g
                p = int(st.parent[g])
                self.parent[f, i] = loc.get(p, -1) if p >= 0 else -1
                self.subtree[f, i] = st.subtree_quota[g]
                self.guaranteed[f, i] = st.guaranteed[g]
                self.borrow_cap[f, i] = st.borrow_cap[g]
                self.has_blim[f, i] = st.has_borrow_limit[g]
                self.local[g] = (f, i)

    def usage_planes(self, usage0: np.ndarray) -> np.ndarray:
        """[G, NL, F] usage slices from the cycle's [N, F] usage."""
        safe = np.maximum(self.glob_idx, 0)
        return usage0[safe] * (self.glob_idx >= 0)[:, :, None]


def _planes_for(packed) -> Optional[_ForestPlanes]:
    st = getattr(packed, "structure", None)
    if st is None:
        return None
    planes = getattr(st, "_preempt_planes", None)
    if planes is None:
        try:
            planes = _ForestPlanes(st)
        except ValueError:
            return None
        st._preempt_planes = planes
    return planes


def device_minimal_preemptions_batch(specs, packed):
    """ALL of a cycle's preemption searches in one vmapped dispatch,
    each over its preemptor's forest-local quota plane.

    ``specs``: [(ctx, candidates, allow_borrowing, threshold)] — the
    per-head search requests the preemptor planned (every search is
    against the same nominate-time snapshot, so they are independent).
    Returns a list of per-spec Target lists ([] = search failed), or
    None when any spec can't be packed (caller runs the host path)."""
    from ..scheduler.preemption import Target  # circular-safe import

    if packed is None or not packed.exact or not specs:
        return None
    planes = _planes_for(packed)
    if planes is None:
        return None
    cq_idx = {n: i for i, n in enumerate(packed.cq_names)}
    F = packed.usage0.shape[1]
    scale_of = {r: int(packed.resource_scale[i])
                for i, r in enumerate(packed.resource_names)}

    def to_f_vec(frq) -> Optional[np.ndarray]:
        vec = np.zeros(F, dtype=np.int64)
        for fr, v in frq.items():
            fi = packed.fr_index.get(fr)
            if fi is None:
                return None
            s = scale_of[fr.resource]
            if v % s:
                return None
            vec[fi] += v // s
        if vec.max(initial=0) > 2**31 - 1:
            return None
        return vec.astype(np.int32)

    # coarse shape ladders: each distinct (S, K) combination is one XLA
    # compilation — a handful of rungs covers every cycle, and warmup
    # pre-compiles them (CycleSolver.warmup).  Beyond the top rung the
    # host path runs (None), never an array overflow.
    from .packing import coarse_bucket
    max_cands = max(1, max(len(c) for _, c, _, _ in specs))
    if len(specs) > S_LADDER[-1] or max_cands > K_LADDER[-1]:
        return None
    S = coarse_bucket(len(specs), S_LADDER)
    K = coarse_bucket(max_cands, K_LADDER)
    NL = planes.NL
    usage_planes = planes.usage_planes(packed.usage0)     # [G, NL, F]
    forest_of = np.zeros(S, dtype=np.int32)
    pre_cq = np.full(S, -1, dtype=np.int32)
    wl_usage = np.zeros((S, F), dtype=np.int32)
    frs_mask = np.zeros((S, F), dtype=bool)
    cand_cq = np.full((S, K), -1, dtype=np.int32)
    cand_delta = np.zeros((S, K, F), dtype=np.int32)
    cand_other = np.zeros((S, K), dtype=bool)
    cand_above = np.zeros((S, K), dtype=bool)
    allow_b0 = np.zeros(S, dtype=bool)
    thr_en = np.zeros(S, dtype=bool)
    # target-usage vectors dedupe across specs (the same admitted
    # workload is a candidate for many preemptors)
    vec_cache: dict[str, Optional[np.ndarray]] = {}

    for si, (ctx, candidates, allow_borrowing, threshold) in enumerate(specs):
        ci = cq_idx.get(ctx.preemptor_cq.name)
        if ci is None or ci not in planes.local:
            return None
        f, ci_local = planes.local[ci]
        wu = to_f_vec(ctx.workload_usage)
        if wu is None:
            return None
        forest_of[si] = f
        pre_cq[si] = ci_local
        wl_usage[si] = wu
        for fr in ctx.frs_need_preemption:
            fi = packed.fr_index.get(fr)
            if fi is None:
                return None
            frs_mask[si, fi] = True
        allow_b0[si] = allow_borrowing
        thr_en[si] = threshold is not None
        for k, cand in enumerate(candidates):
            cci = cq_idx.get(cand.cluster_queue)
            if cci is None:
                return None
            cf_local = planes.local.get(cci)
            if cf_local is None or cf_local[0] != f:
                return None   # candidate outside the preemptor's forest
            delta = vec_cache.get(cand.key)
            if delta is None and cand.key not in vec_cache:
                delta = to_f_vec(cand.usage())
                vec_cache[cand.key] = delta
            if delta is None:
                return None
            cand_cq[si, k] = cf_local[1]
            cand_delta[si, k] = delta
            cand_other[si, k] = cand.cluster_queue != ctx.preemptor_cq.name
            cand_above[si, k] = (threshold is not None
                                 and cand.obj.priority >= threshold)

    device = _device_of(packed)
    fitted, mask = minimal_preemptions_batch(
        *_to(device, usage_planes[forest_of], planes.subtree[forest_of],
             planes.guaranteed[forest_of], planes.borrow_cap[forest_of],
             planes.has_blim[forest_of], planes.parent[forest_of],
             pre_cq, wl_usage, frs_mask, cand_cq, cand_delta, cand_other,
             cand_above, allow_b0, thr_en), depth=packed.depth)
    fitted, mask = _fetch(fitted, mask)

    out = []
    for si, (ctx, candidates, _, threshold) in enumerate(specs):
        if not fitted[si]:
            out.append([])
            continue
        targets = []
        for k, cand in enumerate(candidates):
            if not mask[si, k]:
                continue
            if cand.cluster_queue == ctx.preemptor_cq.name:
                reason = IN_CLUSTER_QUEUE_REASON
            elif threshold is not None and cand.obj.priority < threshold:
                reason = IN_COHORT_RECLAIM_WHILE_BORROWING_REASON
            else:
                reason = IN_COHORT_RECLAMATION_REASON
            targets.append(Target(info=cand, reason=reason))
        out.append(targets)
    return out


def device_minimal_preemptions(ctx, candidates, allow_borrowing: bool,
                               threshold: Optional[int], packed=None):
    """Device twin of Preemptor._minimal_preemptions.

    ``packed`` (a PackedCycle for the SAME snapshot at nominate time, e.g.
    the admission solver's cached-structure pack) avoids re-packing per
    search.  Returns a list of Targets, [] (search failed), or None
    (unsupported — run the host path)."""
    from ..scheduler.preemption import Target  # circular-safe import

    if not candidates:
        return []
    if packed is None:
        packed = pack_cycle(ctx.snapshot, [])
    if packed is None or not packed.exact:
        return None
    cq_idx = {n: i for i, n in enumerate(packed.cq_names)}
    pre_cq = cq_idx.get(ctx.preemptor_cq.name)
    if pre_cq is None:
        return None
    F = packed.usage0.shape[1]
    scale_of = {r: int(packed.resource_scale[i])
                for i, r in enumerate(packed.resource_names)}

    def to_f_vec(frq) -> Optional[np.ndarray]:
        vec = np.zeros(F, dtype=np.int64)
        for fr, v in frq.items():
            fi = packed.fr_index.get(fr)
            if fi is None:
                return None
            s = scale_of[fr.resource]
            if v % s:
                return None
            vec[fi] += v // s
        if vec.max(initial=0) > 2**31 - 1:
            return None
        return vec.astype(np.int32)

    wl_usage = to_f_vec(ctx.workload_usage)
    if wl_usage is None:
        return None
    frs_mask = np.zeros(F, dtype=bool)
    for fr in ctx.frs_need_preemption:
        fi = packed.fr_index.get(fr)
        if fi is None:
            return None
        frs_mask[fi] = True

    K = _bucket(len(candidates))
    cand_cq = np.full(K, -1, dtype=np.int32)
    cand_delta = np.zeros((K, F), dtype=np.int32)
    cand_other = np.zeros(K, dtype=bool)
    cand_above = np.zeros(K, dtype=bool)
    for i, cand in enumerate(candidates):
        ci = cq_idx.get(cand.cluster_queue)
        if ci is None:
            return None
        delta = to_f_vec(cand.usage())
        if delta is None:
            return None
        cand_cq[i] = ci
        cand_delta[i] = delta
        cand_other[i] = cand.cluster_queue != ctx.preemptor_cq.name
        cand_above[i] = (threshold is not None
                         and cand.obj.priority >= threshold)

    device = _device_of(packed)
    fitted, target_mask = minimal_preemptions(
        *_to(device, packed.usage0, packed.subtree_quota, packed.guaranteed,
             packed.borrow_cap, packed.has_borrow_limit, packed.parent),
        pre_cq, *_to(device, wl_usage, frs_mask, cand_cq, cand_delta,
                     cand_other, cand_above),
        allow_borrowing, threshold is not None, depth=packed.depth)
    fitted, target_mask = _fetch(fitted, target_mask)
    if not bool(fitted):
        return []
    mask = np.asarray(target_mask)
    targets = []
    for i, cand in enumerate(candidates):
        if not mask[i]:
            continue
        if not cand_other[i]:
            reason = IN_CLUSTER_QUEUE_REASON
        elif threshold is not None and cand.obj.priority < threshold:
            reason = IN_COHORT_RECLAIM_WHILE_BORROWING_REASON
        else:
            reason = IN_COHORT_RECLAMATION_REASON
        targets.append(Target(info=cand, reason=reason))
    return targets
