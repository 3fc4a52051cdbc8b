"""Device fair-sharing admission: the tournament + admit loop as ONE
launch.

A fair-sharing cycle's admission order depends on DRS, which changes as
entries admit, so the tournament winner selection, fit re-check and
usage mutation run as one sequence of rounds on the device
(``fs_admit_scan``), and plain-admission fair-sharing cycles become
fully device-decided (FULL mode).  ``fs_admit_scan_plain`` is the plain
PyTorch version; the routed ``fs_admit_scan`` launches the CUDA kernel
``kernels/fs_admit_scan.cu`` on CUDA tensors.

Reference semantics reproduced exactly (fair_sharing_iterator.go):

- Per round, the first remaining entry in heads order is taken; a
  parentless CQ's entry wins immediately (the iterator yields it), else
  the **tournament** runs over that entry's cohort tree: at every cohort
  node, the surviving candidate minimizes (DRS of its child-of-this-node
  ancestor with the entry's usage added, then priority desc, timestamp
  asc, then structural child order) — runTournament/entryComparer.less
  (:121,:167).
- DRS (fair_sharing.go:47-82): max over resources of borrowed-above-
  subtree-quota × 1000 // lendable-in-parent, then × 1000 // fairWeight;
  0 when not borrowing or at a root, MAX when weight is zero.  The
  int32-scaled tensors preserve the exact host values because every
  quantity of one resource shares the per-resource scale and
  floor((a/s)·1000/(b/s)) == floor(a·1000/b); the packer refuses shapes
  whose intermediate products could overflow int32 (host falls back).
  Both divisions FLOOR (a borrowing entry with no lendable resource has
  ratio -1, and -1000 // w is -1 for any weight above 1000).
- The winner is processed like the host admit loop: NO_FIT entries are
  discarded, fit entries re-check chain-local availability against the
  mutated usage (scheduler.go:372) and either admit (usage charged up
  the ancestor chain) or skip.

Quota and the tournament never cross cohort forests, so each round
computes DRS and runs the tournament only within the forest of its first
remaining entry (``forest_of_node``); the outputs are those of the
all-forest computation.  ``FSStatics``, ``build_fs_statics`` and
``fs_bounds_ok`` are the JAX package's host numpy, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .quota_kernel import add_usage_chain_, available_at

INF_I32 = np.int32(2**31 - 1)
MAX_DRS_I32 = np.int32(2**31 - 2)   # weight-zero sentinel (host MAX_DRS)


@dataclass
class FSStatics:
    """Fair-sharing structure tensors, cached per structure generation."""
    sq_mask: np.ndarray       # [N, F] bool: fr present in subtree_quota
    lendable_r: np.ndarray    # [N, R] int32 scaled lendable-in-parent
    onehot: np.ndarray        # [F, R] int32 fr -> resource
    node_level: np.ndarray    # [N] int32 (roots = 0)
    child_order: np.ndarray   # [N] int32 rank among parent's children
    n_levels: int
    drs_bound_base: int       # max scaled borrowing the statics allow


def build_fs_statics(snapshot, st) -> Optional[FSStatics]:
    """Build the static FS tensors for a PackedStructure.

    Returns None when the scaled DRS math could overflow int32 for ANY
    conceivable usage below the structure's quota ceilings — the
    scheduler then keeps the host tournament."""
    from .cycle import available_all_np
    N, F = st.subtree_quota.shape
    C = len(st.cq_names)
    R = len(st.resource_names)

    fr_to_r = np.zeros(F, dtype=np.int64)
    for fr, fi in st.fr_index.items():
        fr_to_r[fi] = st.r_index[fr.resource]
    onehot = (fr_to_r[:, None] == np.arange(R)[None, :]).astype(np.int32)

    # subtree-quota presence masks + child enumeration order from the
    # snapshot (cohorts before CQs, list order — _fs_tournament)
    from .packing import _iter_nodes
    cq_names, cohorts = _iter_nodes(snapshot)
    if list(cq_names) != list(st.cq_names):
        return None
    nodes = [snapshot.cluster_queues[n] for n in cq_names] + cohorts
    sq_mask = np.zeros((N, F), dtype=bool)
    for ni, node in enumerate(nodes):
        for fr in node.resource_node.subtree_quota:
            fi = st.fr_index.get(fr)
            if fi is not None:
                sq_mask[ni, fi] = True

    node_index: dict[int, int] = {id(n): i for i, n in enumerate(nodes)}
    child_order = np.zeros(N, dtype=np.int32)
    for ci, cohort in enumerate(cohorts):
        rank = 0
        for ch in cohort.child_cohorts:
            i = node_index.get(id(ch))
            if i is not None:
                child_order[i] = rank
                rank += 1
        for cq in cohort.child_cqs:
            i = node_index.get(id(cq))
            if i is not None:
                child_order[i] = rank
                rank += 1

    node_level = np.zeros(N, dtype=np.int32)
    for ni in range(N):
        lvl, p = 0, int(st.parent[ni])
        while p >= 0:
            lvl += 1
            p = int(st.parent[p])
        node_level[ni] = lvl
    n_levels = int(node_level.max()) + 1

    # lendable: potentialAvailable of the parent, masked to the frs of
    # the root's subtree quota, summed per resource (fair_sharing.go:86)
    potential = available_all_np(
        np.zeros((N, F), np.int64), st.subtree_quota, st.guaranteed,
        st.borrow_cap, st.has_borrow_limit, st.parent, st.depth)
    root_of = np.arange(N)
    for ni in range(N):
        cur = ni
        while st.parent[cur] >= 0:
            cur = int(st.parent[cur])
        root_of[ni] = cur
    p_safe = np.maximum(st.parent, 0)
    masked = np.where(sq_mask[root_of] & (st.parent >= 0)[:, None],
                      potential[p_safe], 0)
    lendable64 = masked @ onehot.astype(np.int64)                # [N, R]
    if lendable64.max(initial=0) > INF_I32:
        return None
    lendable_r = lendable64.astype(np.int32)

    # overflow ceiling: the largest borrowing any usage below the quota
    # plane could show is bounded by the total subtree quota (borrowing
    # never exceeds what parents can lend)
    drs_bound_base = int(np.abs(st.subtree_quota.astype(np.int64)).sum())
    return FSStatics(sq_mask=sq_mask, lendable_r=lendable_r,
                     onehot=onehot, node_level=node_level,
                     child_order=child_order, n_levels=n_levels,
                     drs_bound_base=drs_bound_base)


def fs_bounds_ok(statics: FSStatics, usage0, u_e) -> bool:
    """True when every intermediate DRS product stays inside int32.

    Structural bound: the device path only ever adds FIT-checked entry
    usage to usage from admitted workloads, so borrowing never exceeds
    the parent's lendable capacity and ratio <= 1000; the remaining
    products are borrowing*1000 (bounded by both total usage and max
    lendable) and ratio*1000 (<= 10^6).  The kernel additionally clamps
    ratio so a violated assumption can't wrap."""
    b = (int(np.abs(usage0.astype(np.int64)).max(initial=0))
         + int(np.abs(u_e.astype(np.int64)).sum(axis=0).max(initial=0)))
    lend_max = int(statics.lendable_r.astype(np.int64).max(initial=0))
    return (min(b, lend_max) * 1000 < 2**31) and (b < 2**31)


def fs_statics_to_torch(statics: FSStatics, device) -> dict:
    """The statics' arrays as ``{name: tensor}`` on ``device``, same
    dtypes (``sq_mask``, ``lendable_r``, ``onehot``, ``node_level``,
    ``child_order``) — from this package's ``FSStatics`` or the JAX
    package's (the same dataclass layout)."""
    from .packing import planes_to_torch
    return planes_to_torch(
        {k: getattr(statics, k) for k in ("sq_mask", "lendable_r", "onehot",
                                          "node_level", "child_order")},
        device)


# the scan's positional tensors, in order
FS_ARGS = ("usage0", "subtree", "sq_mask", "guaranteed", "borrow_cap",
           "has_blim", "parent", "node_level", "weights", "lendable_r",
           "onehot", "child_order", "wl_cq", "u_e", "nofit", "prio",
           "ts_rank", "valid", "forest_of_node")


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp ``//``: floor division (never truncation)."""
    return torch.div(a, b, rounding_mode="floor")


def _entry_drs(usage, subtree, sq_mask, guaranteed, parent, weights,
               lendable_r, onehot, path, u_e):
    """DRS [E, L] of entries with node paths ``path`` [E, L] and usage
    ``u_e`` [E, F] after adding the entry's usage along its chain
    (TournamentDRS.drs_for in scaled int32)."""
    L = path.shape[1]
    i32 = torch.int32
    out = []
    carry_u = u_e
    for lvl in range(L):
        node = path[:, lvl]
        alive = node >= 0
        ns = node.clamp(min=0).long()
        has_par = alive & (parent[ns] >= 0)
        u_after = usage[ns] + carry_u
        borrowed = (u_after - subtree[ns]).clamp(min=0) * sq_mask[ns].to(i32)
        borrowing_r = (borrowed[:, :, None] * onehot[None, :, :]).sum(
            dim=1, dtype=torch.int64).to(i32)                   # [E, R]
        has_borrow = (borrowing_r > 0).any(dim=1)
        lend = lendable_r[ns]
        lend1 = lend.clamp(min=1)
        qual = (borrowing_r > 0) & (lend > 0)
        # borrowing <= lendable in every reachable state (fit-checked
        # additions over admitted usage); the clamp guards the int32
        # product if that invariant is ever violated
        safe_b = torch.minimum(borrowing_r, lend1)
        ratio = torch.where(qual, _floordiv(safe_b * 1000, lend1),
                            torch.full_like(safe_b, -1))
        drs_raw = ratio.max(dim=1).values
        w = weights[ns]
        core = _floordiv(drs_raw * 1000, w.clamp(min=1))
        dws = torch.where(has_borrow, core, torch.zeros_like(core))
        dws = torch.where(w == 0, torch.full_like(dws, int(MAX_DRS_I32)),
                          dws)
        dws = torch.where(has_par, dws, torch.zeros_like(dws))
        out.append(dws)
        local_avail = (guaranteed[ns] - usage[ns]).clamp(min=0)
        carry_u = torch.where(alive[:, None],
                              (carry_u - local_avail).clamp(min=0), carry_u)
    return torch.stack(out, dim=1)


def fs_admit_scan_plain(usage0, subtree, sq_mask, guaranteed, borrow_cap,
                        has_blim, parent, node_level, weights, lendable_r,
                        onehot, child_order, wl_cq, u_e, nofit, prio,
                        ts_rank, valid, forest_of_node, *, depth: int,
                        n_levels: int, n_forests: Optional[int] = None,
                        max_forest: Optional[int] = None):
    """The fair-sharing cycle as W rounds of tournament + admit.  Returns
    (order [W] int32 winner per round or -1, admitted [W] bool,
    processed [W] bool) in head order; a fit head with ``processed`` and
    not ``admitted`` lost capacity in-cycle (skip).  ``n_forests`` and
    ``max_forest`` size the CUDA kernel's grid and blocks; the rounds
    here do not need them."""
    N, F = usage0.shape
    W = wl_cq.shape[0]
    L = depth
    dev = usage0.device
    i32 = torch.int32
    INF = int(INF_I32)
    cidx = torch.arange(W, dtype=i32, device=dev)
    cq_safe = wl_cq.clamp(min=0).long()
    parent_l = parent.long()
    # static per entry: the path from its CQ to the root
    paths = [cq_safe]
    for _ in range(L - 1):
        prev = paths[-1]
        paths.append(torch.where(prev >= 0, parent_l[prev.clamp(min=0)],
                                 torch.full_like(prev, -1)))
    path = torch.stack(paths, dim=1)                     # [W, L]
    parentless = parent[cq_safe] < 0
    cq_lv = node_level[cq_safe]
    forest_of_entry = forest_of_node[cq_safe]
    p_s = parent_l.clamp(min=0)
    is_level = [node_level == lvl for lvl in range(n_levels)]
    has_parent = parent >= 0
    drop = torch.full((N,), N, dtype=torch.long, device=dev)

    usage = usage0.clone()
    remaining = valid.clone()
    order = torch.full((W,), -1, dtype=i32, device=dev)
    admit_o = torch.zeros(W, dtype=torch.bool, device=dev)

    def scatter_min(tgt, keys):
        return torch.full((N + 1,), INF, dtype=i32, device=dev).scatter_reduce_(
            0, tgt, keys, "amin", include_self=True)

    for rnd in range(W):
        live = remaining & valid
        if not bool(live.any()):
            break          # the rounds left write -1 / not admitted
        # first remaining entry (argmax of a bool vector: first True)
        e0 = int(torch.argmax(live.to(i32)))
        in_forest = live & (forest_of_entry == forest_of_entry[e0])
        sel = torch.nonzero(in_forest).flatten()

        # -- DRS of the forest's remaining entries at every path level --
        drs = torch.zeros((W, L), dtype=i32, device=dev)
        drs[sel] = _entry_drs(usage, subtree, sq_mask, guaranteed, parent,
                              weights, lendable_r, onehot, path[sel],
                              u_e[sel])

        # -- tournament: bottom-up winner propagation --------------------
        # node_winner[n] = the best remaining entry in n's subtree,
        # promoted level by level with a 4-key scatter-argmin (drs at the
        # child node, priority desc, ts asc, child order); dead rows
        # target the drop bucket N (each CQ holds at most one head)
        node_winner = torch.full((N + 1,), -1, dtype=i32, device=dev)
        node_winner[cq_safe[sel]] = cidx[sel]
        node_winner = node_winner[:N]
        for lvl in range(n_levels - 1, 0, -1):
            has_w = is_level[lvl] & (node_winner >= 0) & has_parent
            e = node_winner.clamp(min=0).long()
            li = (cq_lv[e] - lvl).clamp(0, L - 1).long()
            inf = torch.full((N,), INF, dtype=i32, device=dev)
            k_drs = torch.where(has_w, drs[e, li], inf)
            k_prio = torch.where(has_w, -prio[e], inf)
            k_ts = torch.where(has_w, ts_rank[e], inf)
            k_ord = torch.where(has_w, child_order, inf)
            tgt = torch.where(has_w, p_s, drop)
            m1 = scatter_min(tgt, k_drs)
            ok1 = has_w & (k_drs == m1[tgt])
            m2 = scatter_min(tgt, torch.where(ok1, k_prio, inf))
            ok2 = ok1 & (k_prio == m2[tgt])
            m3 = scatter_min(tgt, torch.where(ok2, k_ts, inf))
            ok3 = ok2 & (k_ts == m3[tgt])
            m4 = scatter_min(tgt, torch.where(ok3, k_ord, inf))
            ok4 = ok3 & (k_ord == m4[tgt])
            promoted = torch.full((N + 1,), -1, dtype=i32,
                                  device=dev).scatter_reduce_(
                0, tgt, torch.where(ok4, node_winner,
                                    torch.full_like(node_winner, -1)),
                "amax", include_self=True)[:N]
            node_winner = torch.where(is_level[lvl - 1] & (promoted >= 0),
                                      promoted, node_winner)

        # root of e0's tree
        root = int(cq_safe[e0])
        for _ in range(L - 1):
            p = int(parent[root])
            root = p if p >= 0 else root
        tw = int(node_winner[root])
        winner = e0 if (bool(parentless[e0]) or tw < 0) else tw

        # -- process the winner (host admit-loop semantics) -------------
        w_cq = int(cq_safe[winner])
        avail = available_at(usage, subtree, guaranteed, borrow_cap,
                             has_blim, parent, w_cq, depth)
        w_u = u_e[winner]
        fits = bool(torch.where(w_u > 0, w_u <= avail,
                                torch.ones_like(w_u, dtype=torch.bool)).all())
        can_admit = (not bool(nofit[winner])) and fits
        if can_admit:
            add_usage_chain_(usage, w_cq, w_u, guaranteed, parent, depth)
        remaining[winner] = False
        order[rnd] = winner
        admit_o[rnd] = can_admit

    live = order >= 0
    sel = order[live].long()
    admitted = torch.zeros(W, dtype=torch.bool, device=dev)
    processed = torch.zeros(W, dtype=torch.bool, device=dev)
    admitted[sel] = admit_o[live]
    processed[sel] = True
    return order, admitted, processed


def fs_admit_scan(*args, depth: int, n_levels: int,
                  n_forests: Optional[int] = None,
                  max_forest: Optional[int] = None):
    """(order, admitted, processed): the CUDA kernel for CUDA tensors (a
    block per cohort forest: ``n_forests`` forests, ``forest_of_node``
    in [0, n_forests), the largest of ``max_forest`` nodes), the plain
    version for CPU tensors; args as ``fs_admit_scan_plain``."""
    dev = args[0].device
    kw = dict(depth=depth, n_levels=n_levels, n_forests=n_forests,
              max_forest=max_forest)
    if dev.type == "cuda":
        from .. import kernels
        return kernels.fs_admit_scan(*args, **kw)
    if dev.type != "cpu":
        raise ValueError(f"no fs_admit_scan kernel for device {dev}")
    return fs_admit_scan_plain(*args, **kw)
