"""Batched fair-sharing DRS (SURVEY §7 stage 6).

``drs_components`` computes, for every node at once, the two tensors the
DominantResourceShare needs (reference fair_sharing.go:47-82
dominantResourceShare + calculateLendable): borrowed-above-subtree-quota
per (node, resource) and the parent's lendable capacity per
(node, resource).  ``drs_components_plain`` is its plain PyTorch
version; the routed ``drs_components`` launches the CUDA kernel
(``kernels/drs_components.cu``) on CUDA tensors.  The final exact int64
ratio/weight division happens host-side (``compute_all_drs``).

``TournamentDRS`` is the admission-tournament backend (reference
fair_sharing_iterator.go computeDRS): it packs the snapshot once per
cycle into unscaled int64 node tensors, maintains the usage tensor
incrementally as the admit loop mutates the snapshot, and computes every
remaining entry's DRS at every cohort level in ONE vectorized pass per
tournament round — replacing the per-entry simulate/revert walk that made
the tournament O(heads²·tree) in Python.  It is host numpy, the JAX
package's code unchanged."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..cache.state import MAX_DRS
from .quota_kernel import available_all


def _per_resource(x: torch.Tensor, fr_to_resource: torch.Tensor,
                  n_resources: int) -> torch.Tensor:
    """``x @ one_hot(fr_to_resource)`` for int32 ``x`` [N, F] → [N, R]
    int32: a masked sum over F (int32 matmul has no CUDA kernel in
    torch), wrapping like the JAX int32 product."""
    onehot = (fr_to_resource.long()[:, None]
              == torch.arange(n_resources, device=x.device)[None, :])
    prod = x[:, :, None] * onehot[None, :, :].to(x.dtype)     # [N, F, R]
    return prod.sum(dim=1, dtype=torch.int64).to(torch.int32)


def drs_components_plain(usage, subtree, guaranteed, borrow_cap, has_blim,
                         parent, fr_to_resource, wl_req=None, *,
                         n_resources: int, depth: int):
    """Returns (borrowing [N,R], lendable [N,R]) int32.

    fr_to_resource: [F] int32 mapping flavor-resource columns to resource
    index; wl_req: optional [N, F] additive usage (the fair-sharing
    iterator's computeDRS adds the entry's usage to its CQ)."""
    total_usage = usage if wl_req is None else usage + wl_req
    borrowed = (total_usage - subtree).clamp(min=0)                 # [N, F]
    borrowing_r = _per_resource(borrowed, fr_to_resource, n_resources)

    # lendable: potentialAvailable of each node's parent, summed per
    # resource (calculateLendable, fair_sharing.go:86)
    potential = available_all(torch.zeros_like(usage), subtree, guaranteed,
                              borrow_cap, has_blim, parent, depth)
    lendable_all = _per_resource(potential, fr_to_resource, n_resources)
    parent_safe = parent.clamp(min=0).long()
    lendable_r = torch.where((parent >= 0)[:, None],
                             lendable_all[parent_safe],
                             torch.zeros_like(lendable_all))         # [N, R]
    return borrowing_r, lendable_r


def drs_components(usage, subtree, guaranteed, borrow_cap, has_blim, parent,
                   fr_to_resource, wl_req=None, *, n_resources: int,
                   depth: int):
    """(borrowing, lendable): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; args as ``drs_components_plain``."""
    dev = usage.device
    if dev.type == "cuda":
        from .. import kernels
        return kernels.drs_components(
            usage, subtree, guaranteed, borrow_cap, has_blim, parent,
            fr_to_resource, wl_req, n_resources=n_resources, depth=depth)
    if dev.type != "cpu":
        raise ValueError(f"no drs_components kernel for device {dev}")
    return drs_components_plain(usage, subtree, guaranteed, borrow_cap,
                                has_blim, parent, fr_to_resource, wl_req,
                                n_resources=n_resources, depth=depth)


class TournamentDRS:
    """Batched computeDRS for the fair-sharing admission tournament
    (reference fair_sharing_iterator.go:157-221).

    Packs the snapshot's cohort forest once per cycle into unscaled int64
    tensors (host numpy — no int32 scaling concerns), then per tournament
    round computes every remaining entry's DominantResourceShare at every
    level of its CQ→root path in one vectorized pass, bit-matching
    cache.state.dominant_resource_share.  ``note_add`` mirrors the admit
    loop's ``simulate_usage_addition`` chain-adds into the usage tensor so
    no per-round repack is needed."""

    _NO_LIMIT = np.int64(2) ** 61

    def __init__(self, snapshot):
        from .packing import _iter_nodes
        cq_names, cohorts = _iter_nodes(snapshot)
        nodes = [snapshot.cluster_queues[n] for n in cq_names] + cohorts
        self.names: list[str] = list(cq_names) + [c.name for c in cohorts]
        self.cq_index = {n: i for i, n in enumerate(cq_names)}
        self.stale = False
        N = len(nodes)

        frs = set()
        for node in nodes:
            rn = node.resource_node
            frs.update(rn.subtree_quota)
            frs.update(rn.usage)
            frs.update(rn.quotas)
        fr_list = sorted(frs)
        self.fr_index = {fr: i for i, fr in enumerate(fr_list)}
        self.F = F = max(1, len(fr_list))
        res_names = sorted({fr.resource for fr in fr_list})
        r_index = {r: i for i, r in enumerate(res_names)}
        R = max(1, len(res_names))
        fr_to_r = np.zeros(F, dtype=np.int64)
        for fr, fi in self.fr_index.items():
            fr_to_r[fi] = r_index[fr.resource]
        self.onehot = (fr_to_r[:, None]
                       == np.arange(R)[None, :]).astype(np.int64)  # [F,R]

        parent = np.full(N, -1, dtype=np.int64)
        subtree = np.zeros((N, F), dtype=np.int64)
        sq_mask = np.zeros((N, F), dtype=bool)
        guaranteed = np.zeros((N, F), dtype=np.int64)
        borrow_cap = np.full((N, F), self._NO_LIMIT, dtype=np.int64)
        has_blim = np.zeros((N, F), dtype=bool)
        u = np.zeros((N, F), dtype=np.int64)
        weights = np.zeros(N, dtype=np.int64)
        cohort_idx = {id(c): len(cq_names) + i for i, c in enumerate(cohorts)}
        for ni, node in enumerate(nodes):
            p = node.parent
            parent[ni] = cohort_idx[id(p)] if p is not None else -1
            weights[ni] = getattr(node, "fair_weight_milli", 1000)
            rn = node.resource_node
            for fr, v in rn.subtree_quota.items():
                fi = self.fr_index[fr]
                subtree[ni, fi] = v
                sq_mask[ni, fi] = True
            for fr, v in rn.usage.items():
                u[ni, self.fr_index[fr]] = v
            for fr, q in rn.quotas.items():
                fi = self.fr_index[fr]
                g = rn.guaranteed_quota(fr)
                guaranteed[ni, fi] = g
                if q.borrowing_limit is not None:
                    has_blim[ni, fi] = True
                    borrow_cap[ni, fi] = (rn.subtree_quota.get(fr, 0) - g
                                          + q.borrowing_limit)

        depth = 1
        for ni in range(N):
            d, p = 1, int(parent[ni])
            while p >= 0:
                d += 1
                p = int(parent[p])
            depth = max(depth, d)
        self.depth = depth
        self.parent = parent
        self.subtree = subtree
        self.sq_mask = sq_mask
        self.guaranteed = guaranteed
        self.u = u
        self.weights = weights

        # lendable at node n: potentialAvailable(parent(n), fr) summed per
        # resource over the frs of root(n)'s subtree quota
        # (calculate_lendable, fair_sharing.go:86) — static per cycle
        from .cycle import available_all_np
        potential = available_all_np(np.zeros((N, F), dtype=np.int64),
                                     subtree, guaranteed, borrow_cap,
                                     has_blim, parent, depth)
        root_of = np.arange(N)
        for ni in range(N):
            cur = ni
            while parent[cur] >= 0:
                cur = int(parent[cur])
            root_of[ni] = cur
        p_safe = np.maximum(parent, 0)
        masked = np.where(sq_mask[root_of] & (parent >= 0)[:, None],
                          potential[p_safe], 0)
        self.lendable_r = masked @ self.onehot                     # [N, R]

    def u_vec(self, usage) -> Optional[np.ndarray]:
        """FlavorResourceQuantities → [F] int64, or None on unknown fr."""
        vec = np.zeros(self.F, dtype=np.int64)
        for fr, v in usage.items():
            fi = self.fr_index.get(fr)
            if fi is None:
                return None
            vec[fi] += v
        return vec

    def note_add(self, cq_name: str, usage) -> None:
        """Mirror a snapshot ``simulate_usage_addition`` into the usage
        tensor (add_usage bubbling, resource_node.go:123)."""
        ci = self.cq_index.get(cq_name)
        if ci is None:
            return
        carry = self.u_vec(usage)
        if carry is None:
            self.stale = True  # unseen fr: callers fall back per-entry
            return
        cur = ci
        while cur >= 0:
            local_avail = np.maximum(0, self.guaranteed[cur] - self.u[cur])
            self.u[cur] += carry
            carry = np.maximum(0, carry - local_avail)
            if not carry.any():
                break
            cur = int(self.parent[cur])

    def drs_for(self, cq_is: np.ndarray, u_es: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        """DRS with each entry's usage added, at every path level.

        cq_is: [W] node indices; u_es: [W, F] entry usage.  Returns
        (paths [W, L] node index or -1, drs [W, L]) where drs[j, l] is the
        DominantResourceShare of paths[j, l] after adding entry j's usage
        along its chain — the value computeDRS keys by
        (parent(paths[j, l]), workload)."""
        W = len(cq_is)
        L = self.depth
        paths = np.full((W, L), -1, dtype=np.int64)
        drs = np.zeros((W, L), dtype=np.int64)
        cur = cq_is.astype(np.int64)
        carry = u_es.copy()
        for level in range(L):
            alive = cur >= 0
            cur_s = np.maximum(cur, 0)
            par = self.parent[cur_s]
            has_par = alive & (par >= 0)
            u_after = self.u[cur_s] + carry                      # [W, F]
            borrowed = (np.maximum(0, u_after - self.subtree[cur_s])
                        * self.sq_mask[cur_s])
            borrowing_r = borrowed @ self.onehot                 # [W, R]
            has_borrow = (borrowing_r > 0).any(axis=1)
            lend = self.lendable_r[cur_s]
            qual = (borrowing_r > 0) & (lend > 0)
            ratio = np.where(qual,
                             borrowing_r * 1000 // np.maximum(lend, 1), -1)
            drs_raw = ratio.max(axis=1, initial=-1)
            w = self.weights[cur_s]
            core = drs_raw * 1000 // np.maximum(w, 1)
            dws = np.where(has_borrow, core, 0)
            dws = np.where(w == 0, MAX_DRS, dws)
            dws = np.where(has_par, dws, 0)
            drs[:, level] = dws
            paths[:, level] = np.where(alive, cur, -1)
            local_avail = np.maximum(0, self.guaranteed[cur_s]
                                     - self.u[cur_s])
            carry = np.where(alive[:, None],
                             np.maximum(0, carry - local_avail), carry)
            cur = np.where(alive, par, -1)
        return paths, drs


def compute_all_drs(snapshot, device="cuda") -> dict[str, int]:
    """DRS for every ClusterQueue and cohort in one ``drs_components``
    launch on ``device``; parity with
    cache.state.dominant_resource_share (requires exact packing)."""
    from .packing import _iter_nodes, pack_cycle, planes_to_torch
    packed = pack_cycle(snapshot, [])
    r_idx = {r: i for i, r in enumerate(packed.resource_names)}
    F = packed.usage0.shape[1]
    fr_to_resource = np.zeros(F, dtype=np.int32)
    for fr, fi in packed.fr_index.items():
        fr_to_resource[fi] = r_idx[fr.resource]
    t = planes_to_torch(dict(
        usage0=packed.usage0, subtree=packed.subtree_quota,
        guaranteed=packed.guaranteed, borrow_cap=packed.borrow_cap,
        has_blim=packed.has_borrow_limit, parent=packed.parent,
        fr_to_resource=fr_to_resource), device)
    borrowing, lendable = drs_components(
        t["usage0"], t["subtree"], t["guaranteed"], t["borrow_cap"],
        t["has_blim"], t["parent"], t["fr_to_resource"],
        n_resources=len(packed.resource_names), depth=packed.depth)
    borrowing = borrowing.cpu().numpy().astype(np.int64)
    lendable = lendable.cpu().numpy().astype(np.int64)
    # per-resource scaling cancels in the ratio only for exact packs;
    # scale back up to raw units to keep host parity regardless
    scale = packed.resource_scale.astype(np.int64)                  # [R]
    borrowing *= scale[None, :]
    lendable *= scale[None, :]

    _, cohorts = _iter_nodes(snapshot)
    names = list(packed.cq_names) + [c.name for c in cohorts]
    weights = packed.fair_weight_milli
    parent = packed.parent
    out: dict[str, int] = {}
    for i, name in enumerate(names):
        if parent[i] < 0:
            out[name] = 0
            continue
        if weights[i] == 0:
            out[name] = MAX_DRS
            continue
        if not (borrowing[i] > 0).any():
            out[name] = 0       # not borrowing at all (fair_sharing.go:63)
            continue
        drs = -1
        for r in range(borrowing.shape[1]):
            if borrowing[i, r] > 0 and lendable[i, r] > 0:
                drs = max(drs, int(borrowing[i, r]) * 1000
                          // int(lendable[i, r]))
        out[name] = drs * 1000 // int(weights[i])
    return out
