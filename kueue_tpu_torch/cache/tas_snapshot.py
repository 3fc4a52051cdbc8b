"""Topology flavor snapshot: the domain tree + assignment algorithm.

Capability parity with reference pkg/cache/tas_flavor_snapshot.go:91: a tree
of topology domains (e.g. block → rack → hostname) built from node labels,
with per-leaf free capacity.  ``find_topology_assignment`` mirrors the
two-phase algorithm (tas_flavor_snapshot.go:406-613): phase 1 fills pod
counts bottom-up; phase 2 picks the lowest level whose best domain fits all
pods (falling back upward for `preferred`), then walks down level by level
minimizing the number of domains (BestFit).

The batched formulation of the same algorithm lives in
kueue_tpu_torch.ops.tas_kernel (segment reductions over a level-indexed
CSR tree, three CUDA kernels on the card), on the snapshot's ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api.types import (
    PodSetTopologyRequest,
    TopologyAssignment,
    TopologyDomainAssignment,
)
from .tas_cache import NodeInfo


@dataclass(eq=False)  # identity hash: domains are keyed in chosen-maps
class Domain:
    """One topology domain (reference tas_flavor_snapshot.go `domain`)."""
    id: tuple                      # label values from root level to this level
    level: int
    parent: Optional["Domain"] = None
    children: list["Domain"] = field(default_factory=list)
    # leaf-only: free capacity (canonical ints)
    free: dict[str, int] = field(default_factory=dict)
    # per-query state
    state: int = 0                 # how many pods fit in this subtree


class TASFlavorSnapshot:
    device = "cuda"    # where _find_device runs (TASCache.snapshot stamps it)

    def __init__(self, flavor: str, levels: list[str]):
        self.flavor = flavor
        self.levels = levels
        self.leaves: dict[tuple, Domain] = {}
        self.roots: list[Domain] = []
        self.domains_per_level: list[list[Domain]] = [[] for _ in levels]

    @staticmethod
    def build(flavor: str, levels: list[str], nodes: list[NodeInfo],
              usage: dict[tuple, dict[str, int]]) -> "TASFlavorSnapshot":
        snap = TASFlavorSnapshot(flavor, levels)
        by_id: dict[tuple, Domain] = {}
        for node in nodes:
            values = tuple(node.labels.get(lvl, "") for lvl in levels)
            if any(v == "" for v in values):
                continue  # node not fully labelled for this topology
            leaf = by_id.get(values)
            if leaf is None:
                leaf = Domain(id=values, level=len(levels) - 1)
                by_id[values] = leaf
                snap.leaves[values] = leaf
            for rname, cap in node.capacity.items():
                leaf.free[rname] = leaf.free.get(rname, 0) + cap
        for dom_id, used in usage.items():
            leaf = snap.leaves.get(tuple(dom_id))
            if leaf is not None:
                for rname, qty in used.items():
                    leaf.free[rname] = leaf.free.get(rname, 0) - qty
        # link up the tree
        for leaf in list(snap.leaves.values()):
            child = leaf
            for lvl in range(len(levels) - 2, -1, -1):
                pid = child.id[: lvl + 1]
                parent = by_id.get(pid)
                if parent is None:
                    parent = Domain(id=pid, level=lvl)
                    by_id[pid] = parent
                if child.parent is None:
                    child.parent = parent
                    parent.children.append(child)
                child = parent
        for dom in by_id.values():
            snap.domains_per_level[dom.level].append(dom)
            if dom.level == 0:
                snap.roots.append(dom)
        return snap

    # ------------------------------------------------------------------

    def _fill_in_counts(self, per_pod: dict[str, int],
                        assumed: dict[tuple, dict[str, int]] | None = None) -> None:
        """Phase 1 (reference tas_flavor_snapshot.go fillInCounts): compute
        how many pods fit in each domain, bottom-up."""
        for leaf in self.leaves.values():
            fits = None
            for rname, need in per_pod.items():
                if need <= 0:
                    continue
                free = leaf.free.get(rname, 0)
                if assumed:
                    free -= assumed.get(leaf.id, {}).get(rname, 0)
                n = max(0, free) // need
                fits = n if fits is None else min(fits, n)
            leaf.state = fits if fits is not None else 0
        for lvl in range(len(self.levels) - 2, -1, -1):
            for dom in self.domains_per_level[lvl]:
                dom.state = sum(c.state for c in dom.children)

    def _level_index(self, label: Optional[str]) -> Optional[int]:
        if label is None:
            return None
        try:
            return self.levels.index(label)
        except ValueError:
            return None

    def find_topology_assignment(
            self, count: int, per_pod: dict[str, int],
            request: PodSetTopologyRequest,
            assumed: dict[tuple, dict[str, int]] | None = None,
    ) -> tuple[Optional[TopologyAssignment], str]:
        """Phase 1 + 2 (reference tas_flavor_snapshot.go:406-613).

        Returns (assignment at the leaf level, reason-on-failure).
        """
        if not self.levels:
            return None, "no topology levels"
        required_idx = self._level_index(request.required)
        preferred_idx = self._level_index(request.preferred)
        if request.required and required_idx is None:
            return None, f"level {request.required} not in topology"
        if request.preferred and preferred_idx is None:
            return None, f"level {request.preferred} not in topology"
        if self._device_kernel_eligible(request):
            return self._find_device(count, per_pod, request, assumed,
                                     required_idx, preferred_idx)
        self._fill_in_counts(per_pod, assumed)

        if request.unconstrained:
            # any set of leaves; minimize domain count from the top
            total = sum(r.state for r in self.roots)
            if total < count:
                return None, self._fit_message(count, total)
            chosen = self._select_from(
                self._sorted_domains(self.roots, unconstrained=True),
                count, unconstrained=True)
        else:
            if required_idx is not None:
                fit_idx, domain = self._find_fit_at(required_idx, count)
                if domain is None:
                    return None, self._fit_message_level(count, required_idx)
            else:
                start = preferred_idx if preferred_idx is not None else len(self.levels) - 1
                fit_idx, domain = None, None
                for lvl in range(start, -1, -1):
                    fit_idx, domain = self._find_fit_at(lvl, count)
                    if domain is not None:
                        break
                if domain is None:
                    # final fallback: split across root domains
                    total = sum(r.state for r in self.roots)
                    if total < count:
                        return None, self._fit_message(count, total)
                    chosen = self._select_from(
                        self._sorted_domains(self.roots), count)
                    return self._assignment_from(chosen), ""
            chosen = {domain: count}
        return self._assignment_from(chosen), ""

    # -- device kernel path (ops/tas_kernel, TASDeviceKernel gate) -----

    def _device_kernel_eligible(self, request: PodSetTopologyRequest) -> bool:
        """The batched kernel implements all three TAS profiles
        (BestFit default, TASProfileMostFreeCapacity,
        TASProfileLeastFreeCapacity incl. Mixed's unconstrained
        variant — tas_flavor_snapshot.go:551-568)."""
        from .. import features
        return features.enabled("TASDeviceKernel") and bool(self.leaves)

    def _device_profile(self, unconstrained: bool) -> str:
        if self._use_best_fit(unconstrained):
            return "bestfit"
        if self._use_least_free(unconstrained):
            return "leastfree"
        return "mostfree"

    def _find_device(self, count: int, per_pod: dict[str, int],
                     request: PodSetTopologyRequest,
                     assumed: dict[tuple, dict[str, int]] | None,
                     required_idx: Optional[int],
                     preferred_idx: Optional[int],
                     ) -> tuple[Optional[TopologyAssignment], str]:
        """find_topology_assignment on the batched kernel
        (ops/tas_kernel: segment reductions over level-CSR arrays),
        decision-identical to the scalar walk (tests/test_tas_kernel.py
        + test_tas_device_path)."""
        import numpy as np
        import torch
        from ..ops import tas_kernel as tk

        packed = getattr(self, "_packed_tas", None)
        if packed is None:
            packed = self._packed_tas = tk.pack_tas(self)
            # the static planes, uploaded once per snapshot
            self._tas_planes = tk.tas_planes(packed, self.device)
        sizes = tuple(packed.level_sizes)
        parents = self._tas_planes
        r_index = {r: i for i, r in enumerate(packed.resource_names)}

        per_pod_vec = np.zeros(max(1, len(packed.resource_names)),
                               dtype=np.int32)
        unknown_requested = False
        for r, v in per_pod.items():
            if v <= 0:
                continue
            ri = r_index.get(r)
            if ri is None:
                unknown_requested = True  # no leaf has it: states all 0
            else:
                per_pod_vec[ri] = v
        leaf_free = packed.leaf_free
        if assumed:
            leaf_free = leaf_free.copy()
            for i, did in enumerate(packed.leaf_ids):
                a = assumed.get(did)
                if a:
                    for r, v in a.items():
                        ri = r_index.get(r)
                        if ri is not None:
                            leaf_free[i, ri] = max(0, leaf_free[i, ri] - v)
        if unknown_requested:
            leaf_free = np.zeros_like(packed.leaf_free)
        # the query's inputs, uploaded once; results come back by .cpu()
        leaf_free = torch.from_numpy(leaf_free).to(self.device)
        per_pod_vec = torch.from_numpy(per_pod_vec).to(self.device)

        def level_states(level: int) -> np.ndarray:
            states = tk.fill_counts(leaf_free, per_pod_vec, parents,
                                    level_sizes=sizes, device=self.device)
            return states[level].cpu().numpy()

        def total_fit() -> int:
            return int(level_states(0).sum())

        def finish(leaf_counts) -> TopologyAssignment:
            domains = [TopologyDomainAssignment(values=list(did),
                                                count=int(c))
                       for did, c in sorted(
                           (packed.leaf_ids[i], int(c))
                           for i, c in enumerate(leaf_counts.cpu().numpy())
                           if c)]
            return TopologyAssignment(levels=list(self.levels),
                                      domains=domains)

        profile = self._device_profile(False)
        if request.unconstrained:
            ok, counts = tk.split_across_roots(
                leaf_free, per_pod_vec, parents, count, level_sizes=sizes,
                profile=self._device_profile(True),
                descend_profile=profile, device=self.device)
            if not bool(ok):
                return None, self._fit_message(count, total_fit())
            return finish(counts), ""

        if required_idx is not None:
            ok, counts = tk.best_fit_descend(
                leaf_free, per_pod_vec, parents, count,
                level_sizes=sizes, level=required_idx, profile=profile,
                device=self.device)
            if not bool(ok):
                # host message reads Domain.state, unfilled on this path:
                # compute the best single-domain fit from kernel states
                best = int(level_states(required_idx).max(initial=0))
                return None, (
                    f"topology {self.flavor!r} allows to fit only {best} "
                    f"out of {count} pod(s) in a single "
                    f"{self.levels[required_idx]!r}")
            return finish(counts), ""

        start = (preferred_idx if preferred_idx is not None
                 else len(self.levels) - 1)
        for lvl in range(start, -1, -1):
            ok, counts = tk.best_fit_descend(
                leaf_free, per_pod_vec, parents, count,
                level_sizes=sizes, level=lvl, profile=profile,
                device=self.device)
            if bool(ok):
                return finish(counts), ""
        ok, counts = tk.split_across_roots(
            leaf_free, per_pod_vec, parents, count, level_sizes=sizes,
            profile=profile, device=self.device)
        if not bool(ok):
            return None, self._fit_message(count, total_fit())
        return finish(counts), ""

    # -- helpers --

    @staticmethod
    def _domain_order(dom: Domain):
        # default sortedDomains order: state descending, ties by id
        # (reference tas_flavor_snapshot.go:631)
        return (-dom.state, dom.id)

    @staticmethod
    def _use_best_fit(unconstrained: bool = False) -> bool:
        """reference tas_flavor_snapshot.go:551 useBestFitAlgorithm."""
        from .. import features
        if (features.enabled("TASProfileMostFreeCapacity")
                or features.enabled("TASProfileLeastFreeCapacity")
                or (unconstrained and features.enabled("TASProfileMixed"))):
            return False
        return True

    @staticmethod
    def _use_least_free(unconstrained: bool = False) -> bool:
        """reference tas_flavor_snapshot.go:561."""
        from .. import features
        return (features.enabled("TASProfileLeastFreeCapacity")
                or (unconstrained and features.enabled("TASProfileMixed")))

    def _sorted_domains(self, domains: list[Domain],
                        unconstrained: bool = False) -> list[Domain]:
        """reference sortedDomains: state desc, ties by id; the
        least-free profiles reverse the order."""
        out = sorted(domains, key=self._domain_order)
        if self._use_least_free(unconstrained):
            out.reverse()
        return out

    def _find_fit_at(self, level: int, count: int) -> tuple[int, Optional[Domain]]:
        """Best single domain at `level` that fits all pods.

        Default BestFit picks the least spare capacity (reference
        findBestFitDomainIdx); TASProfileMostFreeCapacity picks the most
        free (the top of sortedDomains)."""
        fitting = [d for d in self.domains_per_level[level]
                   if d.state >= count]
        if not fitting:
            return level, None
        if self._use_best_fit() or self._use_least_free():
            return level, min(fitting, key=lambda d: (d.state, d.id))
        return level, min(fitting, key=self._domain_order)

    def _select_from(self, ordered: list[Domain], count: int,
                     unconstrained: bool = False) -> dict[Domain, int]:
        """Multi-domain split over a sortedDomains list (reference
        updateCountsToMinimum, tas_flavor_snapshot.go:571): walk the
        order taking whole domains; under BestFit, once the remainder
        fits a single domain, pick the tightest such domain for it."""
        chosen: dict[Domain, int] = {}
        remaining = count
        best_fit = self._use_best_fit(unconstrained)
        for i, dom in enumerate(ordered):
            if remaining <= 0:
                break
            if best_fit and dom.state >= remaining:
                # optimize the last domain (findBestFitDomainIdx)
                dom = min((d for d in ordered[i:] if d.state >= remaining),
                          key=lambda d: (d.state, d.id))
            if dom.state >= remaining:
                chosen[dom] = chosen.get(dom, 0) + remaining
                return chosen
            if dom.state > 0:
                chosen[dom] = chosen.get(dom, 0) + dom.state
                remaining -= dom.state
        return chosen

    def _assignment_from(self, chosen: dict[Domain, int]) -> TopologyAssignment:
        """Walk chosen domains down to leaves, minimizing leaf-domain count."""
        leaf_counts: dict[tuple, int] = {}
        for dom, cnt in chosen.items():
            self._descend(dom, cnt, leaf_counts)
        domains = [TopologyDomainAssignment(values=list(dom_id), count=cnt)
                   for dom_id, cnt in sorted(leaf_counts.items())]
        return TopologyAssignment(levels=list(self.levels), domains=domains)

    def _descend(self, dom: Domain, cnt: int, out: dict[tuple, int]) -> None:
        if not dom.children:  # leaf
            out[dom.id] = out.get(dom.id, 0) + cnt
            return
        # updateCountsToMinimum over the children at each level
        for child, take in self._select_from(
                self._sorted_domains(dom.children), cnt).items():
            self._descend(child, take, out)

    def _fit_message(self, count: int, total: int) -> str:
        return (f"topology {self.flavor!r} allows to fit only {total} "
                f"out of {count} pod(s)")

    def _fit_message_level(self, count: int, level: int) -> str:
        best = max((d.state for d in self.domains_per_level[level]), default=0)
        return (f"topology {self.flavor!r} allows to fit only {best} "
                f"out of {count} pod(s) in a single {self.levels[level]!r}")
