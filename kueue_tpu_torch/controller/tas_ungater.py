"""Topology ungater (reference pkg/controller/tas/topology_ungater.go:152).

Admitted TAS workloads carry a TopologyAssignment (domains + counts).
Pods of the workload hold a TAS scheduling gate; the ungater assigns pods
to domains **rank-ordered** (completion-index style: pod rank i goes to
the first domain whose cumulative count exceeds i), injects the domain's
node-selector labels, and removes the gate.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..api.types import TopologyAssignment, Workload

TAS_SCHEDULING_GATE = "kueue.x-k8s.io/topology"
POD_RANK_ANNOTATION = "kueue.x-k8s.io/pod-rank"

_trailing_index = re.compile(r"(\d+)$")


def pod_rank(pod) -> int:
    """Rank from annotation (batch completion index equivalent) or the
    trailing integer of the pod name (topology_ungater.go rank logic)."""
    rank = getattr(pod, "annotations", {}).get(POD_RANK_ANNOTATION)
    if rank is not None:
        return int(rank)
    match = _trailing_index.search(pod.name)
    return int(match.group(1)) if match else 0


@dataclass
class UngateDecision:
    pod_name: str
    rank: int
    domain_values: list[str]
    node_selector: dict[str, str]


def assign_pods_to_domains(assignment: TopologyAssignment,
                           pods: list) -> list[UngateDecision]:
    """Rank-ordered pod→domain mapping (topology_ungater.go:152)."""
    ordered = sorted(pods, key=pod_rank)
    decisions = []
    di = 0
    used_in_domain = 0
    for pod in ordered:
        while (di < len(assignment.domains)
               and used_in_domain >= assignment.domains[di].count):
            di += 1
            used_in_domain = 0
        if di >= len(assignment.domains):
            break  # more pods than assigned capacity — leave gated
        dom = assignment.domains[di]
        selector = {level: value
                    for level, value in zip(assignment.levels, dom.values)}
        decisions.append(UngateDecision(
            pod_name=pod.name, rank=pod_rank(pod),
            domain_values=list(dom.values), node_selector=selector))
        used_in_domain += 1
    return decisions


class TopologyUngater:
    """Watches admitted TAS workloads and ungates their pods."""

    def __init__(self, driver):
        self.driver = driver
        # workload key → list of gated pod objects (registered by the
        # job integration, e.g. the pod group controller)
        self.gated_pods: dict[str, list] = {}

    def register_pods(self, workload_key: str, pods: list) -> None:
        self.gated_pods.setdefault(workload_key, []).extend(pods)

    def reconcile(self) -> list[UngateDecision]:
        """Ungate pods of every admitted workload with a topology
        assignment.  Returns the decisions applied this pass."""
        applied: list[UngateDecision] = []
        for key, pods in list(self.gated_pods.items()):
            wl = self.driver.workloads.get(key)
            if wl is None or not wl.is_admitted or wl.admission is None:
                continue
            for psa in wl.admission.pod_set_assignments:
                ta = psa.topology_assignment
                if ta is None:
                    continue
                ps_pods = [p for p in pods
                           if getattr(p, "pod_set", "main") == psa.name
                           and TAS_SCHEDULING_GATE in
                           getattr(p, "scheduling_gates", [])]
                for decision in assign_pods_to_domains(ta, ps_pods):
                    for p in ps_pods:
                        if p.name == decision.pod_name:
                            p.node_selector.update(decision.node_selector)
                            p.scheduling_gates.remove(TAS_SCHEDULING_GATE)
                            if getattr(p, "phase", None) == "Pending":
                                p.phase = "Running"
                            break
                    applied.append(decision)
            if all(TAS_SCHEDULING_GATE not in
                   getattr(p, "scheduling_gates", []) for p in pods):
                del self.gated_pods[key]
        return applied
