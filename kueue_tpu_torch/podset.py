"""PodSetInfo: the payload injected into job pod templates on admission.

Capability parity with reference pkg/podset/podset.go: on admission the
assigned flavors' node labels/taints become node selectors/tolerations on
the job's pod template (``from_assignment``, reference podset.go:56);
admission-check controllers contribute extra updates (``from_update``);
on suspension the original template is restored (``restore``, reference
podset.go:173).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .api.types import (
    PodSet,
    PodSetAssignment,
    ResourceFlavor,
    Toleration,
    TopologyAssignment,
)


class BadPodSetsUpdateError(Exception):
    """Merge conflict between admission-check updates (podset.go:152)."""


@dataclass
class PodSetInfo:
    """reference podset.go:44 PodSetInfo."""
    name: str
    count: int = 0
    node_selector: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)
    scheduling_gates: list[str] = field(default_factory=list)
    topology_assignment: Optional[TopologyAssignment] = None

    @staticmethod
    def from_assignment(psa: PodSetAssignment, count: int,
                        flavors: dict[str, ResourceFlavor]) -> "PodSetInfo":
        """reference podset.go:56 FromAssignment."""
        info = PodSetInfo(name=psa.name, count=count,
                          topology_assignment=psa.topology_assignment)
        for flavor_name in psa.flavors.values():
            flavor = flavors.get(flavor_name)
            if flavor is None:
                continue
            info.node_selector.update(flavor.node_labels)
            info.tolerations.extend(
                t for t in flavor.tolerations if t not in info.tolerations)
        return info

    @staticmethod
    def from_update(update: dict) -> "PodSetInfo":
        """An admission-check PodSetUpdate (reference podset.go:100)."""
        return PodSetInfo(
            name=update.get("name", ""),
            node_selector=dict(update.get("nodeSelector", {})),
            labels=dict(update.get("labels", {})),
            annotations=dict(update.get("annotations", {})),
            tolerations=list(update.get("tolerations", [])))

    def merge(self, other: "PodSetInfo") -> None:
        """reference podset.go:152 Merge — conflicting keys are an error."""
        for k, v in other.labels.items():
            if self.labels.get(k, v) != v:
                raise BadPodSetsUpdateError(f"conflicting label {k}")
            self.labels[k] = v
        for k, v in other.annotations.items():
            if self.annotations.get(k, v) != v:
                raise BadPodSetsUpdateError(f"conflicting annotation {k}")
            self.annotations[k] = v
        for k, v in other.node_selector.items():
            if self.node_selector.get(k, v) != v:
                raise BadPodSetsUpdateError(f"conflicting nodeSelector {k}")
            self.node_selector[k] = v
        self.tolerations.extend(
            t for t in other.tolerations if t not in self.tolerations)


def merge_podset_infos(base: list[PodSetInfo],
                       updates: list[PodSetInfo]) -> list[PodSetInfo]:
    """Merge admission-check updates into assignment infos by name."""
    by_name = {u.name: u for u in updates}
    for info in base:
        u = by_name.get(info.name)
        if u is not None:
            info.merge(u)
    return base


def podset_infos_from_admission(
        pod_sets: list[PodSet], assignments: list[PodSetAssignment],
        flavors: dict[str, ResourceFlavor]) -> list[PodSetInfo]:
    counts = {ps.name: ps.count for ps in pod_sets}
    return [PodSetInfo.from_assignment(
                psa, psa.count or counts.get(psa.name, 0), flavors)
            for psa in assignments]
