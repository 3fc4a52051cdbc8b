"""Shared machinery for the concrete integrations.

``TemplateJob`` keeps a mutable pod-template overlay (node selectors,
tolerations, counts) that admission injects and suspension restores —
the equivalent of the reference integrations mutating the job's pod
template in RunWithPodSetsInfo / RestorePodSetsInfo.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..api.types import PodSet, Toleration
from ..jobframework.interface import GenericJob, JobWithManagedBy
from ..podset import PodSetInfo


@dataclass
class PodTemplate:
    """A pod template for one role of a job."""
    name: str = "main"
    count: int = 1
    requests: dict[str, int] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    topology_request: object = None

    def to_pod_set(self, count: Optional[int] = None) -> PodSet:
        return PodSet(
            name=self.name, count=count if count is not None else self.count,
            requests=dict(self.requests),
            node_selector=dict(self.node_selector),
            tolerations=list(self.tolerations),
            topology_request=self.topology_request)


class TemplateJob(GenericJob, JobWithManagedBy):
    """Base for template-driven integrations: suspend flag + overlay."""

    kind = "TemplateJob"
    # execution-status fields mirrored back from a remote copy
    # (MultiKueue adapter copy-back)
    STATUS_FIELDS: tuple[str, ...] = ()

    def __init__(self, name: str, namespace: str = "default",
                 queue: str = "", templates: Sequence[PodTemplate] = (),
                 priority_class: str = "", managed_by: Optional[str] = None):
        self._name = name
        self._namespace = namespace
        self.queue = queue
        self._priority_class = priority_class
        self.templates = list(templates)
        self.suspended = True
        self.started_infos: Optional[list[PodSetInfo]] = None
        self._managed_by = managed_by
        self._original: list[PodTemplate] = [
            dataclasses.replace(t,
                                requests=dict(t.requests),
                                node_selector=dict(t.node_selector),
                                tolerations=list(t.tolerations),
                                labels=dict(t.labels),
                                annotations=dict(t.annotations))
            for t in self.templates]

    # -- identity ------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def namespace(self) -> str:
        return self._namespace

    @property
    def gvk(self) -> str:
        return self.kind

    @property
    def priority_class_name(self) -> str:
        return self._priority_class

    # -- managed-by (MultiKueue) ---------------------------------------

    def managed_by(self) -> Optional[str]:
        return self._managed_by

    def set_managed_by(self, manager: Optional[str]) -> None:
        self._managed_by = manager

    # -- gating --------------------------------------------------------

    def is_suspended(self) -> bool:
        return self.suspended

    def suspend(self) -> None:
        self.suspended = True
        self.started_infos = None

    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        by_name = {i.name: i for i in infos}
        for t in self.templates:
            info = by_name.get(t.name)
            if info is None:
                continue
            t.node_selector.update(info.node_selector)
            t.labels.update(info.labels)
            t.annotations.update(info.annotations)
            t.tolerations.extend(
                tol for tol in info.tolerations if tol not in t.tolerations)
            if info.count:
                t.count = info.count      # partial admission (KEP 420)
        self.suspended = False
        self.started_infos = list(infos)

    def restore_podsets_info(self, infos: Sequence[PodSetInfo]) -> bool:
        changed = False
        for t, orig in zip(self.templates, self._original):
            if (t.node_selector != orig.node_selector
                    or t.count != orig.count
                    or t.tolerations != orig.tolerations
                    or t.labels != orig.labels
                    or t.annotations != orig.annotations):
                t.node_selector = dict(orig.node_selector)
                t.tolerations = list(orig.tolerations)
                t.labels = dict(orig.labels)
                t.annotations = dict(orig.annotations)
                t.count = orig.count
                changed = True
        return changed

    # -- observation ---------------------------------------------------

    def pod_sets(self) -> list[PodSet]:
        return [t.to_pod_set() for t in self.templates]

    def finished(self) -> tuple[str, bool, bool]:
        return "", False, False

    def sync_status_from(self, other: "TemplateJob") -> None:
        for field_name in self.STATUS_FIELDS:
            setattr(self, field_name, getattr(other, field_name))
