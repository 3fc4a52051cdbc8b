"""Serving-workload integrations (reference pkg/controller/jobs/
{deployment 207, statefulset 463, leaderworkerset 654} LoC).

Serving workloads never "finish"; they hold quota while scaled up.  A
Deployment is admitted pod-by-pod (each replica is its own workload in
the reference — modeled here as a single resizable workload per scale);
a StatefulSet gangs its replicas; a LeaderWorkerSet admits per-group
(leader + workers).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.types import PodSet, Workload
from ..jobframework.interface import (
    ComposableJob,
    IntegrationCallbacks,
    register_integration,
    workload_name_for_job,
)
from .base import PodTemplate, TemplateJob


def _serving_queue_frozen(new, old) -> bool:
    """Shared serving-kind freeze rule ({statefulset,deployment}
    _webhook.go): the queue can move until pods are Ready; removing the
    label is always forbidden."""
    return old.ready_replicas > 0 or not new.queue_name


class StatefulSet(TemplateJob):
    kind = "StatefulSet"

    def __init__(self, name: str, replicas: int,
                 requests: dict[str, int], **kw):
        super().__init__(name, templates=[PodTemplate(
            name="main", count=replicas, requests=dict(requests))], **kw)
        # status mirrors: pods Ready / pods still existing (the webhook
        # consults both, statefulset_webhook.go:140,168)
        self.ready_replicas = 0
        self.status_replicas = 0
        self.deleted = False

    @property
    def replicas(self) -> int:
        """The spec replica count (the template count may be reduced by
        partial admission; _original holds the spec)."""
        return self._original[0].count

    def finished(self) -> tuple[str, bool, bool]:
        if self.deleted:
            return "StatefulSet deleted", True, True
        return "", False, False

    def queue_name_frozen(self, old: "StatefulSet") -> bool:
        return _serving_queue_frozen(self, old)   # statefulset_webhook.go:140

    def validate_on_update(self, old: "StatefulSet") -> list[str]:
        """statefulset_webhook.go:155-171: replicas only scale to/from
        zero (#3279), and not up from zero while the previous
        scale-down is still terminating."""
        errors = []
        if (self.replicas != 0 and old.replicas != 0
                and self.replicas != old.replicas):
            errors.append("spec.replicas: field is immutable "
                          "(only scaling to or from zero is supported)")
        if (old.replicas == 0 and self.replicas > 0
                and old.status_replicas > 0):
            errors.append(
                "spec.replicas: scaling down is still in progress")
        return errors


class Deployment(TemplateJob):
    """Admitted pod-by-pod in the reference (deployment integration);
    each replica is independently gated, so the pod set is resizable
    without re-admission of the whole workload."""

    kind = "Deployment"

    def __init__(self, name: str, replicas: int,
                 requests: dict[str, int], **kw):
        super().__init__(name, templates=[PodTemplate(
            name="main", count=replicas, requests=dict(requests))], **kw)
        self.ready_replicas = 0
        self.deleted = False

    def scale(self, replicas: int) -> None:
        self.templates[0].count = replicas
        self._original[0].count = replicas

    def finished(self) -> tuple[str, bool, bool]:
        if self.deleted:
            return "Deployment deleted", True, True
        return "", False, False

    def queue_name_frozen(self, old: "Deployment") -> bool:
        return _serving_queue_frozen(self, old)   # deployment_webhook.go:131


@dataclass
class LWSGroup:
    index: int
    workers: int
    leader_requests: dict[str, int] = field(default_factory=dict)
    worker_requests: dict[str, int] = field(default_factory=dict)


class LeaderWorkerSet(TemplateJob, ComposableJob):
    """Each group = 1 leader + N workers, gang-admitted per group
    (reference leaderworkerset integration)."""

    kind = "LeaderWorkerSet"

    def __init__(self, name: str, groups: list[LWSGroup], **kw):
        templates = []
        for g in groups:
            templates.append(PodTemplate(
                name=f"group-{g.index}-leader", count=1,
                requests=dict(g.leader_requests)))
            if g.workers:
                templates.append(PodTemplate(
                    name=f"group-{g.index}-workers", count=g.workers,
                    requests=dict(g.worker_requests)))
        super().__init__(name, templates=templates, **kw)
        self.groups = list(groups)
        self.deleted = False

    def construct_composable_workload(self) -> Workload:
        return Workload(
            name=workload_name_for_job(self.kind, self.name),
            namespace=self.namespace, queue_name=self.queue_name,
            pod_sets=[t.to_pod_set() for t in self.templates])

    def list_members(self) -> list:
        return list(self.groups)

    def finished(self) -> tuple[str, bool, bool]:
        if self.deleted:
            return "LeaderWorkerSet deleted", True, True
        return "", False, False


register_integration(IntegrationCallbacks(
    name="statefulset", gvk=StatefulSet.kind, new_job=StatefulSet,
    depends_on=("pod",)))
register_integration(IntegrationCallbacks(
    name="deployment", gvk=Deployment.kind, new_job=Deployment,
    depends_on=("pod",)))
register_integration(IntegrationCallbacks(
    name="leaderworkerset.x-k8s.io/leaderworkerset",
    gvk=LeaderWorkerSet.kind, new_job=LeaderWorkerSet,
    depends_on=("pod",)))
