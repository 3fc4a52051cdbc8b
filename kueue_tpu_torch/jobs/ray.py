"""RayJob / RayCluster integrations (reference pkg/controller/jobs/rayjob
623 LoC, raycluster 531 LoC).

A Ray cluster contributes one PodSet for the head plus one per worker
group (count = replicas × numOfHosts — multi-host TPU worker groups,
rayjob_controller.go:135-153); a RayJob in K8sJobMode adds a submitter
pod set (:155-168).  A RayJob finishes with the job's terminal status; a
RayCluster is a long-running service that only finishes on deletion.
Webhook rules follow rayjob_webhook.go:100-143: shutdownAfterJobFinishes
must be set, no pre-existing cluster, no in-tree autoscaling, at most 7
worker groups (8 pod sets with the head), and "head" is a reserved
group name.  One deliberate tightening: in K8sJobMode the submitter pod
set also consumes a slot, so the cap drops to 6 — the reference webhook
allows 7 there (rayjob_webhook.go:123 ignores submission mode) and then
rejects the 9-pod-set Workload at the workload webhook instead; we fail
at job admission where the user can see it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..jobframework.interface import IntegrationCallbacks, register_integration
from .base import PodTemplate, TemplateJob

HEAD_GROUP = "head"
SUBMITTER = "submitter"
MAX_WORKER_GROUPS = 7          # 8 pod sets minus the head
SUBMISSION_MODES = ("K8sJobMode", "HTTPMode", "InteractiveMode")


@dataclass
class WorkerGroupSpec:
    name: str
    replicas: int = 1
    requests: dict[str, int] = field(default_factory=dict)
    num_of_hosts: int = 1
    topology_request: object = None


def _cluster_templates(head_requests: dict[str, int],
                       worker_groups: list[WorkerGroupSpec],
                       head_topology=None) -> list[PodTemplate]:
    templates = [PodTemplate(name=HEAD_GROUP, count=1,
                             requests=dict(head_requests),
                             topology_request=head_topology)]
    templates += [
        PodTemplate(name=wg.name,
                    count=wg.replicas * max(1, wg.num_of_hosts),
                    requests=dict(wg.requests),
                    topology_request=wg.topology_request)
        for wg in worker_groups]
    return templates


def _validate_cluster(worker_groups, autoscaling, path,
                      reserved=(HEAD_GROUP,),
                      max_groups=MAX_WORKER_GROUPS) -> list[str]:
    errors = []
    if autoscaling:
        errors.append(
            f"{path}.enableInTreeAutoscaling: a kueue managed job "
            "should not use autoscaling")
    if len(worker_groups) > max_groups:
        errors.append(
            f"{path}.workerGroupSpecs: too many worker groups "
            f"({len(worker_groups)} > {max_groups})")
    seen: set[str] = set()
    for i, wg in enumerate(worker_groups):
        if wg.name in reserved:
            errors.append(
                f"{path}.workerGroupSpecs[{i}].groupName: "
                f"{wg.name!r} is reserved for the "
                f"{'head group' if wg.name == HEAD_GROUP else 'submitter pod'}")
        if wg.name in seen:
            errors.append(
                f"{path}.workerGroupSpecs[{i}].groupName: duplicate "
                f"group name {wg.name!r}")
        seen.add(wg.name)
    return errors


class RayJob(TemplateJob):
    kind = "RayJob"
    STATUS_FIELDS = ("job_status",)

    def __init__(self, name: str, head_requests: dict[str, int],
                 worker_groups: list[WorkerGroupSpec],
                 submission_mode: str = "K8sJobMode",
                 submitter_requests: Optional[dict[str, int]] = None,
                 shutdown_after_job_finishes: bool = True,
                 cluster_selector: Optional[dict[str, str]] = None,
                 enable_in_tree_autoscaling: bool = False,
                 head_topology=None, **kw):
        templates = _cluster_templates(head_requests, worker_groups,
                                       head_topology)
        if submission_mode == "K8sJobMode":
            # the job-submission pod competes for quota too
            # (rayjob_controller.go:155-168)
            # reference default submitter shape: 500m cpu + 200Mi memory
            # (rayjob_controller.go getSubmitterTemplate; memory is in
            # bytes in the canonical units, api/quantity.py)
            templates.append(PodTemplate(
                name=SUBMITTER, count=1,
                requests=dict(submitter_requests
                              or {"cpu": 500, "memory": 200 << 20})))
        super().__init__(name, templates=templates, **kw)
        self.worker_groups = list(worker_groups)
        self.submission_mode = submission_mode
        self.shutdown_after_job_finishes = shutdown_after_job_finishes
        self.cluster_selector = dict(cluster_selector or {})
        self.enable_in_tree_autoscaling = enable_in_tree_autoscaling
        self.job_status: Optional[str] = None   # SUCCEEDED | FAILED

    def mark_status(self, status: str) -> None:
        self.job_status = status

    def finished(self) -> tuple[str, bool, bool]:
        if self.job_status == "SUCCEEDED":
            return "RayJob succeeded", True, True
        if self.job_status == "FAILED":
            return "RayJob failed", False, True
        return "", False, False

    def validate_on_create(self) -> list[str]:
        errors = []
        if self.submission_mode not in SUBMISSION_MODES:
            errors.append(
                f"spec.submissionMode: {self.submission_mode!r} is not "
                f"one of {list(SUBMISSION_MODES)}")
        if not self.shutdown_after_job_finishes:
            errors.append(
                "spec.shutdownAfterJobFinishes: a kueue managed job "
                "should delete the cluster after finishing")
        if self.cluster_selector:
            errors.append(
                "spec.clusterSelector: a kueue managed job should not "
                "use an existing cluster")
        # the submitter pod set consumes one of the 8 pod-set slots and
        # reserves its name
        k8s_mode = self.submission_mode == "K8sJobMode"
        errors.extend(_validate_cluster(
            self.worker_groups, self.enable_in_tree_autoscaling,
            "spec.rayClusterSpec",
            reserved=(HEAD_GROUP, SUBMITTER) if k8s_mode else (HEAD_GROUP,),
            max_groups=MAX_WORKER_GROUPS - (1 if k8s_mode else 0)))
        return errors


class RayCluster(TemplateJob):
    """A serving-style cluster: admitted while it exists."""

    kind = "RayCluster"
    STATUS_FIELDS = ("deleted",)

    def __init__(self, name: str, head_requests: dict[str, int],
                 worker_groups: list[WorkerGroupSpec],
                 enable_in_tree_autoscaling: bool = False,
                 head_topology=None, **kw):
        super().__init__(name, templates=_cluster_templates(
            head_requests, worker_groups, head_topology), **kw)
        self.worker_groups = list(worker_groups)
        self.enable_in_tree_autoscaling = enable_in_tree_autoscaling
        self.deleted = False

    def finished(self) -> tuple[str, bool, bool]:
        if self.deleted:
            return "RayCluster deleted", True, True
        return "", False, False

    def validate_on_create(self) -> list[str]:
        return _validate_cluster(
            self.worker_groups, self.enable_in_tree_autoscaling, "spec")


register_integration(IntegrationCallbacks(
    name="ray.io/rayjob", gvk=RayJob.kind, new_job=RayJob))
register_integration(IntegrationCallbacks(
    name="ray.io/raycluster", gvk=RayCluster.kind, new_job=RayCluster))
