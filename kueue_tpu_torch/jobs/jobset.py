"""JobSet integration (reference pkg/controller/jobs/jobset, 522 LoC).

A JobSet is a list of replicated jobs; each replicated job contributes
one PodSet with count = replicas × parallelism.  Suspend/resume toggles
the whole set; success requires every replicated job to succeed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..jobframework.interface import (
    IntegrationCallbacks,
    JobWithReclaimablePods,
    register_integration,
)
from .base import PodTemplate, TemplateJob


@dataclass
class ReplicatedJobSpec:
    name: str
    replicas: int = 1
    parallelism: int = 1
    requests: dict[str, int] = field(default_factory=dict)
    topology_request: object = None


class JobSet(TemplateJob, JobWithReclaimablePods):
    kind = "JobSet"
    STATUS_FIELDS = ("succeeded", "failed_message")

    def __init__(self, name: str, replicated_jobs: list[ReplicatedJobSpec],
                 **kw):
        templates = [
            PodTemplate(name=rj.name, count=rj.replicas * rj.parallelism,
                        requests=dict(rj.requests),
                        topology_request=rj.topology_request)
            for rj in replicated_jobs]
        super().__init__(name, templates=templates, **kw)
        self.replicated_jobs = list(replicated_jobs)
        self.succeeded: dict[str, int] = {}   # replicated-job name → pods done
        self.failed_message: Optional[str] = None

    def complete_replicated_job(self, name: str) -> None:
        for rj in self.replicated_jobs:
            if rj.name == name:
                self.succeeded[name] = rj.replicas * rj.parallelism

    def fail(self, message: str = "JobSet failed") -> None:
        self.failed_message = message

    def finished(self) -> tuple[str, bool, bool]:
        if self.failed_message is not None:
            return self.failed_message, False, True
        total = {rj.name: rj.replicas * rj.parallelism
                 for rj in self.replicated_jobs}
        if all(self.succeeded.get(n, 0) >= c for n, c in total.items()):
            return "JobSet finished successfully", True, True
        return "", False, False

    def reclaimable_pods(self) -> dict[str, int]:
        return {n: c for n, c in self.succeeded.items() if c > 0}

    def validate_on_create(self) -> list[str]:
        """jobset_webhook.go rules: replicated-job names must be unique
        and each must request at least one pod."""
        errors = []
        seen: set[str] = set()
        for i, rj in enumerate(self.replicated_jobs):
            path = f"spec.replicatedJobs[{i}]"
            if rj.name in seen:
                errors.append(f"{path}.name: duplicate replicated job "
                              f"{rj.name!r}")
            seen.add(rj.name)
            if rj.replicas < 1:
                errors.append(f"{path}.replicas: should be >= 1")
            if rj.parallelism < 1:
                errors.append(
                    f"{path}.template.spec.parallelism: should be >= 1")
        return errors


register_integration(IntegrationCallbacks(
    name="jobset.x-k8s.io/jobset", gvk=JobSet.kind, new_job=JobSet))
