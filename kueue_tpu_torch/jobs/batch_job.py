"""batch/v1 Job integration (reference pkg/controller/jobs/job).

Suspend-based gating, partial admission by scaling parallelism (the
reference syncs the original parallelism via an annotation,
job_controller.go), reclaimable pods from the succeeded count (KEP 78),
and a MultiKueue adapter surface via JobWithManagedBy.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..api.types import PodSet
from ..jobframework.interface import (
    IntegrationCallbacks,
    JobWithReclaimablePods,
    register_integration,
)
from ..podset import PodSetInfo
from .base import PodTemplate, TemplateJob


class BatchJob(TemplateJob, JobWithReclaimablePods):
    kind = "BatchJob"
    STATUS_FIELDS = ("succeeded", "failed_message", "parallelism")

    def __init__(self, name: str, parallelism: int = 1,
                 completions: Optional[int] = None,
                 min_parallelism: Optional[int] = None,
                 requests: Optional[dict[str, int]] = None, **kw):
        template = PodTemplate(name="main", count=parallelism,
                               requests=dict(requests or {}))
        super().__init__(name, templates=[template], **kw)
        self.parallelism = parallelism
        self.completions = completions if completions is not None else parallelism
        self.min_parallelism = min_parallelism  # partial admission floor
        self.succeeded = 0
        self.failed_message: Optional[str] = None

    # -- pod sets ------------------------------------------------------

    def pod_sets(self) -> list[PodSet]:
        ps = self.templates[0].to_pod_set()
        if self.min_parallelism is not None:
            ps.min_count = self.min_parallelism
        return [ps]

    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        super().run_with_podsets_info(infos)
        if infos and infos[0].count:
            # partial admission scales parallelism (reference job
            # integration syncs via annotation)
            self.parallelism = infos[0].count

    def restore_podsets_info(self, infos: Sequence[PodSetInfo]) -> bool:
        changed = super().restore_podsets_info(infos)
        if self.parallelism != self._original[0].count:
            self.parallelism = self._original[0].count
            changed = True
        return changed

    # -- execution-side events -----------------------------------------

    def complete_pods(self, n: int = 1) -> None:
        self.succeeded = min(self.completions, self.succeeded + n)

    def fail(self, message: str = "BackoffLimitExceeded") -> None:
        self.failed_message = message

    # -- observation ---------------------------------------------------

    def finished(self) -> tuple[str, bool, bool]:
        if self.failed_message is not None:
            return self.failed_message, False, True
        if self.succeeded >= self.completions:
            return "Job finished successfully", True, True
        return "", False, False

    def pods_ready(self) -> bool:
        return not self.suspended

    def reclaimable_pods(self) -> dict[str, int]:
        """Pods that succeeded no longer need quota (KEP 78)."""
        remaining = self.completions - self.succeeded
        if remaining >= self.parallelism:
            return {}
        return {"main": self.parallelism - remaining}


register_integration(IntegrationCallbacks(
    name="batch/job", gvk=BatchJob.kind, new_job=BatchJob))
