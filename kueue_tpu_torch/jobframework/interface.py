"""GenericJob SPI and the integration registry.

Capability parity with reference pkg/controller/jobframework/interface.go
(GenericJob :41-65 and its optional sub-interfaces) and
integrationmanager.go (RegisterIntegration :248, ForEachIntegration :260).
"""

from __future__ import annotations

import abc
import enum
import hashlib
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..api.types import PodSet, Workload
from ..podset import PodSetInfo


class StopReason(enum.Enum):
    """reference jobframework/interface.go StopReason."""
    WORKLOAD_DELETED = "WorkloadDeleted"
    WORKLOAD_EVICTED = "WorkloadEvicted"
    NO_MATCHING_WORKLOAD = "NoMatchingWorkload"
    NOT_ADMITTED = "NotAdmitted"


class GenericJob(abc.ABC):
    """reference jobframework/interface.go:41 GenericJob.

    A 'job' is any externally-defined unit of work gated by the framework:
    it can be suspended (held) and resumed with admission-derived pod-set
    info injected.
    """

    # -- identity ------------------------------------------------------

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    def namespace(self) -> str:
        return "default"

    @property
    @abc.abstractmethod
    def gvk(self) -> str:
        """Kind string, e.g. "BatchJob"."""

    @property
    def key(self) -> str:
        return f"{self.gvk}/{self.namespace}/{self.name}"

    @property
    def queue_name(self) -> str:
        return getattr(self, "queue", "")

    @property
    def priority_class_name(self) -> str:
        return ""

    # -- gating --------------------------------------------------------

    @abc.abstractmethod
    def is_suspended(self) -> bool: ...

    @abc.abstractmethod
    def suspend(self) -> None: ...

    @abc.abstractmethod
    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        """Unsuspend, injecting node selectors/tolerations/counts
        (reference interface.go:49 RunWithPodSetsInfo)."""

    def restore_podsets_info(self, infos: Sequence[PodSetInfo]) -> bool:
        """Restore original pod templates on suspension (interface.go:53).
        Returns True if anything changed."""
        return False

    # -- observation ---------------------------------------------------

    @abc.abstractmethod
    def pod_sets(self) -> list[PodSet]:
        """The workload's pod sets (reference interface.go:57)."""

    @abc.abstractmethod
    def finished(self) -> tuple[str, bool, bool]:
        """(message, success, finished) — reference interface.go:55."""

    def is_active(self) -> bool:
        """Any pods are running (reference interface.go:59)."""
        return not self.is_suspended()

    def pods_ready(self) -> bool:
        """All pods running+ready (reference interface.go:61)."""
        return self.is_active()

    def sync_status_from(self, other: "GenericJob") -> None:
        """Copy execution status from a remote copy of this job
        (MultiKueue adapter copy-back, reference workload.go)."""


class JobWithReclaimablePods(abc.ABC):
    """reference interface.go:75."""

    @abc.abstractmethod
    def reclaimable_pods(self) -> dict[str, int]:
        """pod-set name → count of pods no longer needed."""


class JobWithCustomStop(abc.ABC):
    """reference interface.go:89."""

    @abc.abstractmethod
    def stop(self, infos: Sequence[PodSetInfo], reason: StopReason,
             message: str) -> bool: ...


class JobWithManagedBy(abc.ABC):
    """reference interface.go:158 — MultiKueue dispatch support."""

    @abc.abstractmethod
    def managed_by(self) -> Optional[str]: ...

    @abc.abstractmethod
    def set_managed_by(self, manager: Optional[str]) -> None: ...


class ComposableJob(abc.ABC):
    """A job composed from several objects, e.g. a pod group
    (reference interface.go:124)."""

    @abc.abstractmethod
    def construct_composable_workload(self) -> Workload: ...

    @abc.abstractmethod
    def list_members(self) -> list: ...


# ---------------------------------------------------------------------------
# Registry (reference integrationmanager.go)
# ---------------------------------------------------------------------------

@dataclass
class IntegrationCallbacks:
    """reference integrationmanager.go:40."""
    name: str
    gvk: str
    new_job: Callable[..., GenericJob]
    # frameworks that must also be enabled for this one to work
    depends_on: tuple[str, ...] = ()
    add_to_default: bool = True


_registry: dict[str, IntegrationCallbacks] = {}
_by_gvk: dict[str, IntegrationCallbacks] = {}


def register_integration(cb: IntegrationCallbacks) -> None:
    """reference integrationmanager.go:248 RegisterIntegration."""
    if cb.name in _registry:
        raise ValueError(f"integration {cb.name} already registered")
    _registry[cb.name] = cb
    _by_gvk[cb.gvk] = cb


def get_integration(name: str) -> Optional[IntegrationCallbacks]:
    return _registry.get(name) or _by_gvk.get(name)


def for_each_integration(fn: Callable[[IntegrationCallbacks], None],
                         enabled: Optional[set[str]] = None) -> None:
    """reference integrationmanager.go:260 ForEachIntegration."""
    for name in sorted(_registry):
        cb = _registry[name]
        if enabled is None or name in enabled:
            fn(cb)


def workload_name_for_job(gvk: str, job_name: str) -> str:
    """Deterministic workload naming (reference
    jobframework/workload_names.go): kind prefix + job name + short hash,
    bounded to DNS-label length."""
    prefix = gvk.lower()
    base = f"{prefix}-{job_name}"
    digest = hashlib.sha256(base.encode()).hexdigest()[:5]
    if len(base) > 57:
        base = base[:57]
    return f"{base}-{digest}"
