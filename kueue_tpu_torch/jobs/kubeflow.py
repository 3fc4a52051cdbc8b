"""Kubeflow training-operator family + MPIJob (reference
pkg/controller/jobs/kubeflow, 1,165 LoC + mpijob 515 LoC).

All kubeflow kinds share one adapter over replica specs (the reference's
kubeflowjob common adapter): each replica role (Master/Worker/PS/...)
becomes a PodSet.  The reference wires TFJob, PyTorchJob, XGBoostJob,
PaddleJob and JAXJob through this adapter; MPIJob has the same shape with
Launcher/Worker roles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..jobframework.interface import IntegrationCallbacks, register_integration
from .base import PodTemplate, TemplateJob


@dataclass
class ReplicaSpec:
    role: str                 # e.g. "Master", "Worker", "PS", "Launcher"
    replicas: int = 1
    requests: dict[str, int] = field(default_factory=dict)
    topology_request: object = None
    # template.spec.priorityClassName (PriorityClass precedence rule,
    # kubeflowjob_controller.go:150-170)
    priority_class_name: str = ""
    # template.metadata annotations (TAS request validation,
    # mpijob_webhook.go:125 validateTopologyRequest)
    annotations: dict[str, str] = field(default_factory=dict)


@dataclass
class SchedulingPolicy:
    """runPolicy.schedulingPolicy (kubeflow common types)."""
    priority_class: str = ""


@dataclass
class RunPolicy:
    """spec.runPolicy — gang-suspension + scheduling policy."""
    suspend: bool = True
    scheduling_policy: Optional[SchedulingPolicy] = None


@dataclass
class ReplicaStatus:
    """status.replicaStatuses[role] (kubeflow common types)."""
    active: int = 0
    succeeded: int = 0
    failed: int = 0


class KubeflowJob(TemplateJob):
    """Common adapter (reference kubeflowjob.KubeflowJob)."""

    kind = "KubeflowJob"
    STATUS_FIELDS = ("condition", "replica_statuses", "job_running")
    # roles ordered first in the workload's pod sets (reference orders
    # Master before Worker for stable PodSet naming)
    role_order: tuple[str, ...] = ()
    # the kind's replica-specs field (reference ReplicaSpecsFieldName,
    # e.g. tfjob_controller.go:116 "tfReplicaSpecs")
    replica_specs_field: str = "replicaSpecs"

    def __init__(self, name: str, replicas: list[ReplicaSpec],
                 run_policy: Optional[RunPolicy] = None, **kw):
        order = {r: i for i, r in enumerate(self.role_order)}
        replicas = sorted(replicas,
                          key=lambda r: order.get(r.role, len(order)))
        templates = [PodTemplate(name=r.role.lower(), count=r.replicas,
                                 requests=dict(r.requests),
                                 annotations=dict(r.annotations),
                                 topology_request=r.topology_request)
                     for r in replicas]
        super().__init__(name, templates=templates, **kw)
        self.replicas = replicas
        self.run_policy = run_policy or RunPolicy()
        self.suspended = self.run_policy.suspend
        self.condition: Optional[tuple[str, bool]] = None  # (message, success)
        # status mirrors (kubeflow common JobStatus)
        self.replica_statuses: dict[str, ReplicaStatus] = {}
        self.job_running = False        # JobRunning condition

    # -- gang suspension rides runPolicy.suspend (controller.go:48-57) --

    def is_suspended(self) -> bool:
        return self.suspended

    def suspend(self) -> None:
        self.suspended = True
        self.run_policy.suspend = True
        self.started_infos = None

    def run_with_podsets_info(self, infos) -> None:
        super().run_with_podsets_info(infos)
        self.run_policy.suspend = False

    @property
    def priority_class_name(self) -> str:
        """PriorityClass precedence (kubeflowjob_controller.go:150-170,
        mirroring mpi-operator's podgroup rule):
        1. runPolicy.schedulingPolicy.priorityClass
        2. the first ordered replica's template priorityClassName
        3. the next replica's, and so on."""
        sp = self.run_policy.scheduling_policy
        if sp is not None and sp.priority_class:
            return sp.priority_class
        for r in self.replicas:        # already in role order
            if r.priority_class_name:
                return r.priority_class_name
        return self._priority_class

    def mark_succeeded(self, message: str = "") -> None:
        self.condition = (message or f"{self.kind} finished", True)
        self.job_running = False

    def mark_failed(self, message: str = "") -> None:
        self.condition = (message or f"{self.kind} failed", False)
        self.job_running = False

    def mark_running(self, per_role_active: Optional[dict] = None) -> None:
        """JobRunning condition + replicaStatuses (the operator's status
        sync; drives PodsReady and IsActive)."""
        self.job_running = True
        for r in self.replicas:
            active = (per_role_active or {}).get(r.role, r.replicas)
            self.replica_statuses[r.role] = ReplicaStatus(active=active)

    def finished(self) -> tuple[str, bool, bool]:
        if self.condition is None:
            return "", False, False
        message, success = self.condition
        return message, success, True

    def pods_ready(self) -> bool:
        """reference kubeflowjob_controller.go:131 PodsReady: the
        JobRunning condition is True."""
        return self.job_running

    def is_active(self) -> bool:
        """reference kubeflowjob_controller.go:123 IsActive: any replica
        status reports active pods."""
        return any(rs.active for rs in self.replica_statuses.values())

    def validate_on_create(self) -> list[str]:
        """Per-kind replica-spec validation (reference
        kubeflowjob_controller.go:182-196 plus the per-kind webhooks'
        replica-type allowlists): roles must be unique, known to the
        kind, and carry a positive replica count.  TAS annotations on
        each replica are checked by the generic job webhook."""
        errors: list[str] = []
        seen: set[str] = set()
        for r in self.replicas:
            path = f"spec.{self.replica_specs_field}[{r.role}]"
            if r.role in seen:
                errors.append(f"{path}: duplicate replica type")
            seen.add(r.role)
            if self.role_order and r.role not in self.role_order:
                errors.append(
                    f"{path}: unsupported replica type for {self.kind}; "
                    f"must be one of {list(self.role_order)}")
            if r.replicas < 1:
                errors.append(f"{path}.replicas: should be >= 1")
        errors.extend(self.validate_topology_request())
        return errors

    def validate_topology_request(self) -> list[str]:
        """TAS request validation per replica template, errors sorted by
        field path (mpijob_webhook.go:125-135 validateTopologyRequest
        over ValidateTASPodSetRequest)."""
        from ..jobframework.webhook import validate_tas_podset_request
        errors: list[str] = []
        for r in self.replicas:
            meta = (f"spec.{self.replica_specs_field}[{r.role}]"
                    f".template.metadata")
            errors.extend(validate_tas_podset_request(
                meta, r.topology_request))
        return sorted(errors)


class TFJob(KubeflowJob):
    kind = "TFJob"
    role_order = ("Master", "Chief", "PS", "Worker", "Evaluator")
    replica_specs_field = "tfReplicaSpecs"


class PyTorchJob(KubeflowJob):
    kind = "PyTorchJob"
    role_order = ("Master", "Worker")
    replica_specs_field = "pytorchReplicaSpecs"


class XGBoostJob(KubeflowJob):
    kind = "XGBoostJob"
    role_order = ("Master", "Worker")
    replica_specs_field = "xgbReplicaSpecs"


class PaddleJob(KubeflowJob):
    kind = "PaddleJob"
    role_order = ("Master", "Worker")
    replica_specs_field = "paddleReplicaSpecs"


class JAXJob(KubeflowJob):
    kind = "JAXJob"
    role_order = ("Worker",)
    replica_specs_field = "jaxReplicaSpecs"


class MPIJob(KubeflowJob):
    kind = "MPIJob"
    role_order = ("Launcher", "Worker")
    replica_specs_field = "mpiReplicaSpecs"


for _cls, _name in [(TFJob, "kubeflow.org/tfjob"),
                    (PyTorchJob, "kubeflow.org/pytorchjob"),
                    (XGBoostJob, "kubeflow.org/xgboostjob"),
                    (PaddleJob, "kubeflow.org/paddlejob"),
                    (JAXJob, "kubeflow.org/jaxjob"),
                    (MPIJob, "kubeflow.org/mpijob")]:
    register_integration(IntegrationCallbacks(
        name=_name, gvk=_cls.kind, new_job=_cls))
