"""Pod and pod-group integration (reference pkg/controller/jobs/pod).

A plain Pod is gated with a scheduling gate instead of a suspend flag
(pods can't be suspended); a PodGroup is a ComposableJob building one
Workload from N pods that share the group name/total-count annotations
(reference pod/constants/constants.go:27-33), ungated together on
admission.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..api.types import PodSet, Workload
from ..webhooks.validation import valid_dns1123_label
from ..jobframework.interface import (
    ComposableJob,
    GenericJob,
    IntegrationCallbacks,
    register_integration,
    workload_name_for_job,
)
from ..podset import PodSetInfo

SCHEDULING_GATE = "kueue.x-k8s.io/admission"
GROUP_NAME_LABEL = "kueue.x-k8s.io/pod-group-name"
GROUP_TOTAL_COUNT_ANNOTATION = "kueue.x-k8s.io/pod-group-total-count"
ROLE_HASH_ANNOTATION = "kueue.x-k8s.io/role-hash"
MANAGED_LABEL = "kueue.x-k8s.io/managed"
RETRIABLE_IN_GROUP_ANNOTATION = "kueue.x-k8s.io/retriable-in-group"


@dataclass
class Pod:
    """A bare pod object."""
    name: str
    namespace: str = "default"
    requests: dict[str, int] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    scheduling_gates: list[str] = field(default_factory=lambda: [SCHEDULING_GATE])
    phase: str = "Pending"    # Pending | Running | Succeeded | Failed

    @property
    def gated(self) -> bool:
        return SCHEDULING_GATE in self.scheduling_gates

    def ungate(self) -> None:
        if SCHEDULING_GATE in self.scheduling_gates:
            self.scheduling_gates.remove(SCHEDULING_GATE)
            self.phase = "Running"

    def gate(self) -> None:
        if SCHEDULING_GATE not in self.scheduling_gates:
            self.scheduling_gates.append(SCHEDULING_GATE)
        self.phase = "Pending"

    @property
    def role_hash(self) -> str:
        import hashlib
        key = (tuple(sorted(self.requests.items())),
               tuple(sorted(self.node_selector.items())))
        return hashlib.sha256(repr(key).encode()).hexdigest()[:8]


def default_pod(pod: Pod, queue: str = "") -> None:
    """Pod webhook Default(): inject the scheduling gate, the managed
    label, and — for group members — the role-hash annotation
    (reference pod_webhook.go Default)."""
    if pod.phase == "Pending" and SCHEDULING_GATE not in pod.scheduling_gates:
        pod.scheduling_gates.append(SCHEDULING_GATE)
    pod.labels.setdefault(MANAGED_LABEL, "true")
    if queue:
        pod.labels.setdefault("kueue.x-k8s.io/queue-name", queue)
    if pod.labels.get(GROUP_NAME_LABEL):
        pod.annotations.setdefault(ROLE_HASH_ANNOTATION, pod.role_hash)


def validate_pod_create(pod: Pod) -> list[str]:
    """Pod webhook ValidateCreate (reference pod_webhook.go:274-339):
    managed-label value, group-metadata pairing, total-count syntax."""
    errors: list[str] = []
    managed = pod.labels.get(MANAGED_LABEL)
    if managed is not None and managed != "true":
        errors.append(
            f"metadata.labels[{MANAGED_LABEL}]: "
            "managed label value can only be 'true'")
    group = pod.labels.get(GROUP_NAME_LABEL, "")
    gtc = pod.annotations.get(GROUP_TOTAL_COUNT_ANNOTATION)
    if not group:
        if gtc is not None:
            errors.append(
                f"metadata.labels[{GROUP_NAME_LABEL}]: both the "
                f"'{GROUP_TOTAL_COUNT_ANNOTATION}' annotation and the "
                f"'{GROUP_NAME_LABEL}' label should be set")
    else:
        if not valid_dns1123_label(group):
            errors.append(
                f"metadata.labels[{GROUP_NAME_LABEL}]: {group!r} "
                "must be a DNS-1123 label")
        if gtc is None:
            errors.append(
                f"metadata.annotations[{GROUP_TOTAL_COUNT_ANNOTATION}]: "
                f"both the '{GROUP_TOTAL_COUNT_ANNOTATION}' annotation and "
                f"the '{GROUP_NAME_LABEL}' label should be set")
        else:
            try:
                if int(gtc) < 1:
                    errors.append(
                        f"metadata.annotations"
                        f"[{GROUP_TOTAL_COUNT_ANNOTATION}]: "
                        "should be greater than or equal to 1")
            except ValueError:
                errors.append(
                    f"metadata.annotations[{GROUP_TOTAL_COUNT_ANNOTATION}]: "
                    f"{gtc!r} is not a valid integer")
    retriable = pod.annotations.get(RETRIABLE_IN_GROUP_ANNOTATION)
    if retriable is not None and retriable not in ("true", "false"):
        errors.append(
            f"metadata.annotations[{RETRIABLE_IN_GROUP_ANNOTATION}]: "
            "value can only be 'true' or 'false'")
    return errors


def validate_pod_update(old: Pod, new: Pod) -> list[str]:
    """Pod webhook ValidateUpdate — only the update-specific rules: the
    one-way retriable-in-group transition (pod_webhook.go:341-348) and
    group-name immutability.  Create rules run separately (the generic
    job webhook re-applies them on every update)."""
    errors: list[str] = []
    if new.labels.get(GROUP_NAME_LABEL):
        old_unretriable = old.annotations.get(
            RETRIABLE_IN_GROUP_ANNOTATION) == "false"
        new_unretriable = new.annotations.get(
            RETRIABLE_IN_GROUP_ANNOTATION) == "false"
        if old_unretriable and not new_unretriable:
            errors.append(
                f"metadata.annotations[{RETRIABLE_IN_GROUP_ANNOTATION}]: "
                "unretriable pod group can't be converted to retriable")
    if old.labels.get(GROUP_NAME_LABEL) != new.labels.get(GROUP_NAME_LABEL):
        errors.append(
            f"metadata.labels[{GROUP_NAME_LABEL}]: field is immutable")
    return errors


class PlainPod(GenericJob):
    """A single gated pod (reference pod integration, non-group mode)."""

    kind = "Pod"

    def __init__(self, pod: Pod, queue: str = ""):
        self.pod = pod
        self.queue = queue
        default_pod(pod, queue)

    @property
    def name(self) -> str:
        return self.pod.name

    @property
    def namespace(self) -> str:
        return self.pod.namespace

    @property
    def gvk(self) -> str:
        return self.kind

    def is_suspended(self) -> bool:
        return self.pod.gated

    def suspend(self) -> None:
        # a running pod cannot be re-gated; stopping means deletion in the
        # reference (pod_controller.go Stop) — model as re-gate for replay
        self.pod.gate()

    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        if infos:
            self.pod.node_selector.update(infos[0].node_selector)
        self.pod.ungate()

    def pod_sets(self) -> list[PodSet]:
        return [PodSet(name="main", count=1,
                       requests=dict(self.pod.requests),
                       node_selector=dict(self.pod.node_selector))]

    def finished(self) -> tuple[str, bool, bool]:
        if self.pod.phase == "Succeeded":
            return "Pod succeeded", True, True
        if self.pod.phase == "Failed":
            return "Pod failed", False, True
        return "", False, False

    def validate_on_create(self) -> list[str]:
        return validate_pod_create(self.pod)

    def validate_on_update(self, old: "PlainPod") -> list[str]:
        return validate_pod_update(old.pod, self.pod)

    def is_active(self) -> bool:
        return self.pod.phase == "Running"

    def pods_ready(self) -> bool:
        return self.pod.phase == "Running"


class PodGroup(GenericJob, ComposableJob):
    """N pods forming one gang-admitted workload (reference pod/pod_controller.go
    ComposableJob implementation, the largest integration at 2,107 LoC)."""

    kind = "PodGroup"

    def __init__(self, group_name: str, total_count: int,
                 namespace: str = "default", queue: str = ""):
        self.group_name = group_name
        self.total_count = total_count
        self._namespace = namespace
        self.queue = queue
        self.pods: list[Pod] = []

    # -- membership ----------------------------------------------------

    def add_pod(self, pod: Pod) -> None:
        pod.labels[GROUP_NAME_LABEL] = self.group_name
        pod.annotations[GROUP_TOTAL_COUNT_ANNOTATION] = str(self.total_count)
        default_pod(pod, self.queue)
        self.pods.append(pod)

    def list_members(self) -> list:
        return list(self.pods)

    # -- identity ------------------------------------------------------

    @property
    def name(self) -> str:
        return self.group_name

    @property
    def namespace(self) -> str:
        return self._namespace

    @property
    def gvk(self) -> str:
        return self.kind

    # -- composable workload -------------------------------------------

    def _roles(self) -> list[tuple[str, list[Pod]]]:
        """Group pods by role hash; stable order by first occurrence."""
        roles: dict[str, list[Pod]] = {}
        for p in self.pods:
            roles.setdefault(p.role_hash, []).append(p)
        return list(roles.items())

    def construct_composable_workload(self) -> Workload:
        pod_sets = []
        seen = 0
        roles = self._roles()
        for i, (role, pods) in enumerate(roles):
            count = len(pods)
            if i == len(roles) - 1:
                # the final role absorbs not-yet-created pods so the gang
                # totals the declared group size (expectations pattern,
                # pkg/util/expectations)
                count += self.total_count - len(self.pods)
            seen += count
            pod_sets.append(PodSet(
                name=f"role-{role}", count=count,
                requests=dict(pods[0].requests),
                node_selector=dict(pods[0].node_selector)))
        return Workload(
            name=workload_name_for_job(self.kind, self.group_name),
            namespace=self._namespace, queue_name=self.queue,
            pod_sets=pod_sets)

    # -- gating --------------------------------------------------------

    def is_suspended(self) -> bool:
        return any(p.gated for p in self.pods)

    def suspend(self) -> None:
        for p in self.pods:
            if p.phase not in ("Succeeded", "Failed"):
                p.gate()

    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        by_name = {i.name: i for i in infos}
        for role, pods in self._roles():
            info = by_name.get(f"role-{role}")
            for p in pods:
                if info is not None:
                    p.node_selector.update(info.node_selector)
                p.ungate()

    # -- observation ---------------------------------------------------

    def pod_sets(self) -> list[PodSet]:
        return self.construct_composable_workload().pod_sets

    def finished(self) -> tuple[str, bool, bool]:
        if len(self.pods) < self.total_count:
            return "", False, False
        done = [p for p in self.pods if p.phase in ("Succeeded", "Failed")]
        if len(done) < self.total_count:
            return "", False, False
        success = all(p.phase == "Succeeded" for p in done)
        return ("Pods succeeded" if success else "Some pods failed",
                success, True)

    def is_active(self) -> bool:
        return any(p.phase == "Running" for p in self.pods)

    def pods_ready(self) -> bool:
        running = sum(1 for p in self.pods if p.phase == "Running")
        return running >= self.total_count

    def validate_on_create(self) -> list[str]:
        errors: list[str] = []
        if self.total_count < 1:
            errors.append("pod-group total count: should be >= 1")
        if not valid_dns1123_label(self.group_name):
            errors.append(
                f"pod-group name: {self.group_name!r} must be a "
                "DNS-1123 label")
        for p in self.pods:
            errors.extend(validate_pod_create(p))
            declared = p.annotations.get(GROUP_TOTAL_COUNT_ANNOTATION)
            if declared is not None and declared != str(self.total_count):
                errors.append(
                    f"pod {p.name}: group-total-count annotation "
                    f"{declared!r} disagrees with the group size "
                    f"{self.total_count}")
        if len(self.pods) > self.total_count:
            errors.append(
                f"pod-group {self.group_name}: {len(self.pods)} member "
                f"pods exceed the declared total count {self.total_count}")
        return errors


register_integration(IntegrationCallbacks(
    name="pod", gvk=PlainPod.kind, new_job=PlainPod))
register_integration(IntegrationCallbacks(
    name="pod-group", gvk=PodGroup.kind, new_job=PodGroup,
    depends_on=("pod",)))
