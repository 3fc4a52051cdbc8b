"""Job-level admission webhooks: defaulting + validation.

Mirrors the reference's jobframework validation layer
(pkg/controller/jobframework/validation.go:65-170, tas_validation.go:29-74)
and the per-kind webhooks built on it (pod_webhook.go:228-356,
kubeflowjob_controller.go:182-200).  Library-form, like
``kueue_tpu.webhooks.validation``: callers invoke
``validate_job_create`` / ``validate_job_update`` before handing a job
to the ``JobManager``; the manager also runs them on ``upsert``.
"""

from __future__ import annotations

import re
from typing import Optional

from ..webhooks.validation import ValidationError, valid_dns1123_subdomain
from .interface import GenericJob

MANAGED_LABEL = "kueue.x-k8s.io/managed"          # constants.go:45
MANAGED_LABEL_VALUE = "true"
RETRIABLE_IN_GROUP_ANNOTATION = "kueue.x-k8s.io/retriable-in-group"
PREBUILT_WORKLOAD_LABEL = "kueue.x-k8s.io/prebuilt-workload-name"

_LABEL_NAME = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")


def _valid_label_name(value: str) -> bool:
    """A qualified label name: optional DNS-subdomain prefix + name part
    (metavalidation.ValidateLabelName)."""
    if not value:
        return False
    if "/" in value:
        prefix, _, name = value.partition("/")
        if not valid_dns1123_subdomain(prefix):
            return False
    else:
        name = value
    return len(name) <= 63 and bool(_LABEL_NAME.match(name))


def validate_tas_podset_request(path: str, topology_request) -> list[str]:
    """At most one topology annotation per podset, each a valid label
    name (reference tas_validation.go:29-74)."""
    errors: list[str] = []
    if topology_request is None:
        return errors
    found = [bool(topology_request.required),
             bool(topology_request.preferred),
             bool(topology_request.unconstrained)]
    if sum(found) > 1:
        errors.append(
            f"{path}: must not contain more than one topology annotation "
            "(required / preferred / unconstrained)")
    for kind, value in (
            ("required", topology_request.required),
            ("preferred", topology_request.preferred),
            ("slice-required",
             getattr(topology_request, "slice_required_topology", None))):
        if value and not _valid_label_name(value):
            errors.append(
                f"{path}.{kind}-topology: {value!r} is not a valid label name")
    slice_size = getattr(topology_request, "slice_size", None)
    if slice_size is not None and slice_size <= 0:
        errors.append(f"{path}.slice-size: must be greater than 0")
    return errors


def _job_errors_create(job: GenericJob) -> list[str]:
    """ValidateJobOnCreate (validation.go:65-71) + TAS podset checks."""
    errors: list[str] = []
    queue = job.queue_name
    if queue and not valid_dns1123_subdomain(queue):
        errors.append(
            f"metadata.labels[kueue.x-k8s.io/queue-name]: {queue!r} "
            "must be a DNS-1123 subdomain")
    max_exec = getattr(job, "maximum_execution_time_seconds", None)
    if max_exec is not None and max_exec <= 0:
        errors.append(
            "metadata.labels[kueue.x-k8s.io/max-exec-time-seconds]: "
            "should be greater than 0")
    for ps in job.pod_sets():
        if ps.count < 0:
            errors.append(f"podSets[{ps.name}].count: must be >= 0")
        errors.extend(validate_tas_podset_request(
            f"podSets[{ps.name}]", ps.topology_request))
    # per-kind hook (KubeflowJob.ValidateOnCreate analog)
    hook = getattr(job, "validate_on_create", None)
    if hook is not None:
        errors.extend(hook())
    return errors


def validate_job_create(job: GenericJob) -> None:
    errors = _job_errors_create(job)
    if errors:
        raise ValidationError(errors)


def validate_job_update(old: GenericJob, new: GenericJob) -> None:
    """ValidateJobOnUpdate (validation.go:73-79): queue name and
    prebuilt workload are immutable while unsuspended; the workload
    priority class is always immutable; max-exec-time is immutable
    unless both versions are suspended."""
    errors = _job_errors_create(new)
    if new.queue_name != old.queue_name:
        # serving kinds freeze the queue on their own condition (e.g.
        # StatefulSet: once pods are Ready, statefulset_webhook.go:140)
        frozen = getattr(new, "queue_name_frozen", None)
        if (frozen(old) if frozen is not None
                else not new.is_suspended()):
            errors.append(
                "metadata.labels[kueue.x-k8s.io/queue-name]: "
                "field is immutable")
    if not new.is_suspended():
        old_pb = getattr(old, "prebuilt_workload", None)
        if getattr(new, "prebuilt_workload", None) != old_pb:
            errors.append(
                f"metadata.labels[{PREBUILT_WORKLOAD_LABEL}]: "
                "field is immutable while the job is not suspended")
    if new.priority_class_name != old.priority_class_name:
        errors.append(
            "metadata.labels[kueue.x-k8s.io/priority-class]: "
            "field is immutable")
    if not (new.is_suspended() and old.is_suspended()):
        new_met = getattr(new, "maximum_execution_time_seconds", None)
        old_met = getattr(old, "maximum_execution_time_seconds", None)
        if new_met != old_met:
            errors.append(
                "metadata.labels[kueue.x-k8s.io/max-exec-time-seconds]: "
                "field is immutable")
    hook = getattr(new, "validate_on_update", None)
    if hook is not None:
        errors.extend(hook(old))
    if errors:
        raise ValidationError(errors)
