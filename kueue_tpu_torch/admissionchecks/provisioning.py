"""ProvisioningRequest admission-check controller (reference
pkg/controller/admissionchecks/provisioning, KEP 1136).

For every workload with quota reserved whose CQ carries a provisioning
check, the controller owns one ProvisioningRequest per attempt
(syncOwnedProvisionRequest, controller.go:226), each referencing one
PodTemplate object per podset (``ppt-`` prefix, controller.go:60,
createPodTemplate controller.go:380, re-synced by
syncProvisionRequestsPodTemplates controller.go:420 and GC'd with their
request).  A pluggable capacity backend (the cluster-autoscaler
stand-in) flips request states; the per-condition handling mirrors
controller.go:575-625:

- ``Provisioned`` → the check turns Ready and PodSetUpdates inject the
  consume-provisioning-request annotations (controller.go:659).
- ``Failed`` → retry with exponential backoff up to the config's limit,
  then reject (controller.go:344).
- ``BookingExpired`` → same retry-vs-reject decision, but ONLY while the
  workload is not yet admitted; an admitted workload ignores booking
  expiry (controller.go:253-254,598-614).
- ``CapacityRevoked`` → the check is rejected outright while the
  workload is active, triggering deactivation, because the autoscaled
  nodes are already gone (controller.go:590-597).

With the ``KeepQuotaForProvReqRetry`` gate a retry keeps the check
Pending (quota held) instead of flipping to Retry (controller.go:577).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import features
from ..api.types import (
    AdmissionCheckState,
    ProvisioningRequestConfig,
    Workload,
)

PROVISIONING_CONTROLLER_NAME = "kueue.x-k8s.io/provisioning-request"
POD_TEMPLATES_PREFIX = "ppt"      # controller.go:60
CONSUME_ANNOTATION = \
    "cluster-autoscaler.kubernetes.io/consume-provisioning-request"
CLASS_ANNOTATION = \
    "cluster-autoscaler.kubernetes.io/provisioning-class-name"


@dataclass
class PodTemplateObject:
    """Stand-in for the corev1.PodTemplate the reference creates per
    podset of a ProvisioningRequest (controller.go:380-418)."""
    name: str
    namespace: str
    requests: dict[str, int] = field(default_factory=dict)
    count: int = 0
    node_selector: dict[str, str] = field(default_factory=dict)


@dataclass
class ProvisioningRequest:
    """The autoscaler-facing object (stand-in for autoscaler.x-k8s.io
    ProvisioningRequest)."""
    name: str
    namespace: str
    workload_key: str
    check_name: str
    attempt: int = 1
    provisioning_class: str = ""
    parameters: dict[str, str] = field(default_factory=dict)
    # [{"name", "count", "pod_template_ref"}] — PodTemplateRef per podset
    pod_sets: list = field(default_factory=list)
    state: str = "Pending"        # Pending|Accepted|Provisioned|Failed|
    #                               BookingExpired|CapacityRevoked
    failure_message: str = ""


def request_name(wl_name: str, check: str, attempt: int) -> str:
    """reference provisioning/controller.go ProvisioningRequestName."""
    return f"{wl_name}-{check}-{attempt}"


def pod_template_name(req_name: str, ps_name: str) -> str:
    """reference getProvisioningRequestPodTemplateName."""
    return f"{POD_TEMPLATES_PREFIX}-{req_name}-{ps_name}"


class ProvisioningController:
    """reference provisioning/controller.go Controller."""

    def __init__(self, driver, check_name: str,
                 config: ProvisioningRequestConfig,
                 capacity_backend: Optional[Callable[[ProvisioningRequest], None]] = None):
        self.driver = driver
        self.check_name = check_name
        self.config = config
        self.capacity_backend = capacity_backend
        # both maps are keyed "<namespace>/<object name>" — same-named
        # workloads in different namespaces own distinct objects
        self.requests: dict[str, ProvisioningRequest] = {}
        self.pod_templates: dict[str, PodTemplateObject] = {}
        # wl key → (attempt, not_before_time)
        self.retry_state: dict[str, tuple[int, float]] = {}

    # ------------------------------------------------------------------

    def _relevant(self, wl: Workload) -> bool:
        return (self.check_name in wl.admission_check_states
                and wl.has_quota_reservation and not wl.is_finished)

    def _backoff(self, attempt: int) -> float:
        rs = self.config.retry_strategy
        return min(rs.backoff_base_seconds * (2 ** (attempt - 1)),
                   rs.backoff_max_seconds)

    def reconcile(self) -> None:
        now = self.driver.clock()
        live = set()
        for key, wl in list(self.driver.workloads.items()):
            if not self._relevant(wl):
                continue
            state = wl.admission_check_states[self.check_name].state
            if state == AdmissionCheckState.READY:
                live.add((key, self._attempt(key)))
                # a provisioned booking can still be revoked or expire
                # under an admitted workload (controller.go:590-614)
                rname = request_name(wl.name, self.check_name,
                                     self._attempt(key))
                req = self.requests.get(f"{wl.namespace}/{rname}")
                if req is not None:
                    self._sync_pod_templates(wl, req)
                    if req.state in ("CapacityRevoked", "BookingExpired"):
                        self._sync_check_state(key, wl, req, now)
                continue
            attempt, not_before = self.retry_state.get(key, (1, 0.0))
            if now < not_before:
                continue
            rname = request_name(wl.name, self.check_name, attempt)
            live.add((key, attempt))
            req = self.requests.get(f"{wl.namespace}/{rname}")
            if req is None:
                req = self._create_request(rname, key, wl, attempt)
                if self.capacity_backend is not None:
                    self.capacity_backend(req)
            self._sync_pod_templates(wl, req)
            self._sync_check_state(key, wl, req, now)

        # GC requests + their pod templates once the workload/attempt is
        # gone — including requests superseded by a newer attempt
        # (controller.go GC of owned objects)
        for rkey, req in list(self.requests.items()):
            if (req.workload_key, req.attempt) not in live:
                for ps in req.pod_sets:
                    self.pod_templates.pop(
                        f"{req.namespace}/{ps['pod_template_ref']}", None)
                del self.requests[rkey]

    def _attempt(self, key: str) -> int:
        return self.retry_state.get(key, (1, 0.0))[0]

    # ------------------------------------------------------------------

    def _flavor_node_selector(self, wl: Workload, ps_name: str) -> dict:
        """Merge the assigned flavors' node labels into the template's
        selector (createPodTemplate merging psa.Flavors,
        controller.go:380-418)."""
        selector: dict[str, str] = {}
        if wl.admission is None:
            return selector
        flavors = getattr(self.driver.cache, "resource_flavors", {})
        for psa in wl.admission.pod_set_assignments:
            if psa.name != ps_name:
                continue
            for flavor_name in psa.flavors.values():
                flavor = flavors.get(flavor_name)
                if flavor is not None:
                    selector.update(flavor.node_labels)
        return selector

    def _make_pod_template(self, wl: Workload, ps, ptname: str,
                           count: int) -> None:
        """createPodTemplate (controller.go:380-418): the podset's shape
        plus the assigned flavors' node labels."""
        selector = dict(ps.node_selector)
        selector.update(self._flavor_node_selector(wl, ps.name))
        self.pod_templates[f"{wl.namespace}/{ptname}"] = PodTemplateObject(
            name=ptname, namespace=wl.namespace,
            requests=dict(ps.requests), count=count,
            node_selector=selector)

    def _create_request(self, rname: str, key: str, wl: Workload,
                        attempt: int) -> ProvisioningRequest:
        pod_sets = []
        for ps in wl.pod_sets:
            ptname = pod_template_name(rname, ps.name)
            self._make_pod_template(wl, ps, ptname, ps.count)
            pod_sets.append({"name": ps.name, "count": ps.count,
                             "pod_template_ref": ptname})
        req = ProvisioningRequest(
            name=rname, namespace=wl.namespace, workload_key=key,
            check_name=self.check_name, attempt=attempt,
            provisioning_class=self.config.provisioning_class_name,
            parameters=dict(self.config.parameters),
            pod_sets=pod_sets)
        self.requests[f"{wl.namespace}/{rname}"] = req
        return req

    def _sync_pod_templates(self, wl: Workload,
                            req: ProvisioningRequest) -> None:
        """Recreate any template deleted out from under a live request
        (syncProvisionRequestsPodTemplates, controller.go:420-440)."""
        by_name = {ps.name: ps for ps in wl.pod_sets}
        for entry in req.pod_sets:
            if f"{wl.namespace}/{entry['pod_template_ref']}" \
                    in self.pod_templates:
                continue
            ps = by_name.get(entry["name"])
            if ps is None:
                continue
            self._make_pod_template(wl, ps, entry["pod_template_ref"],
                                    entry["count"])

    # ------------------------------------------------------------------

    def _retry_or_reject(self, key: str, req: ProvisioningRequest,
                         now: float, reason: str) -> None:
        attempt = req.attempt
        limit = self.config.retry_strategy.backoff_limit_count
        if attempt < limit:
            self.retry_state[key] = (attempt + 1,
                                     now + self._backoff(attempt))
            next_state = (AdmissionCheckState.PENDING
                          if features.enabled("KeepQuotaForProvReqRetry")
                          else AdmissionCheckState.RETRY)
            self.driver.set_admission_check_state(
                key, self.check_name, next_state,
                f"Retrying after {reason}: {req.failure_message}")
        else:
            self.driver.set_admission_check_state(
                key, self.check_name, AdmissionCheckState.REJECTED,
                f"{reason}: {req.failure_message}")

    def _sync_check_state(self, key: str, wl: Workload,
                          req: ProvisioningRequest, now: float) -> None:
        if req.state == "Provisioned":
            self._set_ready(key, wl, req)
        elif req.state == "Failed":
            self._retry_or_reject(key, req, now, "Failed")
        elif req.state == "CapacityRevoked":
            # nodes already deleted by the autoscaler: reject to force
            # deactivation so replacement pods don't pend forever
            # (controller.go:590-597)
            if wl.is_active and not wl.is_finished:
                self.driver.set_admission_check_state(
                    key, self.check_name, AdmissionCheckState.REJECTED,
                    f"CapacityRevoked: {req.failure_message}")
        elif req.state == "BookingExpired":
            # an admitted workload keeps running through booking expiry
            # (controller.go:253-254,598-614)
            if not wl.is_admitted:
                self._retry_or_reject(key, req, now, "booking expired")
        # Pending/Accepted → leave the check Pending

    def _set_ready(self, key: str, wl: Workload,
                   req: ProvisioningRequest) -> None:
        """Ready + PodSetUpdates (controller.go:659 podSetUpdates)."""
        updates = []
        if self.config.provisioning_class_name:
            for ps in wl.pod_sets:
                updates.append({
                    "name": ps.name,
                    "annotations": {
                        CONSUME_ANNOTATION: req.name,
                        CLASS_ANNOTATION:
                            self.config.provisioning_class_name,
                    }})
        st = wl.admission_check_states.get(self.check_name)
        if st is not None:
            st.pod_set_updates = updates
        self.driver.set_admission_check_state(
            key, self.check_name, AdmissionCheckState.READY, "Provisioned")
