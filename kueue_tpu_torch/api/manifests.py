"""Kueue-shaped YAML manifest codec.

Parses the reference CRD manifests (apiVersion kueue.x-k8s.io/v1beta1 /
v1alpha1) into our API dataclasses and back, so existing kueue YAML
(examples/admin/*.yaml, user job manifests) drives this framework
unchanged.  Shape parity with apis/kueue/v1beta1/*_types.go.

CPU-family quantities parse to milli-units ("9" → 9000, "500m" → 500);
everything else to absolute integers ("36Gi" → bytes).
"""

from __future__ import annotations

from typing import Any, Optional

from .quantity import format_milli, parse_quantity
from .types import (
    AdmissionCheck,
    BorrowWithinCohort,
    BorrowWithinCohortPolicy,
    ClusterQueue,
    Cohort,
    FairSharing,
    FlavorFungibility,
    FlavorFungibilityPolicy,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    PodSetTopologyRequest,
    PreemptionPolicy,
    QueueingStrategy,
    ReclaimWithinCohort,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    StopPolicy,
    Toleration,
    Topology,
    WithinClusterQueue,
    Workload,
    WorkloadPriorityClass,
)

_MILLI_RESOURCES = {"cpu"}


def _parse_qty(resource: str, value: Any) -> int:
    return parse_quantity(value, milli=resource in _MILLI_RESOURCES)


def _format_qty(resource: str, value: int) -> str:
    if resource in _MILLI_RESOURCES:
        return format_milli(value)
    return str(value)


class ManifestError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def from_manifest(doc: dict):
    """One YAML document → API object (dispatch on kind)."""
    kind = doc.get("kind", "")
    decoder = _DECODERS.get(kind)
    if decoder is None:
        raise ManifestError(f"unsupported kind {kind!r}")
    return decoder(doc)


def load_manifests(text: str) -> list:
    """Parse a (multi-document) YAML string."""
    import yaml
    return [from_manifest(doc)
            for doc in yaml.safe_load_all(text) if doc]


def _meta(doc: dict) -> tuple[str, str]:
    meta = doc.get("metadata") or {}
    return meta.get("name", ""), meta.get("namespace", "default")


def _decode_cluster_queue(doc: dict) -> ClusterQueue:
    name, _ = _meta(doc)
    spec = doc.get("spec") or {}
    groups = []
    for rg in spec.get("resourceGroups", []):
        covered = list(rg.get("coveredResources", []))
        flavors = []
        for f in rg.get("flavors", []):
            resources = {}
            for r in f.get("resources", []):
                rname = r["name"]
                resources[rname] = ResourceQuota(
                    nominal=_parse_qty(rname, r.get("nominalQuota", 0)),
                    borrowing_limit=(
                        _parse_qty(rname, r["borrowingLimit"])
                        if "borrowingLimit" in r else None),
                    lending_limit=(
                        _parse_qty(rname, r["lendingLimit"])
                        if "lendingLimit" in r else None))
            flavors.append(FlavorQuotas(name=f["name"], resources=resources))
        groups.append(ResourceGroup(covered_resources=covered,
                                    flavors=flavors))
    pre = spec.get("preemption") or {}
    bwc = pre.get("borrowWithinCohort") or {}
    ff = spec.get("flavorFungibility") or {}
    fs = spec.get("fairSharing") or {}
    return ClusterQueue(
        name=name,
        cohort=spec.get("cohort") or None,
        queueing_strategy=QueueingStrategy(
            spec.get("queueingStrategy", "BestEffortFIFO")),
        # nil selector matches nothing; {} matches everything
        namespace_selector=(
            spec["namespaceSelector"].get("matchLabels", {})
            if spec.get("namespaceSelector") is not None else None),
        resource_groups=groups,
        preemption=PreemptionPolicy(
            reclaim_within_cohort=ReclaimWithinCohort(
                pre.get("reclaimWithinCohort", "Never")),
            within_cluster_queue=WithinClusterQueue(
                pre.get("withinClusterQueue", "Never")),
            borrow_within_cohort=BorrowWithinCohort(
                policy=BorrowWithinCohortPolicy(
                    bwc.get("policy", "Never")),
                max_priority_threshold=bwc.get("maxPriorityThreshold"))),
        flavor_fungibility=FlavorFungibility(
            when_can_borrow=FlavorFungibilityPolicy(
                ff.get("whenCanBorrow", "Borrow")),
            when_can_preempt=FlavorFungibilityPolicy(
                ff.get("whenCanPreempt", "TryNextFlavor"))),
        admission_checks=list(spec.get("admissionChecks", [])),
        fair_sharing=(FairSharing(weight=fs.get("weight"))
                      if fs else None),
        stop_policy=StopPolicy(spec.get("stopPolicy", "None")),
    )


def _decode_local_queue(doc: dict) -> LocalQueue:
    name, namespace = _meta(doc)
    spec = doc.get("spec") or {}
    return LocalQueue(name=name, namespace=namespace,
                      cluster_queue=spec.get("clusterQueue", ""),
                      stop_policy=StopPolicy(spec.get("stopPolicy", "None")))


def _decode_resource_flavor(doc: dict) -> ResourceFlavor:
    name, _ = _meta(doc)
    spec = doc.get("spec") or {}
    return ResourceFlavor(
        name=name,
        node_labels=dict(spec.get("nodeLabels", {})),
        node_taints=[Taint_from(t) for t in spec.get("nodeTaints", [])],
        tolerations=[_decode_toleration(t)
                     for t in spec.get("tolerations", [])],
        topology_name=spec.get("topologyName", ""))


def Taint_from(t: dict):
    from .types import Taint
    return Taint(key=t.get("key", ""), value=t.get("value", ""),
                 effect=t.get("effect", ""))


def _decode_toleration(t: dict) -> Toleration:
    return Toleration(key=t.get("key", ""),
                      operator=t.get("operator", "Equal"),
                      value=t.get("value", ""),
                      effect=t.get("effect", ""))


def _decode_workload(doc: dict) -> Workload:
    name, namespace = _meta(doc)
    spec = doc.get("spec") or {}
    pod_sets = []
    for ps in spec.get("podSets", []):
        template_spec = ((ps.get("template") or {}).get("spec") or {})
        containers = template_spec.get("containers", [])
        requests: dict[str, int] = {}
        limits: dict[str, int] = {}
        for c in containers:
            resources = c.get("resources") or {}
            c_req = {r: _parse_qty(r, v)
                     for r, v in (resources.get("requests") or {}).items()}
            c_lim = {r: _parse_qty(r, v)
                     for r, v in (resources.get("limits") or {}).items()}
            for rname, v in c_req.items():
                requests[rname] = requests.get(rname, 0) + v
            if len(containers) == 1:
                limits = c_lim
            else:
                # requests<=limits is PER CONTAINER (workload.go
                # RequestsMustNotExceedLimitMessage); the aggregate can't
                # express that, so record only a violating container's
                # limit — the aggregate request is then guaranteed to
                # exceed it and the scheduler rejects, while clean
                # multi-container pods carry no limit entry at all
                for rname, lim in c_lim.items():
                    if c_req.get(rname, 0) > lim:
                        limits[rname] = lim
        tr = ps.get("topologyRequest") or {}
        pod_sets.append(PodSet(
            name=ps.get("name", "main"),
            count=ps.get("count", 1),
            min_count=ps.get("minCount"),
            requests=requests,
            limits=limits,
            node_selector=dict(template_spec.get("nodeSelector", {})),
            tolerations=[_decode_toleration(t)
                         for t in template_spec.get("tolerations", [])],
            topology_request=(PodSetTopologyRequest(
                required=tr.get("required"),
                preferred=tr.get("preferred"),
                unconstrained=bool(tr.get("unconstrained", False)))
                if tr else None)))
    meta = doc.get("metadata") or {}
    wl = Workload(
        name=name, namespace=namespace,
        queue_name=spec.get("queueName", ""),
        priority=spec.get("priority", 0),
        priority_class_name=spec.get("priorityClassName", ""),
        active=spec.get("active", True),
        creation_time=float(meta.get("creationTimestamp") or 0.0),
        pod_sets=pod_sets,
        maximum_execution_time_seconds=spec.get(
            "maximumExecutionTimeSeconds"))
    status = doc.get("status") or {}
    adm = status.get("admission")
    if adm:
        from .types import Admission, PodSetAssignment
        wl.admission = Admission(
            cluster_queue=adm.get("clusterQueue", ""),
            pod_set_assignments=[
                PodSetAssignment(
                    name=a.get("name", ""),
                    count=a.get("count", 0),
                    flavors=dict(a.get("flavors", {})),
                    resource_usage={
                        r: _parse_qty(r, v)
                        for r, v in (a.get("resourceUsage") or {}).items()})
                for a in adm.get("podSetAssignments", [])])
    for c in status.get("conditions", []):
        from .types import Condition, ConditionStatus
        wl.conditions[c["type"]] = Condition(
            type=c["type"],
            status=ConditionStatus(c.get("status", "True")),
            reason=c.get("reason", ""), message=c.get("message", ""),
            last_transition_time=c.get("lastTransitionTime", 0.0))
    return wl


def _decode_cohort(doc: dict) -> Cohort:
    name, _ = _meta(doc)
    spec = doc.get("spec") or {}
    fs = spec.get("fairSharing") or {}
    return Cohort(name=name,
                  parent_name=spec.get("parentName") or spec.get("parent"),
                  fair_sharing=(FairSharing(weight=fs.get("weight"))
                                if fs else None))


def _decode_admission_check(doc: dict) -> AdmissionCheck:
    name, _ = _meta(doc)
    spec = doc.get("spec") or {}
    return AdmissionCheck(name=name,
                          controller_name=spec.get("controllerName", ""),
                          parameters=spec.get("parameters"))


def _decode_priority_class(doc: dict) -> WorkloadPriorityClass:
    name, _ = _meta(doc)
    return WorkloadPriorityClass(name=name, value=doc.get("value", 0),
                                 description=doc.get("description", ""))


def _decode_topology(doc: dict) -> Topology:
    name, _ = _meta(doc)
    spec = doc.get("spec") or {}
    return Topology(name=name,
                    levels=[lv.get("nodeLabel", "")
                            for lv in spec.get("levels", [])])


_DECODERS = {
    "ClusterQueue": _decode_cluster_queue,
    "LocalQueue": _decode_local_queue,
    "ResourceFlavor": _decode_resource_flavor,
    "Workload": _decode_workload,
    "Cohort": _decode_cohort,
    "AdmissionCheck": _decode_admission_check,
    "WorkloadPriorityClass": _decode_priority_class,
    "Topology": _decode_topology,
}


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def to_manifest(obj) -> dict:
    if isinstance(obj, ClusterQueue):
        return _encode_cluster_queue(obj)
    if isinstance(obj, LocalQueue):
        return {"apiVersion": "kueue.x-k8s.io/v1beta1", "kind": "LocalQueue",
                "metadata": {"name": obj.name, "namespace": obj.namespace},
                "spec": {"clusterQueue": obj.cluster_queue}}
    if isinstance(obj, ResourceFlavor):
        return {"apiVersion": "kueue.x-k8s.io/v1beta1",
                "kind": "ResourceFlavor",
                "metadata": {"name": obj.name},
                "spec": {"nodeLabels": dict(obj.node_labels),
                         "topologyName": obj.topology_name or None}}
    if isinstance(obj, Workload):
        return _encode_workload(obj)
    raise ManifestError(f"unsupported object {type(obj).__name__}")


def _encode_cluster_queue(cq: ClusterQueue) -> dict:
    groups = []
    for rg in cq.resource_groups:
        flavors = []
        for f in rg.flavors:
            resources = []
            for rname, q in f.resources.items():
                r: dict[str, Any] = {"name": rname,
                                     "nominalQuota": _format_qty(rname,
                                                                 q.nominal)}
                if q.borrowing_limit is not None:
                    r["borrowingLimit"] = _format_qty(rname, q.borrowing_limit)
                if q.lending_limit is not None:
                    r["lendingLimit"] = _format_qty(rname, q.lending_limit)
                resources.append(r)
            flavors.append({"name": f.name, "resources": resources})
        groups.append({"coveredResources": list(rg.covered_resources),
                       "flavors": flavors})
    return {"apiVersion": "kueue.x-k8s.io/v1beta1", "kind": "ClusterQueue",
            "metadata": {"name": cq.name},
            "spec": {"cohort": cq.cohort,
                     "queueingStrategy": str(cq.queueing_strategy.value),
                     "resourceGroups": groups}}


def _encode_workload(wl: Workload) -> dict:
    pod_sets = []
    for ps in wl.pod_sets:
        pod_sets.append({
            "name": ps.name, "count": ps.count,
            **({"minCount": ps.min_count} if ps.min_count else {}),
            "template": {"spec": {
                "containers": [{"name": "main", "resources": {
                    "requests": {
                        r: _format_qty(r, v) for r, v in ps.requests.items()
                        if r != "pods"},
                    **({"limits": {r: _format_qty(r, v)
                                   for r, v in ps.limits.items()}}
                       if ps.limits else {})}}],
                **({"nodeSelector": dict(ps.node_selector)}
                   if ps.node_selector else {}),
            }}})
    status: dict[str, Any] = {}
    if wl.admission is not None:
        status["admission"] = {
            "clusterQueue": wl.admission.cluster_queue,
            "podSetAssignments": [
                {"name": a.name, "count": a.count,
                 "flavors": dict(a.flavors),
                 "resourceUsage": {r: _format_qty(r, v)
                                   for r, v in a.resource_usage.items()}}
                for a in wl.admission.pod_set_assignments]}
    if wl.conditions:
        status["conditions"] = [
            {"type": c.type, "status": str(c.status.value),
             "reason": c.reason, "message": c.message,
             "lastTransitionTime": c.last_transition_time}
            for c in wl.conditions.values()]
    return {"apiVersion": "kueue.x-k8s.io/v1beta1", "kind": "Workload",
            "metadata": {"name": wl.name, "namespace": wl.namespace,
                         # creation order must survive transport: a
                         # worker rebuilt from journaled manifests has
                         # no other source for the FIFO key
                         **({"creationTimestamp": wl.creation_time}
                            if wl.creation_time else {})},
            "spec": {"queueName": wl.queue_name, "priority": wl.priority,
                     "active": wl.active, "podSets": pod_sets},
            **({"status": status} if status else {})}
