"""The Configuration file format, defaulting and validation.

Capability parity with reference apis/config/v1beta1/configuration_types.go
(Configuration :31, WaitForPodsReady :216, Integrations :351, Resources
:418, FairSharing :452, MultiKueue :248) plus pkg/config/config.go:156
Load and pkg/config/validation.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..features import DEFAULT_FEATURE_GATES

DEFAULT_NAMESPACE = "kueue-system"
DEFAULT_REQUEUING_BACKOFF_BASE_SECONDS = 60
DEFAULT_REQUEUING_BACKOFF_MAX_SECONDS = 3600
DEFAULT_MULTIKUEUE_GC_INTERVAL_SECONDS = 60.0
DEFAULT_MULTIKUEUE_ORIGIN = "multikueue"
DEFAULT_MULTIKUEUE_WORKER_LOST_TIMEOUT_SECONDS = 15 * 60.0

KNOWN_FRAMEWORKS = (
    "batch/job", "pod", "pod-group", "jobset.x-k8s.io/jobset",
    "kubeflow.org/tfjob", "kubeflow.org/pytorchjob",
    "kubeflow.org/xgboostjob", "kubeflow.org/paddlejob",
    "kubeflow.org/jaxjob", "kubeflow.org/mpijob",
    "ray.io/rayjob", "ray.io/raycluster",
    "workload.codeflare.dev/appwrapper",
    "leaderworkerset.x-k8s.io/leaderworkerset",
    "statefulset", "deployment",
)

PREEMPTION_STRATEGIES = ("LessThanOrEqualToFinalShare", "LessThanInitialShare")


class ConfigValidationError(ValueError):
    def __init__(self, errors: list[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


@dataclass
class RequeuingStrategy:
    """configuration_types.go:270."""
    timestamp: str = "Eviction"          # Eviction | Creation
    backoff_limit_count: Optional[int] = None
    backoff_base_seconds: int = DEFAULT_REQUEUING_BACKOFF_BASE_SECONDS
    backoff_max_seconds: int = DEFAULT_REQUEUING_BACKOFF_MAX_SECONDS


@dataclass
class WaitForPodsReady:
    """configuration_types.go:216."""
    enable: bool = False
    timeout_seconds: float = 300.0
    block_admission: bool = False
    recovery_timeout_seconds: Optional[float] = None
    requeuing_strategy: RequeuingStrategy = field(
        default_factory=RequeuingStrategy)


@dataclass
class IntegrationsConfig:
    """configuration_types.go:351."""
    frameworks: list[str] = field(
        default_factory=lambda: ["batch/job"])
    external_frameworks: list[str] = field(default_factory=list)
    label_keys_to_copy: list[str] = field(default_factory=list)


@dataclass
class ResourceTransformation:
    """configuration_types.go:432."""
    input: str = ""
    strategy: str = "Retain"             # Retain | Replace
    outputs: dict[str, int] = field(default_factory=dict)


@dataclass
class ResourcesConfig:
    """configuration_types.go:418."""
    exclude_resource_prefixes: list[str] = field(default_factory=list)
    transformations: list[ResourceTransformation] = field(
        default_factory=list)


@dataclass
class FairSharingConfig:
    """configuration_types.go:452."""
    enable: bool = False
    preemption_strategies: list[str] = field(
        default_factory=lambda: list(PREEMPTION_STRATEGIES))


@dataclass
class MultiKueueConfigOptions:
    """configuration_types.go:248."""
    gc_interval_seconds: float = DEFAULT_MULTIKUEUE_GC_INTERVAL_SECONDS
    origin: str = DEFAULT_MULTIKUEUE_ORIGIN
    worker_lost_timeout_seconds: float = (
        DEFAULT_MULTIKUEUE_WORKER_LOST_TIMEOUT_SECONDS)


@dataclass
class Configuration:
    """configuration_types.go:31."""
    namespace: str = DEFAULT_NAMESPACE
    manage_jobs_without_queue_name: bool = False
    managed_jobs_namespace_selector: dict[str, str] = field(
        default_factory=dict)
    leader_election: bool = True
    metrics_bind_address: str = ":8443"
    health_probe_bind_address: str = ":8081"
    enable_clusterqueue_resources_metrics: bool = False
    wait_for_pods_ready: WaitForPodsReady = field(
        default_factory=WaitForPodsReady)
    integrations: IntegrationsConfig = field(
        default_factory=IntegrationsConfig)
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    fair_sharing: FairSharingConfig = field(default_factory=FairSharingConfig)
    multikueue: MultiKueueConfigOptions = field(
        default_factory=MultiKueueConfigOptions)
    queue_visibility_update_interval_seconds: float = 5.0
    feature_gates: dict[str, bool] = field(default_factory=dict)


def default_configuration() -> Configuration:
    return Configuration()


# ---------------------------------------------------------------------------
# Load (pkg/config/config.go:156)
# ---------------------------------------------------------------------------

def load(path: str) -> Configuration:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = _from_dict(raw)
    errors = validate(cfg)
    if errors:
        raise ConfigValidationError(errors)
    return cfg


def _from_dict(raw: dict) -> Configuration:
    cfg = Configuration()
    cfg.namespace = raw.get("namespace", cfg.namespace)
    cfg.manage_jobs_without_queue_name = raw.get(
        "manageJobsWithoutQueueName", cfg.manage_jobs_without_queue_name)
    cfg.managed_jobs_namespace_selector = (
        (raw.get("managedJobsNamespaceSelector") or {}).get("matchLabels", {}))
    cfg.leader_election = (raw.get("leaderElection") or {}).get(
        "leaderElect", cfg.leader_election)
    cfg.metrics_bind_address = (raw.get("metrics") or {}).get(
        "bindAddress", cfg.metrics_bind_address)
    cfg.enable_clusterqueue_resources_metrics = (raw.get("metrics") or {}).get(
        "enableClusterQueueResources",
        cfg.enable_clusterqueue_resources_metrics)
    cfg.health_probe_bind_address = (raw.get("health") or {}).get(
        "healthProbeBindAddress", cfg.health_probe_bind_address)

    wfpr = raw.get("waitForPodsReady") or {}
    if wfpr:
        rq = wfpr.get("requeuingStrategy") or {}
        cfg.wait_for_pods_ready = WaitForPodsReady(
            enable=wfpr.get("enable", False),
            timeout_seconds=_seconds(wfpr.get("timeout", "5m")),
            block_admission=wfpr.get("blockAdmission",
                                     wfpr.get("enable", False)),
            recovery_timeout_seconds=(
                _seconds(wfpr["recoveryTimeout"])
                if "recoveryTimeout" in wfpr else None),
            requeuing_strategy=RequeuingStrategy(
                timestamp=rq.get("timestamp", "Eviction"),
                backoff_limit_count=rq.get("backoffLimitCount"),
                backoff_base_seconds=rq.get(
                    "backoffBaseSeconds",
                    DEFAULT_REQUEUING_BACKOFF_BASE_SECONDS),
                backoff_max_seconds=rq.get(
                    "backoffMaxSeconds",
                    DEFAULT_REQUEUING_BACKOFF_MAX_SECONDS)))

    integ = raw.get("integrations") or {}
    if integ:
        cfg.integrations = IntegrationsConfig(
            frameworks=integ.get("frameworks", ["batch/job"]),
            external_frameworks=integ.get("externalFrameworks", []),
            label_keys_to_copy=integ.get("labelKeysToCopy", []))

    res = raw.get("resources") or {}
    if res:
        cfg.resources = ResourcesConfig(
            exclude_resource_prefixes=res.get("excludeResourcePrefixes", []),
            transformations=[
                ResourceTransformation(
                    input=t.get("input", ""),
                    strategy=t.get("strategy", "Retain"),
                    outputs=t.get("outputs", {}))
                for t in res.get("transformations", [])])

    fs = raw.get("fairSharing") or {}
    if fs:
        cfg.fair_sharing = FairSharingConfig(
            enable=fs.get("enable", False),
            preemption_strategies=fs.get(
                "preemptionStrategies", list(PREEMPTION_STRATEGIES)))

    mk = raw.get("multiKueue") or {}
    if mk:
        cfg.multikueue = MultiKueueConfigOptions(
            gc_interval_seconds=_seconds(mk.get("gcInterval", "1m")),
            origin=mk.get("origin", DEFAULT_MULTIKUEUE_ORIGIN),
            worker_lost_timeout_seconds=_seconds(
                mk.get("workerLostTimeout", "15m")))

    cfg.feature_gates = dict(raw.get("featureGates") or {})
    return cfg


def _seconds(v) -> float:
    """Parse a metav1.Duration-ish value ("5m", "300s", 300)."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    for suffix in ("ms", "s", "m", "h"):
        if s.endswith(suffix):
            return float(s[:-len(suffix)]) * units[suffix]
    return float(s)


# ---------------------------------------------------------------------------
# Validate (pkg/config/validation.go)
# ---------------------------------------------------------------------------

def validate(cfg: Configuration) -> list[str]:
    errors: list[str] = []
    w = cfg.wait_for_pods_ready
    if w.enable:
        if w.timeout_seconds <= 0:
            errors.append("waitForPodsReady.timeout must be positive")
        rs = w.requeuing_strategy
        if rs.timestamp not in ("Eviction", "Creation"):
            errors.append(
                f"waitForPodsReady.requeuingStrategy.timestamp "
                f"{rs.timestamp!r} not in (Eviction, Creation)")
        if rs.backoff_limit_count is not None and rs.backoff_limit_count < 0:
            errors.append("requeuingStrategy.backoffLimitCount must be >= 0")
        if rs.backoff_base_seconds < 0:
            errors.append("requeuingStrategy.backoffBaseSeconds must be >= 0")
    for fw in cfg.integrations.frameworks:
        if fw not in KNOWN_FRAMEWORKS:
            errors.append(f"unknown framework {fw!r} in integrations")
    for st in cfg.fair_sharing.preemption_strategies:
        if st not in PREEMPTION_STRATEGIES:
            errors.append(f"unknown preemption strategy {st!r}")
    for t in cfg.resources.transformations:
        if not t.input:
            errors.append("resource transformation with empty input")
        if t.strategy not in ("Retain", "Replace"):
            errors.append(f"unknown transformation strategy {t.strategy!r}")
    seen = set()
    for t in cfg.resources.transformations:
        if t.input in seen:
            errors.append(f"duplicate transformation input {t.input!r}")
        seen.add(t.input)
    # ValidateFeatureGates (pkg/config/validation.go:359)
    for name in cfg.feature_gates:
        if name not in DEFAULT_FEATURE_GATES:
            errors.append(f"unknown feature gate {name!r}")
    return errors
