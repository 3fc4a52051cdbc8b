"""Configuration and manifests of the port (``kueue_tpu_torch.config``,
``api.manifests``, ``utils.expectations``) against the JAX package's:
``config.load`` and ``validate`` on the same YAML texts (equal
configurations, equal messages), ``load_manifests`` / ``to_manifest``
round trips for every kind, ``Driver.from_config`` deciding a small
scenario identically in both packages, and the job front door
(``scenarios.build_jobs`` / ``jobs_spec`` / ``run_jobs``) at a cut size
with equal digests.  Tolerance 0."""

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from kueue_tpu_torch import scenarios
from tests.conftest import FakeClock
from tests.test_torch_jobs import front_door, gates_restored

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def norm(x):
    """A dataclass tree as plain data (enums by value), so that objects
    of the two packages compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {str(norm(k)): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


@pytest.fixture
def gates():
    """Both packages' feature gates back to what they were."""
    jm, pm = front_door("kueue_tpu"), front_door("kueue_tpu_torch")
    with gates_restored():
        yield jm.features, pm.features


# -- config.load / validate --------------------------------------------

CONFIGS = {
    "jobs": scenarios.JOBS_CONFIG,
    "empty": "",
    "full": """\
namespace: kueue-test
manageJobsWithoutQueueName: true
managedJobsNamespaceSelector:
  matchLabels: {team: ml}
leaderElection: {leaderElect: false}
metrics: {bindAddress: ":9443", enableClusterQueueResources: true}
health: {healthProbeBindAddress: ":9081"}
waitForPodsReady:
  enable: true
  timeout: 2m
  recoveryTimeout: 90s
  requeuingStrategy:
    timestamp: Creation
    backoffLimitCount: 4
    backoffBaseSeconds: 10
    backoffMaxSeconds: 600
integrations:
  frameworks: [batch/job, kubeflow.org/mpijob, ray.io/raycluster]
  externalFrameworks: [Foo.v1.example.com]
  labelKeysToCopy: [team]
resources:
  excludeResourcePrefixes: [example.com/]
  transformations:
  - input: nvidia.com/mig-1g.5gb
    strategy: Replace
    outputs: {example.com/accelerator-memory: 5}
fairSharing:
  enable: true
  preemptionStrategies: [LessThanOrEqualToFinalShare]
multiKueue: {gcInterval: 30s, origin: west, workerLostTimeout: 5m}
featureGates: {TopologyAwareScheduling: true, TASProfileMixed: true}
""",
    "bad-timestamp": """\
waitForPodsReady:
  enable: true
  timeout: 0s
  requeuingStrategy: {timestamp: Never, backoffLimitCount: -1,
                      backoffBaseSeconds: -5}
""",
    "bad-names": """\
integrations: {frameworks: [batch/job, example.com/unknown]}
fairSharing: {enable: true, preemptionStrategies: [Sometimes]}
featureGates: {NoSuchGate: true}
""",
    "bad-transformations": """\
resources:
  transformations:
  - {input: "", strategy: Retain}
  - {input: cpu, strategy: Sideways}
  - {input: cpu, strategy: Replace}
""",
}


def _load(m, text, tmp_path, name):
    path = tmp_path / f"{name}-{m.config.__name__.split('.')[0]}.yaml"
    path.write_text(text)
    try:
        cfg = m.config.load(str(path))
    except m.config.ConfigValidationError as e:
        return ["errors", list(e.errors), str(e)]
    return ["ok", norm(cfg), m.config.validate(cfg)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_load_and_validate_agree(name, tmp_path):
    got = [_load(front_door(root), CONFIGS[name], tmp_path, name)
           for root in PACKAGES]
    assert got[1] == got[0]
    assert (got[1][0] == "errors") == name.startswith("bad")
    if name == "jobs":
        cfg = got[1][1]
        assert cfg["feature_gates"] == {"TopologyAwareScheduling": True}
        assert cfg["wait_for_pods_ready"]["enable"] is True
        assert cfg["wait_for_pods_ready"]["block_admission"] is False
        assert cfg["fair_sharing"]["enable"] is False


def test_default_configuration_agrees():
    jm, pm = front_door("kueue_tpu"), front_door("kueue_tpu_torch")
    assert norm(pm.config.default_configuration()) == norm(
        jm.config.default_configuration())
    assert pm.config.configuration.KNOWN_FRAMEWORKS == \
        jm.config.configuration.KNOWN_FRAMEWORKS


def test_jobs_configuration_goes_through_load_and_validate():
    for root in PACKAGES:
        m = front_door(root)
        cfg = scenarios.jobs_configuration(m)
        assert m.config.validate(cfg) == []
        with pytest.raises(m.config.ConfigValidationError,
                           match="unknown feature gate"):
            scenarios.jobs_configuration(m, "featureGates: {Nope: true}\n")


# -- manifests ---------------------------------------------------------

MANIFESTS = """\
apiVersion: kueue.x-k8s.io/v1beta1
kind: ResourceFlavor
metadata: {name: gpu}
spec:
  nodeLabels: {cloud.google.com/gke-accelerator: nvidia-h100-80gb}
  nodeTaints: [{key: gpu, value: "true", effect: NoSchedule}]
  tolerations: [{key: gpu, operator: Exists, effect: NoSchedule}]
  topologyName: gpu-topology
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: ResourceFlavor
metadata: {name: plain}
---
apiVersion: kueue.x-k8s.io/v1alpha1
kind: Topology
metadata: {name: gpu-topology}
spec:
  levels:
  - {nodeLabel: cloud.google.com/gce-topology-block}
  - {nodeLabel: kubernetes.io/hostname}
---
apiVersion: kueue.x-k8s.io/v1alpha1
kind: Cohort
metadata: {name: research}
spec: {parentName: org, fairSharing: {weight: 2}}
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: ClusterQueue
metadata: {name: team-a}
spec:
  cohort: research
  namespaceSelector: {matchLabels: {team: a}}
  queueingStrategy: StrictFIFO
  preemption:
    reclaimWithinCohort: LowerPriority
    withinClusterQueue: LowerOrNewerEqualPriority
    borrowWithinCohort: {policy: LowerPriority, maxPriorityThreshold: 100}
  flavorFungibility: {whenCanBorrow: TryNextFlavor, whenCanPreempt: Preempt}
  admissionChecks: [prov]
  fairSharing: {weight: 3}
  stopPolicy: Hold
  resourceGroups:
  - coveredResources: [cpu, memory]
    flavors:
    - name: plain
      resources:
      - {name: cpu, nominalQuota: 9, borrowingLimit: "500m", lendingLimit: 2}
      - {name: memory, nominalQuota: 36Gi}
  - coveredResources: [nvidia.com/gpu]
    flavors:
    - name: gpu
      resources: [{name: nvidia.com/gpu, nominalQuota: 16}]
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: LocalQueue
metadata: {name: lq-a, namespace: team-a}
spec: {clusterQueue: team-a, stopPolicy: HoldAndDrain}
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: AdmissionCheck
metadata: {name: prov}
spec:
  controllerName: kueue.x-k8s.io/provisioning-request
  parameters: {apiGroup: kueue.x-k8s.io, kind: ProvisioningRequestConfig,
               name: cfg}
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: WorkloadPriorityClass
metadata: {name: urgent}
value: 10000
description: urgent jobs
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: Workload
metadata: {name: wl-1, namespace: team-a, creationTimestamp: 12.5}
spec:
  queueName: lq-a
  priority: 7
  priorityClassName: urgent
  active: true
  maximumExecutionTimeSeconds: 600
  podSets:
  - name: main
    count: 4
    minCount: 2
    topologyRequest: {preferred: cloud.google.com/gce-topology-block}
    template:
      spec:
        nodeSelector: {disk: ssd}
        tolerations: [{key: gpu, operator: Exists}]
        containers:
        - name: a
          resources:
            requests: {cpu: 1500m, memory: 1Gi, nvidia.com/gpu: 1}
            limits: {cpu: 1, memory: 2Gi}
        - name: b
          resources: {requests: {cpu: 250m}}
status:
  admission:
    clusterQueue: team-a
    podSetAssignments:
    - name: main
      count: 4
      flavors: {cpu: plain, nvidia.com/gpu: gpu}
      resourceUsage: {cpu: "7", nvidia.com/gpu: "4"}
  conditions:
  - {type: QuotaReserved, status: "True", reason: QuotaReserved,
     message: reserved, lastTransitionTime: 13.0}
"""


def _decoded(root):
    m = front_door(root)
    return m, m.manifests.load_manifests(MANIFESTS)


def test_load_manifests_agree_for_every_kind():
    (jm, jobs), (pm, pobjs) = _decoded("kueue_tpu"), _decoded(
        "kueue_tpu_torch")
    assert [type(o).__name__ for o in pobjs] == [
        type(o).__name__ for o in jobs]
    assert {type(o).__name__ for o in pobjs} == {
        "ResourceFlavor", "Topology", "Cohort", "ClusterQueue",
        "LocalQueue", "AdmissionCheck", "WorkloadPriorityClass", "Workload"}
    assert norm(pobjs) == norm(jobs)
    cq = next(o for o in pobjs if type(o).__name__ == "ClusterQueue")
    assert cq.resource_groups[0].flavors[0].resources["cpu"].nominal == 9000


def test_manifest_round_trips_agree():
    """to_manifest of every kind it encodes, then load_manifests of its
    YAML: the same objects again, and the same documents in both
    packages."""
    docs = []
    for root in PACKAGES:
        m, objs = _decoded(root)
        out = []
        for obj in objs:
            try:
                doc = m.manifests.to_manifest(obj)
            except m.manifests.ManifestError as e:
                out.append(["unsupported", str(e)])
                continue
            back = m.manifests.load_manifests(yaml.safe_dump(doc))
            assert len(back) == 1
            again = m.manifests.to_manifest(back[0])
            assert again == doc, type(obj).__name__
            out.append([doc, norm(back[0])])
        docs.append(out)
    assert docs[1] == docs[0]
    assert sum(d[0] != "unsupported" for d in docs[1]) == 5


def test_manifest_errors_agree():
    errs = []
    for root in PACKAGES:
        m = front_door(root)
        with pytest.raises(m.manifests.ManifestError) as e:
            m.manifests.load_manifests("kind: Gadget\nmetadata: {name: x}\n")
        errs.append(str(e.value))
        with pytest.raises(m.manifests.ManifestError) as e:
            m.manifests.to_manifest(object())
        errs.append(str(e.value))
    assert errs[:2] == errs[2:]


def test_expectations_store_agrees():
    out = []
    for root in PACKAGES:
        store = __import__(f"{root}.utils.expectations",
                           fromlist=["Store"]).Store("pods")
        store.expect_uids("g", ["a", "b"])
        trace = [store.satisfied("g")]
        store.observed_uid("g", "a")
        trace.append(store.satisfied("g"))
        store.observed_uid("g", "b")
        trace.append(store.satisfied("g"))
        store.expect_uids("h", ["c"])
        store.forget("h")
        trace.append(store.satisfied("h"))
        out.append(trace)
    assert out[0] == out[1] == [False, False, True, True]


# -- Driver.from_config ------------------------------------------------

FROM_CONFIG = {
    "default": "",
    "fair-sharing": "fairSharing: {enable: true}\n",
    "pods-ready": ("waitForPodsReady: {enable: true, blockAdmission: true,"
                   " timeout: 5s}\n"),
    "resources": """\
resources:
  excludeResourcePrefixes: [example.com/]
  transformations:
  - input: example.org/slices
    strategy: Replace
    outputs: {cpu: 500}
""",
}


def _cluster_manifest(n_cqs=6, cohorts=2):
    docs = ["apiVersion: kueue.x-k8s.io/v1beta1\nkind: ResourceFlavor\n"
            "metadata: {name: default}\n"]
    for i in range(n_cqs):
        docs.append(f"""\
apiVersion: kueue.x-k8s.io/v1beta1
kind: ClusterQueue
metadata: {{name: cq-{i}}}
spec:
  cohort: co-{i % cohorts}
  preemption: {{reclaimWithinCohort: Any, withinClusterQueue: LowerPriority}}
  fairSharing: {{weight: {1 + i % 3}}}
  resourceGroups:
  - coveredResources: [cpu]
    flavors:
    - name: default
      resources: [{{name: cpu, nominalQuota: 4}}]
---
apiVersion: kueue.x-k8s.io/v1beta1
kind: LocalQueue
metadata: {{name: lq-{i}, namespace: default}}
spec: {{clusterQueue: cq-{i}}}
""")
    return "---\n".join(docs)


def _workloads_manifest(seed, n=48, n_cqs=6):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        cpu = int(rng.choice((500, 1000, 2000, 3000)))
        extra = ("example.org/slices: 2" if rng.random() < 0.2 else
                 "example.com/widgets: 1" if rng.random() < 0.2 else "")
        docs.append(f"""\
apiVersion: kueue.x-k8s.io/v1beta1
kind: Workload
metadata: {{name: wl-{i}, namespace: default, creationTimestamp: {i + 1}}}
spec:
  queueName: lq-{int(rng.integers(n_cqs))}
  priority: {int(rng.choice((0, 10, 100)))}
  podSets:
  - name: main
    count: {int(rng.integers(1, 3))}
    template:
      spec:
        containers:
        - name: c
          resources:
            requests: {{cpu: {cpu}m{", " + extra if extra else ""}}}
""")
    return "---\n".join(docs)


def _from_config_run(root, text, seed, tmp_path):
    m = front_door(root)
    cfg = scenarios.jobs_configuration(m, text)
    clock = FakeClock()
    kw = {} if root == "kueue_tpu" else {"device": "cpu"}
    d = m.driver.Driver.from_config(cfg, clock, **kw)
    for obj in m.manifests.load_manifests(_cluster_manifest()):
        getattr(d, scenarios._APPLY[type(obj).__name__])(obj)
    for wl in m.manifests.load_manifests(_workloads_manifest(seed)):
        d.create_workload(wl)
    running = []
    for cycle in range(14):
        clock.t += 1.0
        stats = d.schedule_once()
        for key in sorted(stats.admitted):
            running.append((cycle + 3, key))
            d.set_pods_ready(key, cycle % 2 == 0)
        for at, key in list(running):
            wl = d.workload(key)
            if wl is None or not wl.has_quota_reservation:
                running.remove((at, key))
            elif at <= cycle:
                d.finish_workload(key)
                running.remove((at, key))
    return [list(d.events), d.scheduler.fair_sharing,
            sorted((k, w.is_admitted, w.is_finished)
                   for k, w in d.workloads.items())]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(FROM_CONFIG))
def test_from_config_decides_identically(name, seed, tmp_path, gates):
    got = [_from_config_run(root, FROM_CONFIG[name], seed, tmp_path)
           for root in PACKAGES]
    assert got[1] == got[0]
    assert got[1][1] == (name == "fair-sharing")
    assert any(e[0] == "QuotaReserved" for e in got[1][0])


# -- the job front door ------------------------------------------------

CUT = dict(blocks=2, subblocks=2, hosts=4, n_cqs=8, n_cohorts=2,
           n_jobs=450, steps=24)


def test_build_jobs_agrees_across_packages(gates):
    """jobs-tas-4k cut to 2 x 2 x 4 nodes, 8 CQs, 480 jobs and 24 steps:
    the JAX Driver (from its Configuration) and the port's on the CPU
    give one digest; the port's ``build_jobs`` gives it too; every kind
    starts, preemption stops jobs whose templates are restored, the
    webhook refuses the same jobs, and both packages' gates are back
    afterwards."""
    jf, pf = gates
    before = (dict(jf._overrides), dict(pf._overrides))
    out = []
    with gates_restored():
        for root in PACKAGES:
            m = front_door(root)
            clock = scenarios.VirtualClock()
            kw = {} if root == "kueue_tpu" else {"device": "cpu"}
            d = m.driver.Driver.from_config(
                scenarios.jobs_configuration(m), clock, **kw)
            assert m.features.enabled("TopologyAwareScheduling")
            plan = scenarios.jobs_spec(m, d, **CUT)
            mgr = m.jobframework.JobManager(d)
            r = scenarios.run_jobs(d, clock, mgr, plan)
            out.append((scenarios.jobs_digest(d, r), r))
        with scenarios.restore_gates():
            d, clock, mgr, plan = scenarios.build_jobs(device="cpu", **CUT)
            with scenarios.TASBranches() as br:
                r = scenarios.run_jobs(d, clock, mgr, plan)
        out.append((scenarios.jobs_digest(d, r), r))
    scenarios.release()
    assert (dict(jf._overrides), dict(pf._overrides)) == before
    assert out[1][0] == out[0][0] == out[2][0]
    r = out[2][1]
    assert set(r["started_kinds"]) == set(scenarios.JOB_KINDS)
    assert r["preempted"] > 0 and r["stopped"]
    assert all(restored for _, _, restored in r["stopped"])
    assert r["preempted_unstopped"] == []
    assert r["refused"] == out[0][1]["refused"]
    assert br.counts["best_fit_descend"] > 0
    assert br.counts["split_across_roots"] > 0
    assert br.counts["scalar_walk"] == 0


def test_jobs_front_door_in_a_fresh_process():
    """build_jobs + run_jobs on "cpu" at a tiny size load neither jax nor
    kueue_tpu, and leave the gates as they were."""
    code = (
        "import sys\n"
        "from kueue_tpu_torch import features, scenarios\n"
        "before = dict(features._overrides)\n"
        "with scenarios.restore_gates():\n"
        "    d, c, mgr, plan = scenarios.build_jobs(device='cpu', blocks=1,"
        " subblocks=2, hosts=4, n_cqs=4, n_cohorts=2, n_jobs=90, steps=12)\n"
        "    r = scenarios.run_jobs(d, c, mgr, plan)\n"
        "assert r['admitted'] > 0, r['admitted']\n"
        "assert dict(features._overrides) == before\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
