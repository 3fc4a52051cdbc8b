"""The job layer of the port (``kueue_tpu_torch.podset``,
``jobframework``, ``jobs``) against the JAX package's: the lifecycles of
tests/test_jobframework.py, test_job_webhooks.py and test_podsready.py,
built from a seed in both packages and driven through each package's
``JobManager`` and Driver (the port's on the CPU).  Every step's
``Driver.events`` and job states — suspended, injected node selectors
and tolerations, restored templates, finished — and every webhook error
list must be equal.  Tolerance 0."""

import contextlib
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from kueue_tpu_torch import scenarios
from tests.conftest import FakeClock

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")
SEEDS = (0, 1, 2)


# the modules of the job front door, as ``scenarios.jobs_spec`` takes them
FRONT_DOOR = ("api.types", "api.manifests", "config", "features",
              "webhooks.validation", "jobframework", "jobs",
              "jobs.appwrapper", "jobs.kubeflow", "jobs.pod", "jobs.ray",
              "jobs.serving", "cache.tas_cache", "controller.driver")


def front_door(root):
    """Package ``root``'s front-door modules by their last name
    (``m.manifests``, ``m.kubeflow``, ``m.driver``, ...): the two
    packages have one layout."""
    return SimpleNamespace(**{
        name.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{name}")
        for name in FRONT_DOOR})


@contextlib.contextmanager
def gates_restored():
    """Both packages' feature gates back to what they were when the
    block ends (``scenarios.restore_gates`` restores the port's)."""
    jf = importlib.import_module("kueue_tpu.features")
    saved = dict(jf._overrides)
    try:
        with scenarios.restore_gates():
            yield
    finally:
        jf._overrides.clear()
        jf._overrides.update(saved)


def test_build_jobs_takes_the_ports_ownfront_door():
    """``scenarios.build_jobs`` builds on the port's modules, imported
    by the port itself: the namespace it passes to ``jobs_spec`` holds
    the modules that ``front_door`` finds under the port's name."""
    got = vars(scenarios._front_door())
    want = vars(front_door("kueue_tpu_torch"))
    assert got.keys() == want.keys()
    assert all(got[k] is want[k] for k in want)
    assert all(v.__name__.split(".")[0] == "kueue_tpu_torch"
               for v in got.values())


def test_gates_restored_restores_both_packages():
    jm, pm = front_door("kueue_tpu"), front_door("kueue_tpu_torch")
    before = (dict(jm.features._overrides), dict(pm.features._overrides))
    flip = {"TopologyAwareScheduling":
            not pm.features.enabled("TopologyAwareScheduling")}
    with gates_restored():
        jm.features.set_feature_gates(flip)
        pm.features.set_feature_gates(flip)
        assert pm.features.enabled("TopologyAwareScheduling") == flip[
            "TopologyAwareScheduling"]
    assert (dict(jm.features._overrides),
            dict(pm.features._overrides)) == before
    with scenarios.restore_gates():
        pm.features.set_feature_gates(flip)
        jm.features.set_feature_gates(flip)
    assert dict(pm.features._overrides) == before[1]
    # the port's restore_gates leaves the JAX package's gates alone
    assert jm.features.enabled("TopologyAwareScheduling") == flip[
        "TopologyAwareScheduling"]
    jm.features._overrides.clear()
    jm.features._overrides.update(before[0])


def _driver(root, m, nominal=10_000, node_labels=None, tolerations=(),
            cqs=(("cq", None),), wfpr=None, priority_classes=()):
    """tests/test_jobframework.py ``make_driver`` for either package: one
    flavor (node labels and tolerations as given), ClusterQueues with a
    LocalQueue each, lower-priority preemption within a queue."""
    t = m.types
    clock = FakeClock()
    kw = {} if root == "kueue_tpu" else {"device": "cpu"}
    if wfpr is not None:
        kw["wait_for_pods_ready"] = m.driver.WaitForPodsReadyConfig(**wfpr)
    d = m.driver.Driver(clock=clock, **kw)
    d.apply_resource_flavor(t.ResourceFlavor(
        name="default", node_labels=dict(node_labels or {}),
        tolerations=[t.Toleration(**x) for x in tolerations]))
    for i, (cq, cohort) in enumerate(cqs):
        d.apply_cluster_queue(t.ClusterQueue(
            name=cq, cohort=cohort,
            preemption=t.PreemptionPolicy(
                within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=nominal)})])]))
        d.apply_local_queue(t.LocalQueue(
            name="lq" if len(cqs) == 1 else f"lq-{i}", cluster_queue=cq))
    for name, value in priority_classes:
        d.apply_workload_priority_class(t.WorkloadPriorityClass(
            name=name, value=value))
    return d, clock


def _workload_state(wl):
    if wl is None:
        return None
    adm = wl.admission
    return [wl.key, wl.priority, wl.is_admitted, wl.is_finished,
            wl.is_active,
            sorted(k for k, c in wl.conditions.items()
                   if c.status.value == "True"),
            None if adm is None else [adm.cluster_queue, sorted(
                (a.name, a.count, sorted(a.flavors.items()))
                for a in adm.pod_set_assignments)],
            None if wl.requeue_state is None else
            [wl.requeue_state.count, wl.requeue_state.requeue_at]]


class Trace:
    """Snapshots of a lifecycle: the jobs' states, their workloads', the
    driver's usage and events, at each ``snap``."""

    def __init__(self, d, manager):
        self.d, self.manager, self.rows = d, manager, []

    def snap(self, *jobs, note=""):
        d, m = self.d, self.manager
        self.rows.append([
            note,
            [[j.key, j.is_suspended(), list(j.finished()),
              scenarios._template_state(j),
              _workload_state(d.workload(
                  m.reconciler.workload_key_for(j)))] for j in jobs],
            sorted((cq, sorted((str(fr), v) for fr, v in
                               d.cache.usage(cq).items()))
                   for cq in d.queues.cluster_queue_names()),
            list(d.events)])


def both(lifecycle, seed=0, **driver_kw):
    """Run ``lifecycle(m, d, clock, manager, trace, rng)`` in both
    packages; their traces must be equal.  Returns the port's."""
    out = []
    for root in PACKAGES:
        m = front_door(root)
        d, clock = _driver(root, m, **driver_kw)
        manager = m.jobframework.JobManager(d)
        trace = Trace(d, manager)
        lifecycle(m, d, clock, manager, trace, np.random.default_rng(seed))
        out.append(trace.rows)
    assert out[1] == out[0]
    assert out[1], "the lifecycle took no snapshot"
    return out[1]


def _cpu(rng, lo=1, hi=4):
    return int(rng.integers(lo, hi + 1)) * 500


# -- tests/test_jobframework.py ----------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_job_lifecycle(seed):
    def lc(m, d, clock, mgr, tr, rng):
        n = int(rng.integers(1, 5))
        job = m.jobs.BatchJob("train", parallelism=n,
                              requests={"cpu": _cpu(rng)}, queue="lq")
        mgr.upsert(job)
        tr.snap(job, note="upserted")
        mgr.run()
        tr.snap(job, note="started")
        job.complete_pods(n)
        mgr.run()
        tr.snap(job, note="finished")
    rows = both(lc, seed, node_labels={"cloud.com/type": "tpu-v5e"},
                tolerations=[dict(key="pool", value="tpu",
                                  effect="NoSchedule")])
    started = rows[1][1][0]
    assert started[1] is False
    assert started[3][0][2] == [("cloud.com/type", "tpu-v5e")]
    assert started[3][0][3] == [["pool", "Equal", "tpu", "NoSchedule"]]
    assert rows[2][1][0][2][2] is True       # finished


def test_unmanaged_and_gated_jobs():
    def lc(m, d, clock, mgr, tr, rng):
        free = m.jobs.BatchJob("unmanaged", parallelism=1,
                               requests={"cpu": 1000})
        mgr.upsert(free)
        mgr.run()
        sneaky = m.jobs.BatchJob("sneaky", parallelism=1,
                                 requests={"cpu": 1000}, queue="lq")
        sneaky.suspended = False
        mgr.upsert(sneaky)
        tr.snap(free, sneaky)
    rows = both(lc)
    assert rows[0][1][0][4] is None          # no workload
    assert rows[0][1][1][1] is True          # gated
    assert ("Stopped", "BatchJob/default/sneaky",
            "NoMatchingWorkload") in rows[0][3]


@pytest.mark.parametrize("seed", SEEDS)
def test_eviction_stops_job_and_restores_template(seed):
    def lc(m, d, clock, mgr, tr, rng):
        n = int(rng.integers(1, 3))
        low = m.jobs.BatchJob("low", parallelism=2 + n,
                              requests={"cpu": 1000}, queue="lq")
        mgr.upsert(low)
        mgr.run()
        tr.snap(low, note="low running")
        high = m.jobs.BatchJob("high", parallelism=2,
                               requests={"cpu": 1000}, queue="lq",
                               priority_class="high")
        mgr.upsert(high)
        mgr.run()
        tr.snap(low, high, note="preempted")
    rows = both(lc, seed, nominal=4000, node_labels={"zone": "a"},
                priority_classes=[("high", 1000)])
    low, high = rows[1][1]
    assert low[1] is True and low[3][0][2] == []   # stopped, restored
    assert high[1] is False and high[4][1] == 1000
    assert any(e[0] == "Preempted" for e in rows[1][3])


@pytest.mark.parametrize("seed", SEEDS)
def test_reclaimable_pods_release_quota(seed):
    def lc(m, d, clock, mgr, tr, rng):
        a = m.jobs.BatchJob("a", parallelism=3, requests={"cpu": 1000},
                            queue="lq")
        mgr.upsert(a)
        mgr.run()
        b = m.jobs.BatchJob("b", parallelism=1, requests={"cpu": 1000},
                            queue="lq")
        mgr.upsert(b)
        mgr.run()
        tr.snap(a, b, note="b waits")
        a.complete_pods(int(rng.integers(1, 3)))
        mgr.run()
        tr.snap(a, b, note="reclaimed")
    both(lc, seed, nominal=3000)


@pytest.mark.parametrize("seed", SEEDS)
def test_pod_groups(seed):
    """The gang of test_podgroup_gang_admission_and_ungating, a group
    too big to fit, and the mixed-role group of
    tests/test_job_webhooks.py."""
    def lc(m, d, clock, mgr, tr, rng):
        n = int(rng.integers(2, 4))
        group = m.pod.PodGroup("workers", total_count=n, queue="lq")
        for i in range(n):
            group.add_pod(m.pod.Pod(name=f"p{i}", requests={"cpu": 1000}))
        big = m.pod.PodGroup("big", total_count=8, queue="lq")
        for i in range(8):
            big.add_pod(m.pod.Pod(name=f"b{i}", requests={"cpu": 1000}))
        mixed = m.pod.PodGroup("mixed", total_count=4, queue="lq")
        for i in range(2):
            mixed.add_pod(m.pod.Pod(name=f"driver-{i}",
                                    requests={"cpu": 500}))
            mixed.add_pod(m.pod.Pod(name=f"worker-{i}",
                                    requests={"cpu": 250},
                                    node_selector={"pool": "spot"}))
        for g in (group, big, mixed):
            mgr.upsert(g)
        mgr.run()
        tr.snap(group, big, mixed, note="ungated")
        for p in group.pods + mixed.pods:
            p.phase = "Succeeded"
        mgr.run()
        tr.snap(group, big, mixed, note="finished")
    rows = both(lc, seed, nominal=6000,
                node_labels={"cloud.com/type": "tpu-v5e"})
    group, big, mixed = rows[0][1]
    assert group[1] is False and big[1] is True and mixed[1] is False
    assert all(p[2] is True for p in big[3])            # still gated
    assert rows[1][1][0][2][2] and rows[1][1][2][2][2]  # finished


@pytest.mark.parametrize("seed", SEEDS)
def test_multi_podset_kinds(seed):
    """JobSet, PyTorchJob (role order), TFJob, RayJob, Deployment,
    StatefulSet, LeaderWorkerSet and AppWrapper: admitted, started,
    finished (the serving kinds by deletion)."""
    def lc(m, d, clock, mgr, tr, rng):
        k = m.kubeflow
        jobs = [
            m.jobs.JobSet("set", replicated_jobs=[
                m.jobs.ReplicatedJobSpec(name="driver",
                                         requests={"cpu": 1000}),
                m.jobs.ReplicatedJobSpec(
                    name="workers", replicas=2,
                    parallelism=int(rng.integers(1, 4)),
                    requests={"cpu": 500})], queue="lq"),
            k.PyTorchJob("pt", replicas=[
                k.ReplicaSpec(role="Worker", replicas=int(rng.integers(1, 4)),
                              requests={"cpu": 1000}),
                k.ReplicaSpec(role="Master", replicas=1,
                              requests={"cpu": 500})], queue="lq"),
            k.TFJob("tf", replicas=[
                k.ReplicaSpec(role="Chief", replicas=1,
                              requests={"cpu": 100}),
                k.ReplicaSpec(role="Worker", replicas=2,
                              requests={"cpu": 100})], queue="lq"),
            m.ray.RayJob("ray", head_requests={"cpu": 1000},
                         worker_groups=[m.ray.WorkerGroupSpec(
                             name="workers", replicas=2,
                             requests={"cpu": _cpu(rng)})],
                         submitter_requests={"cpu": 500}, queue="lq"),
            m.serving.Deployment("serve", replicas=2,
                                 requests={"cpu": 500}, queue="lq"),
            m.serving.StatefulSet("web", replicas=int(rng.integers(1, 4)),
                                  requests={"cpu": 500}, queue="lq"),
            m.serving.LeaderWorkerSet("lws", groups=[
                m.serving.LWSGroup(index=0, workers=2,
                                   leader_requests={"cpu": 250},
                                   worker_requests={"cpu": 250})],
                queue="lq"),
            m.appwrapper.AppWrapper("aw", components=[
                m.appwrapper.Component(name="c0", count=2,
                                       requests={"cpu": 250})],
                queue="lq"),
        ]
        for j in jobs:
            mgr.upsert(j)
        mgr.run()
        tr.snap(*jobs, note="started")
        jobs[0].complete_replicated_job("driver")
        jobs[0].complete_replicated_job("workers")
        jobs[1].mark_running()
        jobs[1].mark_succeeded()
        jobs[2].mark_failed()
        jobs[3].mark_status("SUCCEEDED")
        jobs[5].deleted = True
        jobs[6].deleted = True
        jobs[7].mark_phase("Succeeded")
        mgr.run()
        tr.snap(*jobs, note="finished")
    rows = both(lc, seed, nominal=40_000)
    assert all(j[1] is False for j in rows[0][1])
    pt = rows[0][1][1]
    assert [t[0] for t in pt[3]] == ["master", "worker"]
    assert [j[2][2] for j in rows[1][1]] == [True, True, True, True, False,
                                             True, True, True]


def test_kubeflow_run_policy_round_trip():
    def lc(m, d, clock, mgr, tr, rng):
        job = m.kubeflow.PyTorchJob("rp", replicas=[
            m.kubeflow.ReplicaSpec(role="Worker", replicas=1,
                                   requests={"cpu": 100})], queue="lq")
        mgr.upsert(job)
        mgr.run()
        tr.snap(job, note="running")
        assert job.run_policy.suspend is False
        job.suspend()
        tr.snap(job, note="suspended")
    both(lc)


# -- tests/test_podsready.py -------------------------------------------


def _slow(m, name, queue="lq"):
    """test_podsready.SlowStartJob over this package's BatchJob."""
    class SlowStartJob(m.jobs.BatchJob):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.ready = False

        def pods_ready(self):
            return (not self.suspended) and self.ready
    return SlowStartJob(name, parallelism=1, requests={"cpu": 1000},
                        queue=queue)


def test_block_admission_gates_until_pods_ready():
    def lc(m, d, clock, mgr, tr, rng):
        j1, j2 = _slow(m, "first"), _slow(m, "second")
        mgr.upsert(j1)
        d.schedule_once()
        mgr.sync()
        tr.snap(j1, note="first not ready")
        mgr.upsert(j2)
        d.schedule_once()
        tr.snap(j1, j2, note="gate closed")
        j1.ready = True
        mgr.sync()
        d.schedule_once()
        mgr.sync()
        tr.snap(j1, j2, note="gate open")
    rows = both(lc, wfpr=dict(enable=True, block_admission=True,
                              timeout_seconds=300))
    assert rows[1][1][1][1] is True and rows[2][1][1][1] is False


def test_block_admission_one_per_cycle_across_cqs():
    def lc(m, d, clock, mgr, tr, rng):
        jobs = [_slow(m, f"job-{i}", queue=f"lq-{i}") for i in range(2)]
        for j in jobs:
            mgr.upsert(j)
        for _ in range(2):
            d.schedule_once()
            tr.snap(*jobs)
        mgr.sync()
        for j in jobs:
            j.ready = True
        mgr.sync()
        d.schedule_once()
        mgr.sync()
        tr.snap(*jobs, note="both")
    both(lc, cqs=(("cq-0", None), ("cq-1", None)),
         wfpr=dict(enable=True, block_admission=True, timeout_seconds=300))


@pytest.mark.parametrize("block", [True, False])
def test_pods_ready_timeout_evicts_and_backs_off(block):
    """test_pods_ready_timeout_evicts_automatically (blockAdmission on)
    and test_pods_ready_backoff_limit_deactivates (off, limit 1)."""
    def lc(m, d, clock, mgr, tr, rng):
        job = _slow(m, "slow")
        mgr.upsert(job)
        key = mgr.reconciler.workload_key_for(job)
        for _ in range(3):
            d.schedule_once()
            mgr.sync()
            tr.snap(job, note="admitted")
            clock.t += 11.0
            d.schedule_once()
            mgr.sync()
            tr.snap(job, note="timed out")
            wl = d.workload(key)
            if wl.requeue_state is not None:
                clock.t = max(clock.t, wl.requeue_state.requeue_at or 0) + 1
            d.queues.broadcast()
        job.ready = True
        d.schedule_once()
        mgr.sync()
        tr.snap(job, note="last")
    rows = both(lc, wfpr=dict(
        enable=True, block_admission=block, timeout_seconds=10,
        requeuing_backoff_base_seconds=5 if block else 1,
        requeuing_backoff_limit_count=None if block else 1))
    assert any("Evicted" in r[1][0][4][5] for r in rows)


def test_gate_opens_across_cohorts_on_blocker_eviction():
    def lc(m, d, clock, mgr, tr, rng):
        blocker, held = _slow(m, "blocker", "lq-0"), _slow(m, "held", "lq-1")
        mgr.upsert(blocker)
        d.schedule_once()
        mgr.sync()
        mgr.upsert(held)
        d.schedule_once()
        tr.snap(blocker, held, note="held")
        clock.t += 11.0
        d.schedule_once()
        mgr.sync()
        tr.snap(blocker, held, note="blocker evicted")
    rows = both(lc, nominal=4000, cqs=(("cq-0", "x"), ("cq-1", "y")),
                wfpr=dict(enable=True, block_admission=True,
                          timeout_seconds=10,
                          requeuing_backoff_base_seconds=1))
    assert rows[1][1][1][1] is False         # held started


# -- tests/test_job_webhooks.py: error lists ---------------------------


def _rq(m, **kw):
    return m.types.PodSetTopologyRequest(**kw)


WEBHOOK_CASES = {
    # (job builder, old-job builder or None)
    "queue-name": (lambda m: m.jobs.BatchJob(
        "j", parallelism=1, requests={"cpu": 1}, queue="Not_A_Queue"), None),
    "two-topology-annotations": (lambda m: m.jobs.BatchJob(
        "j", parallelism=1, requests={"cpu": 1}, queue="lq"), "topology"),
    "pytorch-unknown-replica": (lambda m: m.kubeflow.PyTorchJob(
        "bad", replicas=[
        m.kubeflow.ReplicaSpec(role="Master", replicas=1,
                               requests={"cpu": 100}),
        m.kubeflow.ReplicaSpec(role="Chief", replicas=2,
                               requests={"cpu": 100})], queue="lq"), None),
    "kubeflow-zero-replicas": (lambda m: m.kubeflow.PyTorchJob(
        "zero", replicas=[
        m.kubeflow.ReplicaSpec(role="Worker", replicas=0,
                               requests={"cpu": 100})], queue="lq"), None),
    "tfjob-duplicate-replica": (lambda m: m.kubeflow.TFJob("dup", replicas=[
        m.kubeflow.ReplicaSpec(role="Worker", replicas=1,
                               requests={"cpu": 100}),
        m.kubeflow.ReplicaSpec(role="Worker", replicas=2,
                               requests={"cpu": 100})], queue="lq"), None),
    "mpijob-topology-sorted": (lambda m: m.kubeflow.MPIJob("topo", replicas=[
        m.kubeflow.ReplicaSpec(role="Launcher", replicas=1,
                               requests={"cpu": 100},
                               topology_request=_rq(
                                   m, required="not a label!!")),
        m.kubeflow.ReplicaSpec(role="Worker", replicas=2,
                               requests={"cpu": 100},
                               topology_request=_rq(m, required="cloud/rack",
                                                    preferred="cloud/rack"))],
        queue="lq"), None),
    "mpijob-topology-ok": (lambda m: m.kubeflow.MPIJob("topo-ok", replicas=[
        m.kubeflow.ReplicaSpec(role="Launcher", replicas=1,
                               requests={"cpu": 100},
                               topology_request=_rq(
                                   m, required="cloud.google.com/rack")),
        m.kubeflow.ReplicaSpec(role="Worker", replicas=2,
                               requests={"cpu": 100})], queue="lq"), None),
    "rayjob-rules": (lambda m: m.ray.RayJob(
        "r", head_requests={"cpu": 100},
        worker_groups=[m.ray.WorkerGroupSpec(name="head")],
        shutdown_after_job_finishes=False,
        cluster_selector={"ray.io/cluster": "existing"},
        enable_in_tree_autoscaling=True, submission_mode="k8sjobmode",
        queue="lq"), None),
    "rayjob-too-many-groups": (lambda m: m.ray.RayJob(
        "m", head_requests={"cpu": 100},
        worker_groups=[m.ray.WorkerGroupSpec(name=f"g{i}") for i in range(7)]
        + [m.ray.WorkerGroupSpec(name="g0"),
           m.ray.WorkerGroupSpec(name="submitter")], queue="lq"), None),
    "jobset-rules": (lambda m: m.jobs.JobSet("js", replicated_jobs=[
        m.jobs.ReplicatedJobSpec(name="workers", replicas=0, parallelism=1),
        m.jobs.ReplicatedJobSpec(name="workers", replicas=1,
                                 parallelism=0)], queue="lq"), None),
    "pod-group-over": (lambda m: _group(m, "over", 1, 2), None),
    "pod-group-bad-name": (lambda m: _group(m, "Bad_Name", 0, 1), None),
    "plain-pod-managed-label": (lambda m: m.pod.PlainPod(m.pod.Pod(
        name="bad", labels={m.pod.MANAGED_LABEL: "nope"}), queue="lq"),
        None),
    "statefulset-resize": (lambda m: m.serving.StatefulSet(
        "web", replicas=5, requests={"cpu": 100}, queue="lq"),
        lambda m: m.serving.StatefulSet("web", replicas=3,
                                        requests={"cpu": 100}, queue="lq")),
    "statefulset-queue-frozen": (lambda m: m.serving.StatefulSet(
        "web", replicas=3, requests={"cpu": 100}, queue="other"),
        "ready-statefulset"),
    "statefulset-label-removed": (lambda m: m.serving.StatefulSet(
        "web", replicas=3, requests={"cpu": 100}),
        lambda m: m.serving.StatefulSet("web", replicas=3,
                                        requests={"cpu": 100}, queue="lq")),
    "batch-queue-moved-running": (lambda m: _running(m.jobs.BatchJob(
        "run", parallelism=1, requests={"cpu": 100}, queue="other",
        priority_class="p2")),
        lambda m: _running(m.jobs.BatchJob(
            "run", parallelism=1, requests={"cpu": 100}, queue="lq"))),
}


def _group(m, name, total, n):
    g = m.pod.PodGroup(name, total_count=total, queue="lq")
    for i in range(n):
        g.add_pod(m.pod.Pod(name=f"{name.lower()}-{i}",
                            requests={"cpu": 100}))
    return g


def _running(job):
    job.suspended = False
    return job


def _errors(m, case):
    build, old = WEBHOOK_CASES[case]
    job = build(m)
    wh = importlib.import_module(f"{m.jobframework.__name__}.webhook")
    if old == "topology":
        job.templates[0].topology_request = _rq(
            m, required="cloud.com/rack", preferred="cloud.com/block")
        old = None
    if old == "ready-statefulset":
        prev = m.serving.StatefulSet("web", replicas=3,
                                     requests={"cpu": 100}, queue="lq")
        prev.ready_replicas = 3
        old = lambda m: prev  # noqa: E731
    try:
        if old is None:
            wh.validate_job_create(job)
        else:
            wh.validate_job_update(old(m), job)
    except m.validation.ValidationError as e:
        return list(e.errors)
    return []


@pytest.mark.parametrize("case", sorted(WEBHOOK_CASES))
def test_webhook_errors_equal(case):
    want = _errors(front_door("kueue_tpu"), case)
    got = _errors(front_door("kueue_tpu_torch"), case)
    assert got == want
    assert bool(got) == (case != "mpijob-topology-ok")


POD_CASES = [
    dict(labels={"kueue.x-k8s.io/managed": "yes"}),
    dict(annotations={"kueue.x-k8s.io/pod-group-total-count": "3"}),
    dict(labels={"kueue.x-k8s.io/pod-group-name": "g"}),
    dict(labels={"kueue.x-k8s.io/pod-group-name": "g"},
         annotations={"kueue.x-k8s.io/pod-group-total-count": "three"}),
    dict(labels={"kueue.x-k8s.io/pod-group-name": "G_bad"},
         annotations={"kueue.x-k8s.io/pod-group-total-count": "0",
                      "kueue.x-k8s.io/retriable-in-group": "maybe"}),
    dict(labels={"kueue.x-k8s.io/pod-group-name": "g"},
         annotations={"kueue.x-k8s.io/pod-group-total-count": "3"}),
]


@pytest.mark.parametrize("i", range(len(POD_CASES)))
def test_pod_webhook_errors_equal(i):
    out = []
    for root in PACKAGES:
        m = front_door(root)
        new = m.pod.Pod(name="p", **POD_CASES[i])
        old = m.pod.Pod(name="p", labels={
            m.pod.GROUP_NAME_LABEL: "g"}, annotations={
            m.pod.GROUP_TOTAL_COUNT_ANNOTATION: "2",
            m.pod.RETRIABLE_IN_GROUP_ANNOTATION: "false"})
        bare = m.pod.Pod(name="bare", scheduling_gates=[],
                         labels=dict(POD_CASES[i].get("labels", {})))
        m.pod.default_pod(bare, queue="lq")
        out.append([m.pod.validate_pod_create(new),
                    m.pod.validate_pod_update(old, new),
                    m.pod.validate_pod_update(new, old),
                    dataclasses.asdict(bare), new.role_hash])
    assert out[1] == out[0]


def test_the_integration_registries_agree():
    """Each package registers the same integrations in its own registry
    (the registries are per package)."""
    names = []
    for root in PACKAGES:
        m = front_door(root)
        seen = []
        m.jobframework.for_each_integration(
            lambda cb: seen.append((cb.name, cb.gvk, cb.depends_on,
                                    cb.add_to_default)))
        names.append(seen)
    assert names[1] == names[0]
    assert {n[1] for n in names[1]} >= set(scenarios.JOB_KINDS)


def test_registering_an_integration_touches_one_package():
    jm, pm = front_door("kueue_tpu"), front_door("kueue_tpu_torch")
    cb = pm.jobframework.IntegrationCallbacks(
        name="example.com/widget", gvk="Widget", new_job=pm.jobs.BatchJob)
    interface = pm.jobframework.interface
    try:
        pm.jobframework.register_integration(cb)
        assert pm.jobframework.get_integration("Widget") is cb
        assert jm.jobframework.get_integration("Widget") is None
        with pytest.raises(ValueError, match="already registered"):
            pm.jobframework.register_integration(cb)
    finally:
        interface._registry.pop(cb.name, None)
        interface._by_gvk.pop(cb.gvk, None)
    assert pm.jobframework.get_integration("Widget") is None


def test_workload_names_agree():
    jm, pm = front_door("kueue_tpu"), front_door("kueue_tpu_torch")
    for gvk, name in (("BatchJob", "my-job"), ("PodGroup", "x" * 100),
                      ("PyTorchJob", "x" * 99)):
        assert (pm.jobframework.workload_name_for_job(gvk, name)
                == jm.jobframework.workload_name_for_job(gvk, name))


def test_podset_infos_agree():
    """podset.PodSetInfo from an assignment, an admission-check update
    and their merge (conflicts raise in both)."""
    out = []
    for root in PACKAGES:
        m = front_door(root)
        podset = __import__(f"{root}.podset", fromlist=["x"])
        t = m.types
        flavors = {"f": t.ResourceFlavor(
            name="f", node_labels={"zone": "a"},
            tolerations=[t.Toleration(key="k", value="v")])}
        psa = t.PodSetAssignment(name="main", count=0,
                                 flavors={"cpu": "f"})
        infos = podset.podset_infos_from_admission(
            [t.PodSet(name="main", count=3, requests={"cpu": 1})], [psa],
            flavors)
        podset.merge_podset_infos(infos, [podset.PodSetInfo.from_update(
            {"name": "main", "labels": {"l": "1"},
             "nodeSelector": {"disk": "ssd"}})])
        with pytest.raises(podset.BadPodSetsUpdateError) as e:
            infos[0].merge(podset.PodSetInfo.from_update(
                {"name": "main", "nodeSelector": {"zone": "b"}}))
        out.append([dataclasses.asdict(i) for i in infos] + [str(e.value)])
    assert out[1] == out[0]
