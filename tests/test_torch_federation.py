"""The remote plane of the port (``kueue_tpu_torch.remote``,
``admissionchecks.multikueue`` and ``federation``) against the JAX
package's: the four fault scenarios of tests/test_federation.py (the
federation sim at quick scale: the port's Drivers on the CPU, the JAX
package's on its host solver as the reference builds them), the
MultiKueue cases of tests/test_admissionchecks.py and the unit cases of
tests/test_federation.py (watch delivery order, token holdback,
ejection, the half-open circuit, assignment recovery, the HTTP client's
retry budget), each with the reference test's assertions on both
packages and every digest, assignment and check state equal between
the two.  Then chip_smoke.py phase 22's arms (``scenarios.fed_arm``,
federation_soak.py's ``run_arm``) small on both packages.  Tolerance
0."""

from __future__ import annotations

import importlib
import random
import socket
from types import SimpleNamespace

import pytest

from kueue_tpu_torch import scenarios
from tests.conftest import FakeClock

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def package(root):
    """Package ``root``'s modules that the cases use, and a Driver
    factory (the port's on the CPU)."""
    mods = {name.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{name}")
            for name in ("api.types", "chaos.injector", "controller.driver",
                         "remote", "federation.sim", "traffic",
                         "admissionchecks", "admissionchecks.multikueue",
                         "jobframework", "jobs", "utils.journal")}
    m = SimpleNamespace(**mods, root=root, chaos=mods["injector"],
                        fed=mods["sim"], mk=mods["multikueue"])
    cpu = {"device": "cpu"} if root == "kueue_tpu_torch" else {}
    m.driver = lambda clock=None, **kw: mods["driver"].Driver(
        **({"clock": clock} if clock is not None else {}), **cpu, **kw)
    m.fed_spec = lambda **kw: mods["sim"].FedSpec(**cpu, **kw)
    return m


@pytest.fixture(autouse=True)
def _chaos_off():
    for root in PACKAGES:
        importlib.import_module(f"{root}.chaos.injector").clear()
    yield
    for root in PACKAGES:
        importlib.import_module(f"{root}.chaos.injector").clear()


def both(fn, *a):
    """``fn`` on each package → its two results, asserted equal."""
    got = [fn(package(root), *a) for root in PACKAGES]
    assert got[0] == got[1]
    return got


# -- the federation sim's four fault scenarios ------------------------------

def quick_traffic(m, n_cqs=8, remote_cqs=4, n=40, seed=7):
    tr = m.traffic
    spec = tr.TrafficSpec(n_cqs=n_cqs, remote_fraction=0.5,
                          cancel_fraction=0.0, churn_fraction=0.0)
    evs = tr.ArrivalStream(tr.PoissonProcess(6.0, seed=seed), spec,
                           seed=seed).take(n)
    by_step, _ = m.fed.schedule_traffic(evs, n_cqs=n_cqs,
                                        remote_cqs=remote_cqs)
    return by_step


def quick_sim(m, tmp_path, tag, arm=None, **kw):
    m.chaos.clear()
    spec = m.fed_spec(n_workers=4, n_cqs=8, remote_cqs=4, seed=7, **kw)
    sim = m.fed.FederationSim(spec, wal_dir=str(tmp_path / m.root / tag))
    sim.load_traffic(quick_traffic(m))
    if arm is not None:
        arm(m.chaos.install(m.chaos.ChaosInjector(seed=7)))
    settled = sim.run(10, drain_max=120)
    m.chaos.clear()
    return sim, settled


def partition(i):
    i.arm("fed.partition", at=6, action="partition",
          payload=(("w2", "w3"), 3))


def storm(i):
    i.arm("remote.duplicate_event", prob=0.25, times=60, action="duplicate")
    i.arm("remote.duplicate", prob=0.10, times=60, action="duplicate")


def crash(i):
    i.arm("fed.worker_crash", at=3, payload="w0")


def loss(i):
    i.arm("fed.cluster_loss", at=3, payload="w0")


SCENARIOS = {
    "partition_rejoin": (partition, {}),
    "duplicate_watch_storm": (storm, {"chaos_transport": True}),
    "worker_crash_mid_sync": (crash, {}),
    "cluster_loss_failover": (loss, {"worker_lost_timeout": 2.0}),
}


def run_scenario(m, tmp_path, name):
    arm, kw = SCENARIOS[name]
    ctl, ok_c = quick_sim(m, tmp_path, "ctl", **kw)
    fault, ok_f = quick_sim(m, tmp_path, name, arm=arm, **kw)
    assert ok_c and ok_f
    assert fault.violations == []
    if name == "cluster_loss_failover":
        assert fault.counters["ejections"] > 0
        assert not fault.clusters["w0"].active
        assert m.fed.outcome(fault) == m.fed.outcome(ctl)
        assert all(v for v in m.fed.outcome(fault).values())
        assert all(len(ws) == 1 for ws in fault._finished_on.values())
    else:
        assert m.fed.global_digest(fault) == m.fed.global_digest(ctl)
    if name == "partition_rejoin":
        assert all(c.active for c in fault.clusters.values())
    if name == "worker_crash_mid_sync":
        assert fault.counters["mid_admit_crashes"] == 1
        assert fault.counters["wal_tail_replayed"] >= 1
    return (m.fed.global_digest(ctl), m.fed.global_digest(fault),
            m.fed.outcome(fault), dict(fault.counters),
            fault.assignment_spread())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_federation_scenario_on_both_packages(name, tmp_path):
    """tests/test_federation.py's scenario on each package: its parity
    with the fault-free control, and both packages' global digests (and
    counters, outcomes, placement spread) equal."""
    both(run_scenario, tmp_path, name)


# -- the MultiKueue cases of tests/test_admissionchecks.py ------------------

def make_cluster(m, clock, nominal=5000, checks=()):
    t = m.types
    d = m.driver(clock)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for c in checks:
        d.apply_admission_check(t.AdmissionCheck(name=c))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", admission_checks=list(checks),
        resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="default", resources={
                "cpu": t.ResourceQuota(nominal=nominal)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    return d


def wl(m, name, cpu=1000, created=1.0, prio=0):
    t = m.types
    return t.Workload(name=name, queue_name="lq", creation_time=created,
                      priority=prio,
                      pod_sets=[t.PodSet(name="main", count=1,
                                         requests={"cpu": cpu})])


def multikueue_setup(m, worker_capacities=(5000, 5000)):
    clock = FakeClock()
    manager = make_cluster(m, clock, nominal=10_000, checks=("mk",))
    clusters = {}
    for i, cap in enumerate(worker_capacities):
        clusters[f"worker-{i}"] = m.admissionchecks.WorkerCluster(
            name=f"worker-{i}", driver=make_cluster(m, clock, nominal=cap))
    ctrl = m.admissionchecks.MultiKueueController(
        manager, check_name="mk",
        config=m.types.MultiKueueConfig(name="mk-config",
                                        clusters=sorted(clusters)),
        clusters=clusters, worker_lost_timeout=300.0)
    return clock, manager, clusters, ctrl


def pump(manager, clusters, ctrl, rounds=4):
    for _ in range(rounds):
        manager.run_until_settled()
        ctrl.reconcile()
        for c in clusters.values():
            if c.active:
                c.driver.run_until_settled()
        ctrl.reconcile()


def check_states(m, manager, clusters):
    """Every manager workload's check states and finish, and which
    worker holds which mirror."""
    return ({k: (sorted((n, s.state.value, s.message)
                        for n, s in w.admission_check_states.items()),
                 w.is_admitted, w.is_finished)
             for k, w in sorted(manager.workloads.items())},
            {n: sorted(c.driver.workloads) for n, c in clusters.items()},
            m.remote.state_digest(manager))


def mk_dispatch_first_reservation_wins(m):
    clock, manager, clusters, ctrl = multikueue_setup(m)
    manager.create_workload(wl(m, "job-a"))
    pump(manager, clusters, ctrl)
    mwl = manager.workloads["default/job-a"]
    st = mwl.admission_check_states["mk"]
    assert st.state == m.types.AdmissionCheckState.READY
    assert mwl.is_admitted
    holders = [n for n, c in clusters.items()
               if "default/job-a" in c.driver.workloads]
    assert len(holders) == 1
    assert holders[0] in st.message
    return check_states(m, manager, clusters)


def mk_remote_finish_propagates(m):
    clock, manager, clusters, ctrl = multikueue_setup(m)
    manager.create_workload(wl(m, "job-b"))
    pump(manager, clusters, ctrl)
    holder = next(n for n, c in clusters.items()
                  if "default/job-b" in c.driver.workloads)
    clusters[holder].driver.finish_workload("default/job-b",
                                            "Finished on worker")
    pump(manager, clusters, ctrl)
    assert manager.workloads["default/job-b"].is_finished
    return check_states(m, manager, clusters)


def mk_worker_loss_ejects_and_redispatches(m):
    clock, manager, clusters, ctrl = multikueue_setup(m)
    manager.create_workload(wl(m, "job-c"))
    pump(manager, clusters, ctrl)
    holder = next(n for n, c in clusters.items()
                  if "default/job-c" in c.driver.workloads)
    other = next(n for n in clusters if n != holder)
    clusters[holder].client.ok = False
    clusters[holder].mark_lost(clock())
    clock.tick(301.0)
    pump(manager, clusters, ctrl)
    mwl = manager.workloads["default/job-c"]
    assert "default/job-c" in clusters[other].driver.workloads
    assert (mwl.admission_check_states["mk"].state
            == m.types.AdmissionCheckState.READY)
    return check_states(m, manager, clusters)


def mk_gc_removes_orphans(m):
    clock, manager, clusters, ctrl = multikueue_setup(m)
    manager.create_workload(wl(m, "job-d"))
    pump(manager, clusters, ctrl)
    manager.delete_workload("default/job-d")
    ctrl.reconcile()
    ctrl.run_gc()
    for c in clusters.values():
        assert "default/job-d" not in c.driver.workloads
    return check_states(m, manager, clusters)


def mk_job_level_dispatch(m):
    clock = FakeClock()
    manager = make_cluster(m, clock, nominal=10_000, checks=("mk",))
    manager_jm = m.jobframework.JobManager(manager)
    clusters, worker_jms = {}, {}
    for i in range(2):
        wd = make_cluster(m, clock, nominal=5000)
        clusters[f"worker-{i}"] = m.admissionchecks.WorkerCluster(
            name=f"worker-{i}", driver=wd)
        worker_jms[f"worker-{i}"] = m.jobframework.JobManager(wd)
    ctrl = m.admissionchecks.MultiKueueController(
        manager, check_name="mk",
        config=m.types.MultiKueueConfig(name="mk-config",
                                        clusters=sorted(clusters)),
        clusters=clusters, manager_jobs=manager_jm, worker_jobs=worker_jms)
    job = m.jobs.BatchJob("train", parallelism=2, requests={"cpu": 1000},
                          queue="lq",
                          managed_by=m.mk.MULTIKUEUE_CONTROLLER_NAME)
    manager_jm.jobs[job.key] = job
    manager.create_workload(manager_jm.reconciler._construct_workload(job))

    def pump_jobs(rounds=4):
        for _ in range(rounds):
            manager.run_until_settled()
            ctrl.reconcile()
            for name, c in clusters.items():
                if c.active:
                    worker_jms[name].run(max_rounds=3)
            ctrl.reconcile()
            manager_jm.sync()

    pump_jobs()
    wl_key = manager_jm.reconciler.workload_key_for(job)
    mwl = manager.workloads[wl_key]
    assert (mwl.admission_check_states["mk"].state
            == m.types.AdmissionCheckState.READY)
    assert mwl.is_admitted
    assert job.is_suspended()
    holder = next(n for n, jm in worker_jms.items() if job.key in jm.jobs)
    worker_job = worker_jms[holder].jobs[job.key]
    assert not worker_job.is_suspended()
    assert sum(1 for jm in worker_jms.values() if job.key in jm.jobs) == 1
    worker_job.complete_pods(2)
    pump_jobs()
    assert job.succeeded == 2
    assert manager.workloads[wl_key].is_finished
    return holder, check_states(m, manager, clusters)


MULTIKUEUE = {fn.__name__[3:]: fn for fn in (
    mk_dispatch_first_reservation_wins, mk_remote_finish_propagates,
    mk_worker_loss_ejects_and_redispatches, mk_gc_removes_orphans,
    mk_job_level_dispatch)}


@pytest.mark.parametrize("name", sorted(MULTIKUEUE))
def test_multikueue_case_on_both_packages(name):
    """tests/test_admissionchecks.py's MultiKueue case on each package;
    every check state, mirror placement and the manager's state digest
    equal."""
    both(MULTIKUEUE[name])


# -- the unit cases of tests/test_federation.py -----------------------------

def make_worker(m, clock, nominal=8000):
    t = m.types
    d = m.driver(clock)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"], flavors=[
                t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=nominal)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    return d


def make_manager(m, clock, nominal=8000):
    t = m.types
    d = m.driver(clock)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    d.apply_admission_check(t.AdmissionCheck(
        name="mk", controller_name="kueue.x-k8s.io/multikueue"))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", admission_checks=["mk"],
        resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"], flavors=[
                t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=nominal)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    return d


def fwl(m, name, cpu=1000, prio=0, t=0.0):
    return wl(m, name, cpu=cpu, created=t, prio=prio)


def _run_shuffled_arm(m, seed):
    clock = FakeClock()
    mgr = make_manager(m, clock)
    workers = {"w0": make_worker(m, clock, nominal=2000),
               "w1": make_worker(m, clock, nominal=8000)}
    clusters = {n: m.mk.WorkerCluster(name=n, driver=d)
                for n, d in workers.items()}
    ctl = m.mk.MultiKueueController(
        mgr, "mk", m.types.MultiKueueConfig(name="cfg",
                                            clusters=["w0", "w1"]),
        clusters, worker_lost_timeout=60.0)
    for c in clusters.values():
        c.watch = m.remote.WatchLoop(c.client, poll_timeout=0.0)
    rng = random.Random(seed)

    def pump_shuffled():
        for c in clusters.values():
            w = c.watch
            batch, nxt, epoch = c.client.watch_events(w.since, timeout=0.0)
            w._epoch = epoch
            w.since = nxt
            batch = list(batch) + [e for e in batch if rng.random() < 0.5]
            rng.shuffle(batch)
            for ev in batch:
                w.events.put(tuple(ev))

    for i in range(6):
        mgr.create_workload(fwl(m, f"j{i}", prio=i % 3, t=float(i)))
    mgr.run_until_settled()
    clock.tick()
    ctl.reconcile()
    for _ in range(12):
        if (len(ctl.assignments) == 6
                and all(a.cluster for a in ctl.assignments.values())):
            break
        for d in workers.values():
            d.schedule_once()
        pump_shuffled()
        clock.tick()
        ctl.reconcile()
    placed = {k: a.cluster for k, a in sorted(ctl.assignments.items())}
    for name, d in workers.items():
        for key in list(d.workloads):
            asg = ctl.assignments.get(key)
            if (asg is not None and asg.cluster == name
                    and d.workloads[key].has_quota_reservation):
                d.finish_workload(key)
    pump_shuffled()
    clock.tick()
    ctl.reconcile()
    return (placed,
            {k: (w.admission_check_states["mk"].state.value, w.is_finished)
             for k, w in sorted(mgr.workloads.items())},
            {n: sorted(d.workloads) for n, d in workers.items()})


def u_delivery_order_convergence_across_seeds(m):
    results = [_run_shuffled_arm(m, seed) for seed in range(10)]
    assignments, states, mirrors = results[0]
    assert set(assignments.values()) == {"w0", "w1"}
    assert all(s == ("Ready", True) for s in states.values())
    for r in results[1:]:
        assert r == results[0]
    return results[0]


def u_duplicate_event_token_holdback_is_idempotent(m):
    clock = FakeClock()
    d = make_worker(m, clock)
    d.create_workload(fwl(m, "a"))
    d.schedule_once()
    w = m.remote.WatchLoop(m.remote.LocalWorkerClient(d), poll_timeout=0.0)
    m.chaos.install(m.chaos.ChaosInjector(seed=3)).arm(
        "remote.duplicate_event", at=1, action="duplicate")
    n1 = w.pump()
    assert n1 > 0 and w.since == 0
    m.chaos.clear()
    n2 = w.pump()
    assert n2 == n1 and w.since == n1
    seen = []
    while not w.events.empty():
        seen.append(w.events.get_nowait())
    assert seen[:n1] == seen[n1:]
    return seen


def _two_cluster_ctl(m, clock, budget=0):
    mgr = make_manager(m, clock)
    workers = {"w0": make_worker(m, clock), "w1": make_worker(m, clock)}
    clusters = {n: m.mk.WorkerCluster(name=n, driver=d,
                                      reconnect_budget=budget)
                for n, d in workers.items()}
    ctl = m.mk.MultiKueueController(
        mgr, "mk", m.types.MultiKueueConfig(name="cfg",
                                            clusters=["w0", "w1"]),
        clusters, worker_lost_timeout=3.0)
    return mgr, workers, clusters, ctl


def u_eject_queues_pending_deletes_and_redispatches(m):
    clock = FakeClock()
    mgr, workers, clusters, ctl = _two_cluster_ctl(m, clock)
    mgr.create_workload(fwl(m, "a"))
    mgr.run_until_settled()
    ctl.reconcile()
    workers["w0"].schedule_once()
    clock.tick()
    ctl.reconcile()
    assert ctl.assignments["default/a"].cluster == "w0"
    clusters["w0"].client.ok = False
    clock.tick()
    ctl.reconcile()
    clock.tick(5.0)
    for _ in range(4):
        ctl.reconcile()
        mgr.queues.queue_inadmissible_workloads(["cq"])
        mgr.run_until_settled()
        workers["w1"].schedule_once()
        ctl.reconcile()
        clock.tick(2.0)
    assert "default/a" in ctl.pending_deletes.get("w0", set())
    assert ctl.assignments["default/a"].cluster == "w1"
    assert "default/a" in workers["w1"].admitted_keys()
    clusters["w0"].client.ok = True
    clock.tick(120.0)
    ctl.reconcile()
    assert clusters["w0"].active and not clusters["w0"].half_open
    assert "w0" not in ctl.pending_deletes
    assert "default/a" not in workers["w0"].workloads
    return check_states(m, mgr, clusters)


def u_half_open_trial_failure_escalates_backoff(m):
    c = m.mk.WorkerCluster(name="w", driver=m.driver())
    c.mark_lost(100.0)
    trace = [(c.active, c.retry_backoff)]
    assert not c.active and c.retry_backoff == 1.0
    assert not c.try_reconnect(100.5)
    assert c.try_reconnect(101.5)
    assert c.half_open and not c.active
    c.mark_lost(102.0)
    assert c.retry_backoff == 2.0 and not c.half_open
    assert c.try_reconnect(105.0)
    c.mark_lost(106.0)
    assert c.retry_backoff == 4.0
    assert c.try_reconnect(111.0)
    c.reconnect()
    assert c.active and c.retry_backoff == 1.0 and c.reconnect_attempts == 0
    return trace + [(c.active, c.retry_backoff, c.reconnect_attempts)]


def u_reconnect_budget_exhaustion_is_permanent(m):
    d = m.driver()
    client = m.remote.LocalWorkerClient(d)
    client.ok = False
    c = m.mk.WorkerCluster(name="w", driver=d, client=client,
                           reconnect_budget=2)
    c.mark_lost(100.0)
    assert not c.try_reconnect(102.0)
    assert not c.failed_permanently
    assert not c.try_reconnect(110.0)
    assert c.failed_permanently
    client.ok = True
    assert not c.try_reconnect(1000.0)
    return c.failed_permanently, c.reconnect_attempts


def u_recover_assignments_rebuilds_from_worker_listings(m):
    clock = FakeClock()
    mgr, workers, clusters, ctl = _two_cluster_ctl(m, clock)
    mgr.create_workload(fwl(m, "a"))
    mgr.create_workload(fwl(m, "b", t=1.0))
    mgr.run_until_settled()
    ctl.reconcile()
    workers["w0"].schedule_once()
    clock.tick()
    ctl.reconcile()
    before = {k: (a.cluster, tuple(a.nominated))
              for k, a in ctl.assignments.items()}
    ctl2 = m.mk.MultiKueueController(
        mgr, "mk", m.types.MultiKueueConfig(name="cfg",
                                            clusters=["w0", "w1"]),
        clusters, worker_lost_timeout=3.0)
    assert ctl2.assignments == {}
    assert ctl2.recover_assignments() == 2
    after = {k: (a.cluster, tuple(a.nominated))
             for k, a in ctl2.assignments.items()}
    assert after == before
    return sorted(after.items())


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def u_http_client_retries_then_surfaces_loss(m):
    c = m.remote.HttpWorkerClient(f"http://127.0.0.1:{_dead_port()}",
                                  timeout=0.2, retries=2, backoff_base=0.001,
                                  backoff_max=0.004, deadline_s=30.0)
    with pytest.raises(m.remote.ConnectionLost):
        c.list_workload_keys()
    assert c.stats["requests"] == 3
    assert c.stats["retries"] == 2
    assert not c.healthy()
    assert c.stats["requests"] == 4
    return c.stats["requests"], c.stats["retries"]


def u_http_client_deadline_budget_caps_retries(m):
    c = m.remote.HttpWorkerClient(f"http://127.0.0.1:{_dead_port()}",
                                  timeout=0.2, retries=50, backoff_base=0.5,
                                  backoff_max=1.0, deadline_s=0.2)
    with pytest.raises(m.remote.ConnectionLost):
        c.list_workload_keys()
    assert c.stats["deadline_exhausted"] == 1
    assert c.stats["requests"] < 5
    return c.stats["deadline_exhausted"]


def u_http_client_jitter_is_deterministic(m):
    j = m.remote.HttpWorkerClient._jitter
    assert j("/apis/workloads", 1) == j("/apis/workloads", 1)
    assert 0.0 <= j("/apis/workloads", 1) < 1.0
    assert j("/apis/workloads", 1) != j("/apis/workloads", 2)
    return [j("/apis/workloads", k) for k in range(8)]


def u_local_client_severed_raises_on_mutations(m):
    d = make_worker(m, FakeClock())
    client = m.remote.LocalWorkerClient(d)
    client.ok = False
    for op in (lambda: client.create_workload(fwl(m, "x")),
               lambda: client.get_workload("default/x"),
               lambda: client.delete_workload("default/x"),
               lambda: client.list_workloads(),
               lambda: client.finish_workload("default/x", "m")):
        with pytest.raises(m.remote.ConnectionLost):
            op()
    assert not client.healthy()
    return client.healthy()


UNITS = {name[2:]: fn for name, fn in globals().items()
         if name.startswith("u_")}


@pytest.mark.parametrize("name", sorted(UNITS))
def test_remote_unit_case_on_both_packages(name):
    """tests/test_federation.py's unit case on each package, what it
    observed equal."""
    both(UNITS[name])


# -- chip_smoke.py phase 22's arms, small ------------------------------------

FED_CFG = dict(cqs=16, remote_cqs=4, workers=4, events=80, rate=8.0,
               steps=12, drain_max=400)


def fed_phase(m, tmp):
    seed = 1513
    ctl, ok_c = scenarios.fed_arm(FED_CFG, seed, str(tmp / "c"), m=m)
    at = max(2, FED_CFG["steps"] // 3)
    fault, ok_f = scenarios.fed_arm(
        FED_CFG, seed, str(tmp / "f"), m=m,
        arm=lambda i: i.arm("fed.worker_crash", at=at,
                            payload=ctl.worker_names[0]))
    assert ok_c and ok_f
    assert fault.violations == [] and ctl.violations == []
    assert scenarios.fed_double_admissions(fault) == 0
    assert fault.counters["worker_crashes"] == 1
    assert fault.counters["mid_admit_crashes"] >= 1
    assert fault.counters["wal_tail_replayed"] >= 1
    assert m.fed.global_digest(fault) == m.fed.global_digest(ctl)
    return m.fed.global_digest(ctl), dict(fault.counters)


def test_fed_phase_arms_on_both_packages(tmp_path):
    """federation_soak.py's ``worker_crash_mid_sync`` against its
    fault-free control through ``scenarios.fed_arm`` on each package
    (the port's ``serving_modules("cpu")``): strict parity, no double
    admission, the WAL tail replayed, and the global digests equal
    between the packages."""
    got = [fed_phase(m, tmp_path / str(i)) for i, m in enumerate((
        package("kueue_tpu"), scenarios.serving_modules("cpu")))]
    assert got[0] == got[1]


def test_fedspec_device_reaches_every_driver(tmp_path):
    """``FedSpec.device`` builds the manager, every worker and a worker
    recovered after a crash on that device, each on the device solver;
    ``ProcFederation(device=...)`` builds its manager there."""
    from kueue_tpu_torch.federation.procs import ProcFederation
    m = package("kueue_tpu_torch")
    sim, _ = quick_sim(m, tmp_path, "crash", arm=crash)
    assert sim.counters["worker_crashes"] == 1
    for d in [sim.manager, *sim.workers.values()]:
        assert d.device == "cpu"
        assert d.scheduler.solver.device.type == "cpu"
    fed = ProcFederation({"w0": "http://127.0.0.1:1"}, device="cpu")
    assert fed.manager.scheduler.solver.device.type == "cpu"
    assert m.fed.FedSpec().device == "cuda"
