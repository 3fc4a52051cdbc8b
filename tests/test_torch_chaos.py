"""Every chaos site of the port armed by a port test, as the JAX package's
own tests arm them (tests/test_chaos_recovery.py, test_federation.py,
test_obs.py, test_wal_shards.py, test_socket_faults.py): a crash between
the WAL append and the store mutation (``wal.admit`` / ``evict`` /
``finish`` / ``requeue``), at and inside a fused burst window, a forced
speculation divergence, journal corruption, a partitioned and a delayed
MultiKueue transport, a crashed flight-recorder dump, crashes in and
between WAL segment compactions, and wire faults through the socket
proxy.  The driver arms run on the port's ``Driver(device="cpu")`` and
must end in the JAX package's state for the same arm, timestamps
included; the unit arms run on both packages."""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def mods(root):
    imp = importlib.import_module
    return SimpleNamespace(
        root=root, t=imp(f"{root}.api.types"),
        chaos=imp(f"{root}.chaos.injector"),
        driver=imp(f"{root}.controller.driver"),
        journal=imp(f"{root}.utils.journal"),
        remote=imp(f"{root}.remote"), proxy=imp(f"{root}.dist.proxy"),
        worker=imp(f"{root}.dist.worker"))


@pytest.fixture(autouse=True)
def _chaos_off():
    """Chaos must never leak into the rest of the suite."""
    for root in PACKAGES:
        mods(root).chaos.clear()
    yield
    for root in PACKAGES:
        mods(root).chaos.clear()


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def make_driver(m, clock, **kw):
    """The JAX package's Driver on its device solver, the port's on
    "cpu" (its device solver's plain kernels)."""
    if m.root == "kueue_tpu":
        return m.driver.Driver(clock=clock, use_device_solver=True, **kw)
    return m.driver.Driver(clock=clock, device="cpu", **kw)


def mk(m, name, lq, cpu, prio=0, t=0.0):
    return m.t.Workload(name=name, queue_name=lq, priority=prio,
                        creation_time=t,
                        pod_sets=[m.t.PodSet(name="main", count=1,
                                             requests={"cpu": cpu})])


def simple_cluster(m, n_cohorts=2, cqs=2, nominal=4000):
    t = m.t

    def fn(d):
        d.apply_resource_flavor(t.ResourceFlavor(name="default"))
        for c in range(n_cohorts):
            for q in range(cqs):
                name = f"cq-{c}-{q}"
                d.apply_cluster_queue(t.ClusterQueue(
                    name=name, cohort=f"co-{c}",
                    queueing_strategy=t.QueueingStrategy.BEST_EFFORT_FIFO,
                    preemption=t.PreemptionPolicy(),
                    resource_groups=[t.ResourceGroup(
                        covered_resources=["cpu"],
                        flavors=[t.FlavorQuotas(name="default", resources={
                            "cpu": t.ResourceQuota(nominal=nominal)})])]))
                d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                                 cluster_queue=name))
    return fn


def with_workloads(spec, wls):
    def fn(d):
        spec(d)
        for wl in wls:
            d.create_workload(wl)
    return fn


def drain_spec(m):
    """tests/test_chaos_recovery.py drain_spec: more pending than quota,
    runtime-driven finishes, BEST_EFFORT_FIFO."""
    wls, n = [], 0
    for c in range(2):
        for q in range(2):
            for i in range(6):
                n += 1
                wls.append(mk(m, f"w-{c}-{q}-{i}", f"lq-{c}-{q}", 1500,
                              prio=(i % 3) * 10, t=float(n)))
    return with_workloads(simple_cluster(m), wls)


def sustained_spec(m, per_cq=36):
    """tests/test_burst_pipeline.py sustained_spec: more than one K = 32
    window of work on 2 CQs."""
    wls, n = [], 0
    for q in range(2):
        for i in range(per_cq):
            n += 1
            wls.append(mk(m, f"w-{q}-{i}", f"lq-0-{q}", 2000,
                          prio=(i % 3) * 10, t=float(n)))
    return with_workloads(simple_cluster(m, n_cohorts=1, cqs=2), wls)


def build(m, spec):
    clock = Clock()
    d = make_driver(m, clock)
    spec(d)
    return d, clock


def resume_host(d, clock, cycles, runtime, out, tick_first=True):
    while len(out) < cycles:
        c = len(out)
        if tick_first:
            clock.t += 1.0
        tick_first = True
        stats = d.schedule_once()
        out.append(stats)
        if runtime > 0 and c - runtime >= 0:
            for key in out[c - runtime].admitted:
                w = d.workloads.get(key)
                if w is not None and w.has_quota_reservation:
                    d.finish_workload(key)
    return out


def run_host_until_crash(m, d, clock, cycles, runtime):
    out = []
    try:
        resume_host(d, clock, cycles, runtime, out)
    except m.chaos.InjectedCrash:
        return out, True
    return out, False


def run_burst_until_crash(m, d, clock, cycles, runtime):
    recs = []

    def on_cycle_start(_k):
        clock.t += 1.0

    def on_cycle(_k, stats):
        recs.append(stats)

    try:
        d.schedule_burst(cycles, runtime=runtime,
                         on_cycle_start=on_cycle_start, on_cycle=on_cycle)
    except m.chaos.InjectedCrash:
        return recs, True
    return recs, False


def full_state(d):
    """Every workload's durable status, timestamps included."""
    out = {}
    for key, w in d.workloads.items():
        out[key] = (
            w.is_finished, w.is_active, w.has_quota_reservation,
            None if w.admission is None else (
                w.admission.cluster_queue,
                tuple((a.name, tuple(sorted(a.flavors.items())),
                       tuple(sorted(a.resource_usage.items())), a.count)
                      for a in w.admission.pod_set_assignments)),
            tuple(sorted((c.type, c.status.value, c.reason, c.message,
                          c.last_transition_time)
                         for c in w.conditions.values())),
            tuple(sorted((s.name, s.state.value)
                         for s in w.admission_check_states.values())),
            None if w.requeue_state is None else
            (w.requeue_state.count, w.requeue_state.requeue_at))
    return out


def admitted_prefix(crashed, control):
    return all(sorted(x.admitted) == sorted(y.admitted)
               for x, y in zip(crashed, control))


def recover(m, spec, crashed, wal):
    d2 = make_driver(m, crashed.clock)
    spec(d2)
    d2.recover_from(crashed.workloads.values(), wal)
    return d2


def on_both(arm, tmp_path):
    """Run ``arm(m, dir)`` on both packages; the port's result must equal
    the JAX package's."""
    out = {}
    for root in PACKAGES:
        d = tmp_path / root
        d.mkdir()
        out[root] = arm(mods(root), d)
        mods(root).chaos.clear()
    assert out["kueue_tpu_torch"] == out["kueue_tpu"]
    return out["kueue_tpu_torch"]


# ---------------------------------------------------------------------------
# WAL crash sites on the driver (wal.admit / evict / finish / requeue)
# ---------------------------------------------------------------------------

def arm_crash_mid_admit(m, tmp):
    """The admit op journaled, the store write never landed: recovery
    rolls the tail forward and converges on the control arm."""
    dc, cc = build(m, drain_spec(m))
    control = resume_host(dc, cc, 12, 2, [])
    d1, c1 = build(m, drain_spec(m))
    wal = m.journal.CycleWAL(str(tmp / "wal.jsonl"))
    d1.attach_wal(wal)
    m.chaos.install(m.chaos.ChaosInjector(seed=3)).arm("wal.admit", at=5)
    out, crashed = run_host_until_crash(m, d1, c1, 12, 2)
    assert crashed
    tail_admits = {op["key"] for op in wal.tail if op["op"] == "admit"}
    assert tail_admits
    m.chaos.clear()
    d2 = recover(m, simple_cluster(m), d1, wal)
    k = len(out)
    resume_host(d2, c1, k + 1, 2, out, tick_first=False)
    assert tail_admits <= set(control[k].admitted)
    assert set(out[k].admitted) == set(control[k].admitted) - tail_admits
    out[k].admitted.extend(sorted(tail_admits))
    resume_host(d2, c1, 12, 2, out)
    assert admitted_prefix(out, control)
    assert full_state(d2) == full_state(dc)
    return full_state(d2)


def test_crash_mid_admit_replays_wal_tail(tmp_path):
    on_both(arm_crash_mid_admit, tmp_path)


def _pods_ready_driver(m, clock):
    return make_driver(m, clock, wait_for_pods_ready=(
        m.driver.WaitForPodsReadyConfig(
            enable=True, timeout_seconds=30.0,
            requeuing_backoff_base_seconds=10,
            requeuing_backoff_max_seconds=100)))


def arm_crash_mid_evict(m, tmp):
    """Crash between the evict op's journal write and the status
    mutations: replay lands the eviction and the requeue exactly once."""
    def mk_driver(clock):
        d = _pods_ready_driver(m, clock)
        simple_cluster(m, n_cohorts=1, cqs=1)(d)
        d.create_workload(mk(m, "slow", "lq-0-0", 1000, t=1.0))
        return d

    clock_c, clock_x = Clock(), Clock()
    dc = mk_driver(clock_c)
    dc.run_until_settled()
    clock_c.tick(31.0)
    dc.evict_for_pods_ready_timeout("default/slow")
    d1 = mk_driver(clock_x)
    wal = m.journal.CycleWAL()
    d1.attach_wal(wal)
    d1.run_until_settled()
    clock_x.tick(31.0)
    m.chaos.install(m.chaos.ChaosInjector(seed=1)).arm("wal.evict", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        d1.evict_for_pods_ready_timeout("default/slow")
    m.chaos.clear()
    kinds = [op["op"] for op in wal.tail]
    assert "requeue" in kinds and "evict" in kinds
    d2 = _pods_ready_driver(m, clock_x)
    simple_cluster(m, n_cohorts=1, cqs=1)(d2)
    assert d2.recover_from(d1.workloads.values(), wal) >= 1
    assert full_state(d2) == full_state(dc)
    assert d2.workloads["default/slow"].requeue_state.count == 1
    clock_c.tick(70.0)
    clock_x.t = clock_c.t
    for d in (dc, d2):
        d.queues.queue_inadmissible_workloads(["cq-0-0"])
        d.run_until_settled()
        assert "default/slow" in d.admitted_keys()
    assert full_state(d2) == full_state(dc)
    return full_state(d2)


def test_crash_mid_evict_replays_requeue_and_eviction(tmp_path):
    on_both(arm_crash_mid_evict, tmp_path)


def arm_crash_mid_finish(m, tmp):
    def mk_driver(clock):
        d = make_driver(m, clock)
        simple_cluster(m, n_cohorts=1, cqs=1)(d)
        d.create_workload(mk(m, "job", "lq-0-0", 1000, t=1.0))
        return d

    clock_c, clock_x = Clock(), Clock()
    dc = mk_driver(clock_c)
    dc.run_until_settled()
    clock_c.tick(5.0)
    dc.finish_workloads(["default/job"], message="done")
    d1 = mk_driver(clock_x)
    wal = m.journal.CycleWAL()
    d1.attach_wal(wal)
    d1.run_until_settled()
    clock_x.tick(5.0)
    m.chaos.install(m.chaos.ChaosInjector(seed=2)).arm("wal.finish", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        d1.finish_workloads(["default/job"], message="done")
    m.chaos.clear()
    assert [op["op"] for op in wal.tail] == ["finish"]
    assert not d1.workloads["default/job"].is_finished
    d2 = make_driver(m, clock_x)
    simple_cluster(m, n_cohorts=1, cqs=1)(d2)
    assert d2.recover_from(d1.workloads.values(), wal) >= 1
    assert d2.workloads["default/job"].is_finished
    for d in (dc, d2):
        d.create_workload(mk(m, "next", "lq-0-0", 1000, t=10.0))
        d.run_until_settled()
        assert "default/next" in d.admitted_keys()
    assert full_state(d2) == full_state(dc)
    return full_state(d2)


def test_crash_mid_finish_replays_wal_tail(tmp_path):
    on_both(arm_crash_mid_finish, tmp_path)


def arm_wal_requeue(m, tmp):
    """Crash exactly at ``wal.requeue``: the requeue op is in the tail,
    the workload untouched; recovery applies the backoff once."""
    clock = Clock()
    d1 = _pods_ready_driver(m, clock)
    simple_cluster(m, n_cohorts=1, cqs=1)(d1)
    d1.create_workload(mk(m, "slow", "lq-0-0", 1000, t=1.0))
    wal = m.journal.CycleWAL()
    d1.attach_wal(wal)
    d1.run_until_settled()
    clock.tick(31.0)
    m.chaos.install(m.chaos.ChaosInjector(seed=5)).arm("wal.requeue", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        d1.evict_for_pods_ready_timeout("default/slow")
    m.chaos.clear()
    ops = [op for op in wal.tail if op["op"] == "requeue"]
    assert len(ops) == 1
    assert d1.workloads["default/slow"].requeue_state is None
    assert not any(op["op"] == "evict" for op in wal.tail)
    d2 = _pods_ready_driver(m, clock)
    simple_cluster(m, n_cohorts=1, cqs=1)(d2)
    assert d2.recover_from(d1.workloads.values(), wal) >= 1
    rs = d2.workloads["default/slow"].requeue_state
    assert rs is not None and rs.count == 1 and rs.requeue_at == ops[0]["at"]
    assert "default/slow" in d2.admitted_keys()
    return full_state(d2)


def test_wal_requeue_journal_precedes_mutation(tmp_path):
    on_both(arm_wal_requeue, tmp_path)


# ---------------------------------------------------------------------------
# the fused burst (burst.window_boundary / mid_window / force_spec_divergence)
# ---------------------------------------------------------------------------

def _burst_crash_arm(arm_site, boundary):
    def arm(m, tmp):
        dc, cc = build(m, sustained_spec(m))
        control = resume_host(dc, cc, 60, 2, [])
        d1, c1 = build(m, sustained_spec(m))
        wal = m.journal.CycleWAL(str(tmp / "wal.jsonl"))
        d1.attach_wal(wal)
        arm_site(m.chaos.install(m.chaos.ChaosInjector(seed=9)))
        out, crashed = run_burst_until_crash(m, d1, c1, 60, 2)
        assert crashed and 0 < len(out) < 60
        if boundary:
            assert wal.tail == []
        m.chaos.clear()
        d2 = recover(m, simple_cluster(m, n_cohorts=1, cqs=2), d1, wal)
        resume_host(d2, c1, 60, 2, out, tick_first=True)
        assert admitted_prefix(out, control)
        assert full_state(d2) == full_state(dc)
        return len(out), full_state(d2)
    return arm


def test_crash_at_burst_window_boundary_recovers(tmp_path):
    """The driver dies between fused windows: nothing uncommitted, and
    the recovered driver decides as the fault-free control."""
    on_both(_burst_crash_arm(
        lambda inj: inj.arm("burst.window_boundary", at=2), True), tmp_path)


def test_crash_mid_burst_window_recovers(tmp_path):
    """The driver dies between applied cycles inside a fused window."""
    on_both(_burst_crash_arm(
        lambda inj: inj.arm("burst.mid_window", at=7), False), tmp_path)


def arm_forced_divergence(m, tmp):
    """Chaos discards speculative windows unconsumed; the serial fallback
    decides as the fault-free per-cycle run."""
    dc, cc = build(m, sustained_spec(m))
    control = resume_host(dc, cc, 60, 2, [])
    d1, c1 = build(m, sustained_spec(m))
    m.chaos.install(m.chaos.ChaosInjector(seed=5)).arm(
        "burst.force_spec_divergence", at=1, times=3, action="cancel")

    def on_cycle_start(_k):
        c1.t += 1.0

    out = d1.schedule_burst(60, runtime=2, on_cycle_start=on_cycle_start,
                            pipeline=True)
    m.chaos.clear()
    assert d1._burst_solver.stats["burst_chaos_divergences"] >= 1
    assert admitted_prefix(out, control)
    assert d1.admitted_keys() == dc.admitted_keys()
    return sorted(d1.admitted_keys()), [sorted(s.admitted) for s in out]


def test_forced_speculation_divergence_keeps_parity(tmp_path):
    on_both(arm_forced_divergence, tmp_path)


# ---------------------------------------------------------------------------
# journal corruption, the MultiKueue transport, the flight recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", PACKAGES)
def test_journal_corruption_sites_force_full_walk(root):
    m = mods(root)
    inj = m.chaos.install(m.chaos.ChaosInjector(seed=2))
    inj.arm("journal.drop_touch", at=1)
    j = m.journal.PackJournal()
    j.drain_into(set(), {})
    j.touch("cq-a")                   # eaten: the lost update
    assert j.tainted and "cq-a" not in j.dirty
    assert j.drain_into(set(), {}) is True
    assert not j.tainted
    inj.arm("journal.spurious_dirty_all", at=2)
    j.touch("cq-b")
    j.touch("cq-c")
    assert j.dirty_all and {"cq-b", "cq-c"} <= j.dirty
    assert j.drain_into(set(), {}) is True


def _chaos_client(m, **kw):
    d = make_driver(m, Clock())
    simple_cluster(m, n_cohorts=1, cqs=1)(d)
    return m.remote.ChaosWorkerClient(m.remote.LocalWorkerClient(d),
                                      injector=m.chaos.ChaosInjector(seed=4),
                                      **kw)


@pytest.mark.parametrize("root", PACKAGES)
def test_chaos_worker_client_partition_heals_by_retry(root):
    m = mods(root)
    client = _chaos_client(m, backoff_base=0.0, backoff_max=0.0)
    client._inj().arm("remote.partition", at=1, times=2, action="partition")
    client.create_workload(mk(m, "a", "lq-0-0", 1000, t=1.0))
    assert client.get_workload("default/a") is not None
    assert client.stats["partitioned"] == 2
    assert client.stats["retries"] == 2


@pytest.mark.parametrize("root", PACKAGES)
def test_chaos_worker_client_duplicate_and_delay_are_absorbed(root):
    m = mods(root)
    client = _chaos_client(m)
    inj = client._inj()
    inj.arm("remote.duplicate", at=1, action="duplicate")
    inj.arm("remote.delay", at=1, action="delay", payload=0.0)
    client.create_workload(mk(m, "a", "lq-0-0", 1000, t=1.0))
    assert client.stats["duplicates"] == 1 and client.stats["delays"] == 1
    assert client.list_workload_keys() == ["default/a"]


def arm_obs_dump(m, tmp):
    """``obs.dump`` fires after the ring snapshot, before serialization:
    a crashed dump leaves the recorder untouched."""
    d, c = build(m, with_workloads(simple_cluster(m), [
        mk(m, f"w{i}", "lq-0-0", 1000, t=float(i + 1)) for i in range(8)]))
    resume_host(d, c, 5, 2, [])
    before = d.obs.flight.dump()
    dumps_before = d.obs.flight.dumps
    m.chaos.install(m.chaos.ChaosInjector(seed=7)).arm("obs.dump", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        d.obs.flight.dump()
    assert d.obs.flight.dumps == dumps_before
    after = d.obs.flight.dump()
    m.chaos.clear()

    def strip(doc):
        return json.dumps({**doc, "cycles": [
            {k: v for k, v in cyc.items() if k != "chaos_hits"}
            for cyc in doc["cycles"]]}, sort_keys=True)

    assert strip(after) == strip(before)
    assert d.obs.flight.recorded_total == before["recorded_total"]
    return [r.digest for r in d.obs.flight.ring]


def test_obs_dump_crashpoint_cannot_corrupt_recorder(tmp_path):
    on_both(arm_obs_dump, tmp_path)


# ---------------------------------------------------------------------------
# WAL segment compaction (wal.shard_merge, wal.compact)
# ---------------------------------------------------------------------------

def _fill(wal, n=12, commit_each=3):
    for i in range(n):
        wal.log({"op": "requeue", "key": f"ns/w{i}", "count": i,
                 "at": float(i)})
        if (i + 1) % commit_each == 0:
            wal.commit()
    wal.log({"op": "deactivate", "key": "ns/open"})   # live tail


@pytest.mark.parametrize("root", PACKAGES)
def test_sharded_crash_between_segment_compactions(tmp_path, root):
    m = mods(root)
    path, ctrl = str(tmp_path / "wal.jsonl"), str(tmp_path / "ctrl.jsonl")
    wal = m.journal.ShardedCycleWAL(path, shards=3)
    ref = m.journal.ShardedCycleWAL(ctrl, shards=3)
    for w in (wal, ref):
        w.register_appender("t0")
        w.register_appender("t1")
    _fill(wal)
    _fill(ref)
    m.chaos.install(m.chaos.ChaosInjector(seed=7)).arm("wal.shard_merge",
                                                       at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        wal.compact()
    m.chaos.clear()
    wal.close()
    ref.close()
    crashed = m.journal.load_cycle_wal(path)
    control = m.journal.load_cycle_wal(ctrl)
    assert crashed._shards[0].folded_ops > 0
    assert all(sh.folded_ops == 0 for sh in crashed._shards[1:])
    assert [op["key"] for op in crashed.tail] \
        == [op["key"] for op in control.tail] == ["ns/open"]

    def committed_ops(w):
        return sum(sh.folded_ops + sum(len(b) for b in sh.batches)
                   for sh in w._shards)
    assert committed_ops(crashed) == committed_ops(control)
    sa = {f"ns/w{i}": mk(m, f"w{i}", "lq", 100) for i in range(12)}
    sb = {k: mk(m, k.split("/")[1], "lq", 100) for k in sa}
    assert crashed.replay_tail(sa) == control.replay_tail(sb)


@pytest.mark.parametrize("root", PACKAGES)
def test_sharded_crash_inside_segment_compaction(tmp_path, root):
    m = mods(root)
    path = str(tmp_path / "wal.jsonl")
    wal = m.journal.ShardedCycleWAL(path, shards=2)
    _fill(wal, n=8, commit_each=2)
    before = [op["key"] for op in wal.tail]
    m.chaos.install(m.chaos.ChaosInjector(seed=4)).arm("wal.compact", at=1)
    with pytest.raises(m.chaos.InjectedCrash):
        wal.compact()
    m.chaos.clear()
    wal.close()
    loaded = m.journal.load_cycle_wal(path)
    assert [op["key"] for op in loaded.tail] == before
    assert all(sh.folded_ops == 0 for sh in loaded._shards)


# ---------------------------------------------------------------------------
# wire faults through the socket proxy (dist.proxy_fault)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", PACKAGES)
def test_armed_proxy_faults_fire_deterministically(root):
    """``dist.proxy_fault`` schedules wire faults by hit count: a reset
    at connection 2, a truncation at 4; the HTTP client retries through
    both, against a worker server over the package's Driver."""
    m = mods(root)
    d = make_driver(m, Clock())
    m.worker.worker_topology(2)(d)
    srv = m.remote.WorkerServer(d, admin=True)
    srv.start()
    try:
        inj = m.chaos.ChaosInjector(seed=3)
        inj.arm("dist.proxy_fault", at=2, action="reset")
        inj.arm("dist.proxy_fault", at=4, action="truncate", payload=16)
        m.chaos.install(inj)
        px = m.proxy.SocketFaultProxy(srv.port, seed=3)
        px.start()
        try:
            cl = m.remote.HttpWorkerClient(
                px.base_url, timeout=2.0, retries=4, backoff_base=0.01,
                backoff_max=0.05, deadline_s=8.0)
            for _ in range(6):
                cl.admin_status()
            assert px.stats["resets"] == 1
            assert px.stats["truncations"] == 1
            assert cl.stats["retries"] >= 2
            assert cl.stats["midbody_retries"] >= 1
            assert cl.stats["deadline_exhausted"] == 0
        finally:
            px.stop()
    finally:
        srv.stop()
