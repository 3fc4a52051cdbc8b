"""Decision parity of the fused burst path: the same seeded scenarios
through the JAX package's ``Driver(use_device_solver=True).schedule_burst``
and the port's ``Driver(device="cpu").schedule_burst`` must give the same
``Driver.events`` in the same order and the same per-cycle admitted /
skipped / inadmissible / preempted sets; and the port's burst must decide
like the port's own per-cycle path (tests/test_burst.py ``assert_parity``).

The scenarios are those of tests/test_burst.py, test_burst_preempt.py and
test_burst_pipeline.py, rebuilt here for either package."""

from __future__ import annotations

import importlib

import pytest
import torch

torch.set_num_threads(1)

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def types_of(pkg):
    return importlib.import_module(f"{pkg}.api.types")


def make_driver(pkg, clock):
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    if pkg == "kueue_tpu":
        return Driver(clock=clock, use_device_solver=True)
    return Driver(clock=clock, device="cpu")


# -- scenario pieces (any package's api.types as ``t``) -----------------

def pre_any(t):
    return t.PreemptionPolicy(
        reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
        within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY)


def mk(t, name, lq, cpu, prio=0, ts=0.0, count=1, mem=None):
    req = {"cpu": cpu}
    if mem is not None:
        req["mem"] = mem
    return t.Workload(name=name, queue_name=lq, priority=prio,
                      creation_time=ts,
                      pod_sets=[t.PodSet(name="main", count=count,
                                         requests=req)])


def cluster(t, d, n_cohorts=1, cqs=2, nominal=4000, borrowing=None,
            strict=False, preemption=None, resources=("cpu",)):
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for c in range(n_cohorts):
        for q in range(cqs):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(t.ClusterQueue(
                name=name, cohort=f"co-{c}",
                queueing_strategy=(t.QueueingStrategy.STRICT_FIFO if strict
                                   else t.QueueingStrategy.BEST_EFFORT_FIFO),
                preemption=preemption or t.PreemptionPolicy(),
                resource_groups=[t.ResourceGroup(
                    covered_resources=list(resources),
                    flavors=[t.FlavorQuotas(name="default", resources={
                        r: t.ResourceQuota(nominal=nominal * (i + 1),
                                           borrowing_limit=borrowing)
                        for i, r in enumerate(resources)})])]))
            d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                             cluster_queue=name))


def admit_cycles(d, clock, n):
    for _ in range(n):
        clock.t += 1.0
        d.schedule_once()


def sc_drain(t, d, clock):
    """Parking, in-cycle skips, finish-driven unparking."""
    cluster(t, d, n_cohorts=2, cqs=2)
    n = 0
    for c in range(2):
        for q in range(2):
            for i in range(6):
                n += 1
                d.create_workload(mk(t, f"w-{c}-{q}-{i}", f"lq-{c}-{q}",
                                     1500, prio=(i % 3) * 10, ts=float(n)))


def sc_strict(t, d, clock):
    """StrictFIFO: a NoFit head blocks its CQ instead of parking, and a
    strict preemptor stays head while its targets go."""
    cluster(t, d, cqs=2, strict=True, preemption=pre_any(t))
    d.create_workload(mk(t, "victim", "lq-0-1", 8000, ts=1.0))
    admit_cycles(d, clock, 1)
    d.create_workload(mk(t, "huge", "lq-0-0", 50_000, prio=10, ts=2.0))
    d.create_workload(mk(t, "tiny", "lq-0-0", 100, ts=3.0))
    d.create_workload(mk(t, "boss", "lq-0-1", 4000, prio=100, ts=50.0))
    d.create_workload(mk(t, "behind", "lq-0-1", 100, ts=51.0))


def sc_multiflavor(t, d, clock):
    """Two flavors: fit-slot selection and the fungibility resume."""
    for f in ("f0", "f1"):
        d.apply_resource_flavor(t.ResourceFlavor(name=f))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="f0", resources={
                "cpu": t.ResourceQuota(nominal=2000)}),
                t.FlavorQuotas(name="f1", resources={
                    "cpu": t.ResourceQuota(nominal=8000)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    for i in range(5):
        d.create_workload(mk(t, f"w{i}", "lq", 1900, ts=float(i)))


def sc_fillback(t, d, clock):
    """Within-CQ search: two of three victims, fill-back keeps the
    minimal set; the victims requeue and re-admit (runtime > 0)."""
    cluster(t, d, cqs=1, nominal=6000, preemption=pre_any(t))
    for i in range(3):
        d.create_workload(mk(t, f"low-{i}", "lq-0-0", 2000, ts=float(i)))
    admit_cycles(d, clock, 3)
    d.create_workload(mk(t, "boss", "lq-0-0", 4000, prio=100, ts=50.0))


def sc_reclaim_overlap(t, d, clock):
    """Cross-CQ reclaim; two reclaimers whose searches pick the same
    victim — the second skips on the overlap."""
    cluster(t, d, cqs=2, nominal=2000, borrowing=4000,
            preemption=pre_any(t))
    d.create_workload(mk(t, "victim", "lq-0-0", 4000, ts=1.0))
    admit_cycles(d, clock, 1)
    d.create_workload(mk(t, "r0", "lq-0-0", 2000, prio=100, ts=50.0))
    d.create_workload(mk(t, "r1", "lq-0-1", 2000, prio=100, ts=51.0))


def sc_reserve(t, d, clock):
    """A preempt head with no candidates reserves capacity in-scan."""
    cluster(t, d, cqs=2, nominal=4000, borrowing=4000,
            preemption=pre_any(t))
    d.create_workload(mk(t, "high-a", "lq-0-0", 2000, prio=200, ts=1.0))
    d.create_workload(mk(t, "high-b", "lq-0-1", 4000, prio=200, ts=2.0))
    admit_cycles(d, clock, 1)
    d.create_workload(mk(t, "boss", "lq-0-0", 4000, prio=100, ts=50.0))
    d.create_workload(mk(t, "tiny", "lq-0-1", 2000, ts=51.0))


def sc_staged(t, d, clock):
    """Cross-CQ candidates with the queue under nominal: the staged
    search (all candidates without borrowing, then same-CQ)."""
    cluster(t, d, cqs=2, nominal=4000, borrowing=4000,
            preemption=pre_any(t))
    for i, (name, lq, cpu) in enumerate((("own", "lq-0-0", 2000),
                                         ("b1", "lq-0-1", 4000),
                                         ("b2", "lq-0-1", 2000))):
        d.create_workload(mk(t, name, lq, cpu, ts=float(i + 1)))
        admit_cycles(d, clock, 1)
    d.create_workload(mk(t, "boss", "lq-0-0", 4000, prio=100, ts=50.0))


def sc_wave(t, d, clock):
    """A preemptor wave over two cohorts whose lanes walk different
    numbers of candidates in one window: cq-i holds i+1 workloads of
    1000 each and its preemptor needs (i + 1) * 1000; in cq-5 two of
    them outrank the preemptor, so its walk exhausts the candidates
    without fitting (it reserves instead)."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for i in range(6):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort=f"co-{i // 3}", preemption=pre_any(t),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=(i + 1) * 1000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{i}",
                                         cluster_queue=f"cq-{i}"))
    n = 0
    for i in range(6):
        for j in range(i + 1):
            n += 1
            d.create_workload(mk(t, f"low-{i}-{j}", f"lq-{i}", 1000,
                                 prio=200 if (i == 5 and j < 2) else 0,
                                 ts=float(n)))
    admit_cycles(d, clock, 6)
    for i in range(6):
        d.create_workload(mk(t, f"pre-{i}", f"lq-{i}", (i + 1) * 1000,
                             prio=100, ts=100.0 + i))


def sc_two_res(t, d, clock):
    """Two resources, only one short: candidates filter on the shortfall
    column (frsNeedingPreemption)."""
    cluster(t, d, cqs=1, nominal=4000, preemption=pre_any(t),
            resources=("cpu", "mem"))
    d.create_workload(mk(t, "low", "lq-0-0", 4000, mem=1000, ts=1.0))
    admit_cycles(d, clock, 1)
    d.create_workload(mk(t, "boss", "lq-0-0", 2000, prio=100, ts=50.0,
                         mem=2000))


def sc_sustained(t, d, clock):
    """More than one K=32 window of work: the pipelined boundary."""
    cluster(t, d, cqs=2, nominal=4000)
    n = 0
    for q in range(2):
        for i in range(36):
            n += 1
            d.create_workload(mk(t, f"w-{q}-{i}", f"lq-0-{q}", 2000,
                                 prio=(i % 3) * 10, ts=float(n)))


# name -> (scenario function, cycles, runtime)
SCENARIOS = {
    "drain": (sc_drain, 12, 2),
    "strict": (sc_strict, 5, 0),
    "multiflavor": (sc_multiflavor, 6, 1),
    "fillback": (sc_fillback, 6, 2),
    "reclaim_overlap": (sc_reclaim_overlap, 4, 0),
    "reserve": (sc_reserve, 3, 0),
    "staged": (sc_staged, 5, 0),
    "wave": (sc_wave, 6, 3),
    "two_res": (sc_two_res, 4, 0),
    "sustained": (sc_sustained, 80, 2),
}


def build(pkg, name):
    fn, cycles, runtime = SCENARIOS[name]
    clock = Clock()
    d = make_driver(pkg, clock)
    fn(types_of(pkg), d, clock)
    return d, clock, cycles, runtime


def run_burst(d, clock, cycles, runtime, pipeline=None, ext=None):
    def on_cycle_start(_k):
        clock.t += 1.0
    return d.schedule_burst(cycles, runtime=runtime,
                            external_finishes=ext,
                            on_cycle_start=on_cycle_start,
                            pipeline=pipeline)


def run_host(d, clock, cycles, runtime):
    out = []
    for c in range(cycles):
        clock.t += 1.0
        out.append(d.schedule_once())
        if runtime > 0 and c - runtime >= 0:
            for key in out[c - runtime].admitted:
                wl = d.workloads.get(key)
                if wl is not None and wl.has_quota_reservation:
                    d.finish_workload(key)
    return out


def records(stats):
    return [(sorted(s.admitted), sorted(s.skipped), sorted(s.inadmissible),
             sorted(s.preempted_targets), sorted(s.preempting))
            for s in stats]


# the pipeline off and on; the sustained drain (80 cycles) only on, as
# test_port_burst_pipeline_off_matches_on holds the two against each other
JAX_CASES = [(n, p) for n in sorted(SCENARIOS) for p in (True, False)
             if n != "sustained" or p]


@pytest.mark.parametrize("name,pipeline", JAX_CASES)
def test_burst_matches_the_jax_package(name, pipeline):
    results = []
    for pkg in PACKAGES:
        d, clock, cycles, runtime = build(pkg, name)
        stats = run_burst(d, clock, cycles, runtime, pipeline=pipeline)
        results.append((d.events, records(stats), sorted(d.admitted_keys()),
                        d))
    (ej, rj, aj, dj), (et, rt, at, dt) = results
    assert et == ej
    assert rt == rj
    assert at == aj
    bj, bt = dj._burst_solver.stats, dt._burst_solver.stats
    for k in ("burst_dispatches", "burst_preempt_cycles",
              "burst_dirty_cycles", "burst_spec_dispatches",
              "burst_overlapped_packs", "burst_spec_cancelled"):
        assert bt[k] == bj[k], k
    assert bt["burst_dispatches"] >= 1


PREEMPTING = ("fillback", "reclaim_overlap", "staged", "wave", "two_res",
              "strict")


@pytest.mark.parametrize("name", PREEMPTING)
def test_preempt_cycles_decided_in_the_kernel(name):
    """The port decides these preemption cycles inside the burst, not on
    the per-cycle fallback."""
    d, clock, cycles, runtime = build("kueue_tpu_torch", name)
    stats = run_burst(d, clock, cycles, runtime)
    bs = d._burst_solver.stats
    assert bs["burst_preempt_cycles"] >= 1, bs
    assert bs["burst_dirty_preempt"] == 0, bs
    assert any(s.preempted_targets or s.preempting for s in stats)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_burst_matches_port_per_cycle(name):
    """tests/test_burst.py assert_parity, on the port alone."""
    dh, ch, cycles, runtime = build("kueue_tpu_torch", name)
    db, cb, _, _ = build("kueue_tpu_torch", name)
    host = run_host(dh, ch, cycles, runtime)
    burst = run_burst(db, cb, cycles, runtime)
    for s in host[len(burst):]:
        assert not (s.admitted or s.skipped or s.inadmissible
                    or s.preempting), "burst ended while host still active"
    assert records(host[:len(burst)]) == records(burst)
    assert dh.admitted_keys() == db.admitted_keys()


def test_port_burst_pipeline_off_matches_on():
    ds, cs, cycles, runtime = build("kueue_tpu_torch", "sustained")
    dp, cp, _, _ = build("kueue_tpu_torch", "sustained")
    serial = run_burst(ds, cs, cycles, runtime, pipeline=False)
    piped = run_burst(dp, cp, cycles, runtime, pipeline=True)
    assert records(serial) == records(piped)
    assert ds.events == dp.events
    bs = dp._burst_solver.stats
    assert bs["burst_overlapped_packs"] >= 1, bs
    assert bs["burst_spec_dispatches"] == (
        bs["burst_overlapped_packs"] + bs["burst_spec_cancelled"])
    assert ds._burst_solver.stats["burst_spec_dispatches"] == 0


def test_external_finishes_match_the_jax_package():
    """Admissions from before the call finish through the external
    schedule: row-backed rows through ``death0``, aggregate-compressed
    rows of non-preempting forests through ext_release / ext_unpark; and
    a stale finish of a workload preempted meanwhile is skipped."""
    results = []
    for pkg in PACKAGES:
        t = types_of(pkg)
        clock = Clock()
        d = make_driver(pkg, clock)
        cluster(t, d, n_cohorts=1, cqs=1, nominal=4000,
                preemption=pre_any(t))
        d.apply_cluster_queue(t.ClusterQueue(
            name="plain", cohort="co-plain",
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=2000)})])]))
        d.apply_local_queue(t.LocalQueue(name="lq-plain",
                                         cluster_queue="plain"))
        d.create_workload(mk(t, "victim", "lq-0-0", 4000, ts=1.0))
        d.create_workload(mk(t, "p0", "lq-plain", 2000, ts=2.0))
        admit_cycles(d, clock, 1)
        d.create_workload(mk(t, "boss", "lq-0-0", 4000, prio=100, ts=50.0))
        d.create_workload(mk(t, "p1", "lq-plain", 2000, ts=51.0))
        ext = {2: ["default/victim", "default/p0"]}
        stats = run_burst(d, clock, 8, 3, ext=ext)
        results.append((d.events, records(stats)))
        assert not d.workloads["default/victim"].is_finished
    assert results[0] == results[1]
