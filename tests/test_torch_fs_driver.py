"""Decision parity of fair-sharing admission: the same scenarios through
the JAX package's ``Driver(fair_sharing=True, use_device_solver=True)``
and the port's ``Driver(device="cpu", fair_sharing=True)`` must give the
same ``Driver.events`` in the same order and the same per-cycle
admitted / skipped / inadmissible / preempted sets, with the device scan
(``fs_admit_scan``) deciding cycles in both; and the port's host
tournament (``use_device_solver=False``) must decide like the JAX
package's.

The scenarios are those of tests/test_fs_device.py and the seeded
clusters of tests/test_fairsharing_batched.py, rebuilt here for either
package, and ``scenarios.run_northstar_fs`` at a small size."""

from __future__ import annotations

import importlib
import random

import pytest
import torch

from kueue_tpu_torch import scenarios

torch.set_num_threads(1)

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def types_of(pkg):
    return importlib.import_module(f"{pkg}.api.types")


def make_driver(pkg, clock, device_solver=True):
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    if pkg == "kueue_tpu":
        return Driver(clock=clock, fair_sharing=True,
                      use_device_solver=device_solver)
    return Driver(clock=clock, fair_sharing=True, device="cpu",
                  use_device_solver=device_solver)


def mk(t, name, lq, cpu, prio=0, ts=0.0, mem=None):
    req = {"cpu": cpu}
    if mem is not None:
        req["memory"] = mem
    return t.Workload(name=name, queue_name=lq, priority=prio,
                      creation_time=ts,
                      pod_sets=[t.PodSet(name="main", count=1,
                                         requests=req)])


def fs_cluster(weights=(1.0, 1.0, 1.0), nominal=2000, borrowing=8000,
               cohorts=1, preemption=False):
    """tests/test_fs_device.py ``fs_cluster`` for any package."""
    def spec(t, d):
        d.apply_resource_flavor(t.ResourceFlavor(name="default"))
        pre = (t.PreemptionPolicy(
            reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
            within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY)
            if preemption else t.PreemptionPolicy())
        for c in range(cohorts):
            for q, w in enumerate(weights):
                name = f"cq-{c}-{q}"
                d.apply_cluster_queue(t.ClusterQueue(
                    name=name, cohort=f"co-{c}", preemption=pre,
                    fair_sharing=t.FairSharing(weight=w),
                    resource_groups=[t.ResourceGroup(
                        covered_resources=["cpu"],
                        flavors=[t.FlavorQuotas(name="default", resources={
                            "cpu": t.ResourceQuota(
                                nominal=nominal,
                                borrowing_limit=borrowing)})])]))
                d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                                 cluster_queue=name))
    return spec


def run_cycles(d, clock, cycles, runtime=0):
    log = []
    admitted = []
    for c in range(cycles):
        clock.t += 1.0
        s = d.schedule_once()
        admitted.append(s.admitted)
        log.append((list(s.admitted), sorted(s.skipped),
                    sorted(s.inadmissible), sorted(s.preempting),
                    sorted(s.preempted_targets)))
        if runtime > 0 and c - runtime >= 0:
            for key in admitted[c - runtime]:
                wl = d.workloads.get(key)
                if wl is not None and wl.has_quota_reservation:
                    d.finish_workload(key)
    return log


def run_both(spec, workloads, cycles, runtime=0, pre=None,
             device_solver=True):
    """Build, fill and run the scenario in both packages → {pkg: (driver,
    per-cycle log)}.  ``pre(t, d, clock)`` runs before ``workloads``."""
    out = {}
    for pkg in PACKAGES:
        t = types_of(pkg)
        clock = Clock()
        d = make_driver(pkg, clock, device_solver)
        spec(t, d)
        if pre is not None:
            pre(t, d, clock)
        for wl in workloads(t):
            d.create_workload(wl)
        out[pkg] = (d, run_cycles(d, clock, cycles, runtime))
    (jd, jlog), (td, tlog) = out["kueue_tpu"], out["kueue_tpu_torch"]
    for k, (a, b) in enumerate(zip(jlog, tlog)):
        assert a == b, f"cycle {k}:\njax={a}\nport={b}"
    assert jd.events == td.events
    assert jd.admitted_keys() == td.admitted_keys()
    return out


def fs_stat(out, key):
    return {pkg: d.scheduler.solver.stats[key]
            for pkg, (d, _) in out.items()}


def assert_device_decided(out):
    full = fs_stat(out, "fs_full_cycles")
    assert full["kueue_tpu"] == full["kueue_tpu_torch"] > 0, full


# -- tests/test_fs_device.py scenarios ------------------------------------

def _order_wls(t):
    return [mk(t, f"w-{q}-{i}", f"lq-0-{q}", 1500, ts=float(q * 10 + i))
            for q in range(3) for i in range(4)]


def _weight_wls(t):
    return [mk(t, f"w-{q}-{i}", f"lq-0-{q}", 2500, ts=float(q * 10 + i))
            for q in range(3) for i in range(3)]


def _tie_wls(t):
    return [mk(t, "a", "lq-0-0", 3000, prio=5, ts=7.0),
            mk(t, "b", "lq-0-1", 3000, prio=5, ts=7.0),
            mk(t, "c", "lq-0-2", 3000, prio=9, ts=9.0)]


def _nofit_wls(t):
    return [mk(t, "big", "lq-0-0", 50_000, ts=1.0),
            mk(t, "ok-1", "lq-0-1", 2000, ts=2.0),
            mk(t, "ok-2", "lq-0-2", 2000, ts=3.0)]


def _forest_wls(t):
    return [mk(t, f"w-{c}-{q}", f"lq-{c}-{q}", 2500, ts=float(c * 100 + q))
            for c in range(3) for q in range(3)]


def _drain_wls(t):
    return [mk(t, f"w-{q}-{i}", f"lq-0-{q}", 1800, ts=float(q * 100 + i))
            for q in range(3) for i in range(5)]


FS_DEVICE = {
    "tournament_order": (fs_cluster(), _order_wls, 6, 0),
    "weights": (fs_cluster(weights=(2.0, 1.0, 0.0)), _weight_wls, 6, 0),
    "priority_and_ts_ties": (fs_cluster(), _tie_wls, 3, 0),
    "nofit_entries_compete": (fs_cluster(), _nofit_wls, 3, 0),
    "multi_cohort_forest": (fs_cluster(cohorts=3), _forest_wls, 5, 0),
    "drain_with_finishes": (fs_cluster(nominal=2000, borrowing=4000),
                            _drain_wls, 12, 2),
}


@pytest.mark.parametrize("name", sorted(FS_DEVICE))
def test_fs_device_scenarios(name):
    spec, wls, cycles, runtime = FS_DEVICE[name]
    out = run_both(spec, wls, cycles, runtime)
    assert_device_decided(out)
    td = out["kueue_tpu_torch"][0]
    assert td.scheduler.fs_stats["scalar_drs_rounds"] == 0


def test_fs_preemption_cycles_stay_host():
    """Cycles with a preempt-capable head run the host tournament and
    the host FS preemption in both packages — same targets."""
    def pre(t, d, clock):
        d.create_workload(mk(t, "low", "lq-0-0", 2000, prio=0, ts=1.0))
        clock.t += 1.0
        d.schedule_once()
        d.create_workload(mk(t, "high", "lq-0-0", 2000, prio=50, ts=9.0))

    out = run_both(fs_cluster(weights=(1.0, 1.0), nominal=2000,
                              borrowing=0, preemption=True),
                   lambda t: [], 3, pre=pre)
    tlog = out["kueue_tpu_torch"][1]
    assert any(c[4] for c in tlog), tlog          # a preemption happened
    classify = fs_stat(out, "classify_cycles")
    assert classify["kueue_tpu"] == classify["kueue_tpu_torch"] > 0


def test_fs_noop_cycle_skips_tournament_dispatch():
    """No head has a fit slot: both skip the scan and requeue the heads
    as inadmissible."""
    out = run_both(fs_cluster(nominal=2000, borrowing=0),
                   lambda t: [mk(t, f"w-{q}", f"lq-0-{q}", 3000,
                                 ts=float(q)) for q in range(3)], 2)
    skips = fs_stat(out, "fs_noop_skips")
    assert skips["kueue_tpu"] == skips["kueue_tpu_torch"] >= 1
    assert fs_stat(out, "fs_full_cycles") == {p: 0 for p in PACKAGES}
    assert all(not c[0] for c in out["kueue_tpu_torch"][1])


# -- tests/test_fairsharing_batched.py seeded clusters --------------------

def seeded_cluster(seed, nested, lending_and_memory, n_cohorts=2,
                   cqs_per_cohort=3, n_wl=60):
    """tests/test_fairsharing_batched.py ``build_fs_driver`` for any
    package → (spec, workloads)."""
    def spec(t, d):
        d.apply_resource_flavor(t.ResourceFlavor(name="default"))
        pre = t.PreemptionPolicy(
            reclaim_within_cohort=t.ReclaimWithinCohort.ANY)
        if nested:
            for c in range(n_cohorts):
                d.apply_cohort(t.Cohort(name=f"cohort-{c}",
                                        parent_name="org"))
        weights = [500, 1000, 2000, 1000]
        for c in range(n_cohorts):
            for q in range(cqs_per_cohort):
                resources = {"cpu": t.ResourceQuota(
                    nominal=4000, borrowing_limit=8000,
                    lending_limit=(2000 if lending_and_memory and q % 2
                                   else None))}
                covered = ["cpu"]
                if lending_and_memory:
                    covered.append("memory")
                    resources["memory"] = t.ResourceQuota(
                        nominal=8000, borrowing_limit=8000)
                d.apply_cluster_queue(t.ClusterQueue(
                    name=f"cq-{c}-{q}", cohort=f"cohort-{c}",
                    preemption=pre,
                    fair_sharing=t.FairSharing(weight=weights[
                        (c * cqs_per_cohort + q) % len(weights)]),
                    resource_groups=[t.ResourceGroup(
                        covered_resources=covered,
                        flavors=[t.FlavorQuotas(name="default",
                                                resources=resources)])]))
                d.apply_local_queue(t.LocalQueue(
                    name=f"lq-{c}-{q}", cluster_queue=f"cq-{c}-{q}"))

    def workloads(t):
        rng = random.Random(seed)
        out = []
        for i in range(n_wl):
            c = rng.randrange(n_cohorts)
            q = rng.randrange(cqs_per_cohort)
            reqs = {"cpu": rng.choice([1000, 2000, 4000])}
            if lending_and_memory:
                reqs["memory"] = rng.choice([1000, 4000, 8000])
            out.append(t.Workload(
                name=f"wl-{i}", queue_name=f"lq-{c}-{q}",
                priority=rng.choice([10, 10, 50, 100]),
                creation_time=float(i + 1),
                pod_sets=[t.PodSet(name="main", count=1, requests=reqs)]))
        return out

    return spec, workloads


@pytest.mark.parametrize("seed,nested,lending", [
    (31, False, False), (32, True, False), (51, False, True),
    (52, True, True)])
def test_seeded_clusters(seed, nested, lending):
    """Device-decided cycles, host-tournament cycles (preempt-capable
    heads) and preemptions, over a 40-cycle drain with finishes."""
    spec, wls = seeded_cluster(seed, nested, lending)
    out = run_both(spec, wls, 40, runtime=2)
    tlog = out["kueue_tpu_torch"][1]
    assert any(c[0] for c in tlog)
    assert_device_decided(out)
    classify = fs_stat(out, "classify_cycles")
    assert classify["kueue_tpu"] == classify["kueue_tpu_torch"]


@pytest.mark.parametrize("seed,nested", [(33, True), (53, False)])
def test_host_tournament_matches_jax(seed, nested):
    """Without the device solver both packages run the host tournament
    (TournamentDRS) for every cycle: same decisions."""
    spec, wls = seeded_cluster(seed, nested, lending_and_memory=not nested)
    out = run_both(spec, wls, 30, runtime=2, device_solver=False)
    for pkg, (d, _) in out.items():
        assert d.scheduler.solver is None
        assert d.scheduler.fs_stats["tracker_unavailable_cycles"] == 0


def test_northstar_fs_small():
    """scenarios.run_northstar_fs at 50 CQs and 2,000 workloads: equal
    events and admission records, cycles decided by the scan and no-op
    skips in both packages."""
    runs = {}
    for pkg in PACKAGES:
        clock = scenarios.VirtualClock()
        d = make_driver(pkg, clock)
        total = scenarios.northstar_fs_spec(types_of(pkg), d, 50, 2000)
        r = scenarios.run_northstar_fs(d, clock, cycles=30)
        runs[pkg] = (d, r, total)
    (jd, jr, jt), (td, tr, tt) = runs["kueue_tpu"], runs["kueue_tpu_torch"]
    assert jt == tt == 2000
    assert jd.events == td.events
    assert jr["decisions"] == tr["decisions"]
    assert (jr["admitted"], jr["skipped"]) == (tr["admitted"], tr["skipped"])
    assert tr["admitted"] > 0
    js, ts = jd.scheduler.solver.stats, td.scheduler.solver.stats
    for key in ("fs_full_cycles", "fs_noop_skips", "classify_cycles",
                "host_cycles"):
        assert js[key] == ts[key], key
    assert ts["fs_full_cycles"] > 0
    assert (scenarios.decision_digest(jd, jr["decisions"])
            == scenarios.decision_digest(td, tr["decisions"]))
