"""Topology-aware scheduling end to end: the port's Driver(device="cpu")
against the JAX package's Driver on the TAS scenarios of
tests/test_tas_device_path.py (seeds 61-63 under every TAS profile, and
its 1,000-head cycle) and on a small tas-4k cluster
(kueue_tpu_torch.scenarios.tas_spec).  Events and every admission's
topology assignment must be identical, with the TASDeviceKernel gate on
(the port's plain TAS programs) and off (the host tree walk).

The two packages keep separate feature gates: each test sets the TAS
gates in both and restores both."""

import random

import pytest

import kueue_tpu.features as jfeatures
import kueue_tpu_torch.features as pfeatures
from kueue_tpu.api import types as jt
from kueue_tpu.cache.tas_cache import NodeInfo as JNodeInfo
from kueue_tpu.controller.driver import Driver as JDriver
from kueue_tpu_torch import scenarios
from kueue_tpu_torch.api import types as pt
from kueue_tpu_torch.cache.tas_cache import NodeInfo as PNodeInfo
from kueue_tpu_torch.controller.driver import Driver as PDriver
from tests.conftest import FakeClock

PROFILE_GATES = ("TASProfileMostFreeCapacity", "TASProfileLeastFreeCapacity",
                 "TASProfileMixed")
PROFILES = [{}, {"TASProfileMostFreeCapacity": True},
            {"TASProfileLeastFreeCapacity": True}, {"TASProfileMixed": True}]


@pytest.fixture
def gates():
    """Sets TAS gates in both packages; restores both afterwards."""
    saved = [(f, dict(f._overrides)) for f in (jfeatures, pfeatures)]

    def set_both(device_kernel, **profiles):
        g = {"TopologyAwareScheduling": True,
             "TASDeviceKernel": device_kernel,
             **{p: False for p in PROFILE_GATES}, **profiles}
        for f, _ in saved:
            f.set_feature_gates(g)
    yield set_both
    for f, overrides in saved:
        f._overrides.clear()
        f._overrides.update(overrides)


def _driver(pkg, clock, **kw):
    if pkg == "jax":
        return jt, JNodeInfo, JDriver(clock=clock, **kw)
    return pt, PNodeInfo, PDriver(clock=clock, device="cpu", **kw)


def build_tas_driver(pkg, seed, n_blocks=2, racks=2, hosts=3):
    """tests/test_tas_device_path.py build_tas_driver, for either
    package."""
    rng = random.Random(seed)
    clock = FakeClock()
    t, NodeInfo, d = _driver(pkg, clock)
    d.apply_topology(t.Topology(name="dc", levels=["block", "rack", "host"]))
    d.apply_resource_flavor(t.ResourceFlavor(name="tas-flavor",
                                             topology_name="dc"))
    for b in range(n_blocks):
        for r in range(racks):
            for h in range(hosts):
                d.cache.tas.add_or_update_node(NodeInfo(
                    name=f"n-{b}-{r}-{h}",
                    labels={"block": f"b{b}", "rack": f"r{b}-{r}",
                            "host": f"h{b}-{r}-{h}"},
                    capacity={"cpu": rng.choice([4000, 8000]),
                              "pods": 16}))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="tas-flavor", resources={
                "cpu": t.ResourceQuota(nominal=200_000)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    workloads = []
    for i in range(14):
        req = rng.choice([
            t.PodSetTopologyRequest(required="rack"),
            t.PodSetTopologyRequest(required="block"),
            t.PodSetTopologyRequest(preferred="rack"),
            t.PodSetTopologyRequest(unconstrained=True),
        ])
        workloads.append(t.Workload(
            name=f"wl-{i}", queue_name="lq",
            priority=rng.choice([10, 50]), creation_time=float(i + 1),
            pod_sets=[t.PodSet(name="main", count=rng.choice([1, 2, 4, 6]),
                               requests={"cpu": 2000},
                               topology_request=req)]))
    return d, clock, workloads


def drive(d, clock, workloads, n_cycles=30, runtime=3):
    """tests/test_tas_device_path.py drive: per-cycle admissions with
    their topology assignments, skipped and inadmissible keys."""
    for wl in workloads:
        d.create_workload(wl)
    log = []
    running = []
    for cycle in range(n_cycles):
        clock.t += 1.0
        stats = d.schedule_once()
        admissions = []
        for key in stats.admitted:
            wl = d.workload(key)
            tas = tuple(
                (a.name, a.count,
                 tuple((tuple(dom.values), dom.count)
                       for dom in a.topology_assignment.domains)
                 if a.topology_assignment else None)
                for a in wl.admission.pod_set_assignments)
            admissions.append((key, tas))
            running.append((cycle + runtime, key))
        log.append({"admitted": admissions,
                    "skipped": sorted(stats.skipped),
                    "inadmissible": sorted(stats.inadmissible)})
        still = []
        for fin, key in running:
            wl = d.workload(key)
            if wl is None or not wl.has_quota_reservation:
                continue
            if fin <= cycle:
                d.finish_workload(key)
            else:
                still.append((fin, key))
        running = still
    return log


@pytest.mark.parametrize("device_kernel", [True, False])
@pytest.mark.parametrize("profile", range(len(PROFILES)))
@pytest.mark.parametrize("seed", [61, 62, 63])
def test_port_driver_matches_jax(seed, profile, device_kernel, gates):
    gates(device_kernel, **PROFILES[profile])
    runs = {}
    for pkg in ("jax", "torch"):
        d, clock, wls = build_tas_driver(pkg, seed)
        runs[pkg] = (drive(d, clock, wls), d.events)
    (jlog, jev), (plog, pev) = runs["jax"], runs["torch"]
    for cyc, (a, b) in enumerate(zip(jlog, plog)):
        assert a == b, f"seed {seed} cycle {cyc}:\njax={a}\nport={b}"
    assert jev == pev
    admitted = [a for c in plog for a in c["admitted"]]
    assert any(tas for _, pa in admitted for _, _, tas in pa), admitted


def _thousand_heads(pkg, use_device):
    """tests/test_tas_device_path.py test_tas_thousand_heads_full_cycle's
    cluster: 1,000 CQs with one TAS head each, one cycle."""
    clock = FakeClock()
    t, NodeInfo, d = _driver(pkg, clock, use_device_solver=use_device)
    d.apply_topology(t.Topology(name="dc", levels=["rack", "host"]))
    d.apply_resource_flavor(t.ResourceFlavor(name="tas-flavor",
                                             topology_name="dc"))
    for r in range(4):
        for h in range(4):
            d.cache.tas.add_or_update_node(NodeInfo(
                name=f"n-{r}-{h}", labels={"rack": f"r{r}",
                                           "host": f"h{r}-{h}"},
                capacity={"cpu": 4_000_000, "pods": 100_000}))
    rng = random.Random(7)
    for i in range(1000):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="tas-flavor", resources={
                    "cpu": t.ResourceQuota(nominal=100_000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{i}",
                                         cluster_queue=f"cq-{i}"))
        req = rng.choice([t.PodSetTopologyRequest(required="rack"),
                          t.PodSetTopologyRequest(preferred="host"),
                          t.PodSetTopologyRequest(unconstrained=True)])
        d.create_workload(t.Workload(
            name=f"wl-{i}", queue_name=f"lq-{i}",
            priority=rng.choice([10, 50]), creation_time=float(i + 1),
            pod_sets=[t.PodSet(name="main", count=rng.choice([1, 2, 3]),
                               requests={"cpu": 1000},
                               topology_request=req)]))
    clock.t += 1.0
    stats = d.schedule_once()
    assignments = {
        key: tuple((a.name, a.count,
                    tuple((tuple(dom.values), dom.count)
                          for dom in a.topology_assignment.domains)
                    if a.topology_assignment else None)
                   for a in wl.admission.pod_set_assignments)
        for key, wl in d.workloads.items() if wl.admission is not None}
    return d, stats, assignments


@pytest.mark.parametrize("device_kernel", [True, False])
def test_thousand_heads_cycle_matches_jax(device_kernel, gates):
    """One cycle of 1,000 TAS heads: the port's device solver (a FULL
    cycle, every head through the scalar walk's TAS hook) gives the JAX
    package's admissions, assignments and events."""
    gates(device_kernel)
    jd, js, ja = _thousand_heads("jax", use_device=True)
    pd, ps, pa = _thousand_heads("torch", use_device=True)
    assert len(ps.admitted) >= 1000
    assert ps.admitted == js.admitted
    assert pa == ja
    assert pd.events == jd.events
    stats = pd.scheduler.solver.stats
    assert stats["full_cycles"] == 1, stats
    assert stats["scalar_heads"] >= 1000, stats


@pytest.mark.parametrize("device_kernel", [True, False])
def test_tas4k_scenario_matches_jax(device_kernel, gates):
    """The tas-4k scenario at a small size (2 blocks x 4 subblocks x 8
    hosts, 8 CQs in 2 cohorts, 160 workloads, 20 cycles): equal digests
    over events and topology assignments; on the port the device path
    takes the branches of _find_device and no scalar walk, or only the
    scalar walk with the gate off."""
    gates(device_kernel)
    kw = dict(blocks=2, subblocks=4, hosts=8, n_cqs=8, n_cohorts=2,
              per_cq=20)
    digests = {}
    for pkg in ("jax", "torch"):
        t, NodeInfo, d = _driver(pkg, scenarios.VirtualClock())
        runtimes = scenarios.tas_spec(t, d, NodeInfo, **kw)
        with scenarios.TASBranches() as br:
            r = scenarios.run_tas(d, d.clock, runtimes, cycles=20)
        digests[pkg] = scenarios.tas_digest(d, r)
        assert r["admitted"] > 0
    assert digests["jax"] == digests["torch"]
    c = br.counts
    if device_kernel:
        assert c["scalar_walk"] == 0
        for k in ("required_fit", "preferred_fit", "unconstrained"):
            assert c[k] > 0, c
    else:
        assert c["scalar_walk"] > 0
        assert c["best_fit_descend"] == c["split_across_roots"] == 0, c


def test_tas_head_no_longer_raises_import_error(gates):
    """A port Driver with TopologyAwareScheduling on and a head with a
    topology request reaches ops.tas_kernel (once a missing module) and
    admits with a topology assignment."""
    gates(True)
    d, clock, _ = build_tas_driver("torch", 61)
    d.create_workload(pt.Workload(
        name="w", queue_name="lq", creation_time=1.0,
        pod_sets=[pt.PodSet(name="main", count=2, requests={"cpu": 2000},
                            topology_request=pt.PodSetTopologyRequest(
                                required="rack"))]))
    clock.t += 1.0
    stats = d.schedule_once()
    assert stats.admitted
    (a,) = d.workload(stats.admitted[0]).admission.pod_set_assignments
    assert sum(dom.count for dom in a.topology_assignment.domains) == 2
    assert d.cache.tas.device == "cpu"
    assert all(s.device == "cpu" for s in d.cache.tas.snapshot().values())
