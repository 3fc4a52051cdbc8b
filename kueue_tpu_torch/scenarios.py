"""Seeded driver scenarios for the port: the reference perf scenario and
the north-star shape, driven per cycle through ``Driver.schedule_once``.

- ``build_bench``/``run_bench``: the scheduler perf scenario of Kueue's
  test/performance/scheduler (default_generator_config.yaml): 5 cohorts x
  6 CQs, nominal 20 units, borrowingLimit 100; per CQ 350 small (1 unit,
  prio 50) + 100 medium (5 units, prio 100) + 50 large (20 units, prio
  200) = 15,000 workloads at scale 1.0, arriving in staggered waves so
  the high-priority wave must preempt; an admitted workload finishes
  ``RUNTIME_CYCLES`` cycles after admission.  The same generator as the
  JAX package's ``bench.py``.
- ``build_northstar``/``run_northstar``: 1,000 CQs in cohorts of 5 with
  100,000 pending workloads and a high-priority preemptor wave injected
  a third of the way in (the JAX package's scripts/northstar_e2e.py
  ``build`` and per-cycle ``run_path``).
- ``build_northstar_fs``/``run_northstar_fs``: fair sharing at the
  north-star size — 1,000 weighted CQs in cohorts of 5 contending for
  cohort quota, 100,000 workloads (scripts/northstar_e2e.py
  ``run_fs_path``, ``--fair-sharing``).
- ``build_tas``/``run_tas``: topology-aware scheduling on a GPU cluster
  (tas-4k) — 8 blocks x 16 subblocks x 32 hosts of 8 GPUs, 32 CQs in 4
  cohorts, 6,400 gang workloads asking for a subblock or a block
  (required or preferred) or for no topology, 60 cycles; the digest
  covers every admission's topology domains.  ``TASBranches`` counts
  which branch of ``TASFlavorSnapshot._find_device`` each query took.

Every workload is generated from the scenario's parameters alone, so two
runs (two devices, or this package and the JAX package) see the same
inputs; ``decision_digest`` hashes what a run decided.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time

import numpy as np

from .api import types as api_types
from .api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    PreemptionPolicy,
    ReclaimWithinCohort,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    WithinClusterQueue,
    Workload,
)
from .controller.driver import Driver

N_COHORTS = 5
CQS_PER_COHORT = 6
UNIT = 1000                        # 1 "unit" = 1 CPU = 1000 milli
CLASSES = [                        # (name, count/CQ, units, priority)
    ("small", 350, 1, 50),
    ("medium", 100, 5, 100),
    ("large", 50, 20, 200),
]
RUNTIME_CYCLES = 10
WAVE_AT_CYCLE = {"small": 0, "medium": 4, "large": 8}


class VirtualClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _preempting_cq(name: str, cohort: str, resources: dict) -> ClusterQueue:
    return ClusterQueue(
        name=name, cohort=cohort,
        preemption=PreemptionPolicy(
            reclaim_within_cohort=ReclaimWithinCohort.ANY,
            within_cluster_queue=WithinClusterQueue.LOWER_PRIORITY),
        resource_groups=[ResourceGroup(
            covered_resources=sorted(resources),
            flavors=[FlavorQuotas(name="default", resources=resources)])])


def build_bench(scale: float = 1.0, device: str = "cuda"):
    """The perf scenario at ``scale`` → (driver, clock, total, waves)."""
    clock = VirtualClock()
    d = Driver(clock=clock, device=device)
    d.apply_resource_flavor(ResourceFlavor(name="default"))
    total = 0
    waves: dict[str, list[Workload]] = {c[0]: [] for c in CLASSES}
    for c in range(N_COHORTS):
        for q in range(CQS_PER_COHORT):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(_preempting_cq(name, f"cohort-{c}", {
                "cpu": ResourceQuota(nominal=20 * UNIT,
                                     borrowing_limit=100 * UNIT)}))
            d.apply_local_queue(LocalQueue(name=f"lq-{c}-{q}",
                                           cluster_queue=name))
            i = 0
            for cls, count, units, prio in CLASSES:
                for k in range(max(1, int(count * scale))):
                    i += 1
                    total += 1
                    waves[cls].append(Workload(
                        name=f"{cls}-{c}-{q}-{k}", queue_name=f"lq-{c}-{q}",
                        priority=prio, creation_time=float(total),
                        pod_sets=[PodSet(name="main", count=1,
                                         requests={"cpu": units * UNIT})]))
    return d, clock, total, waves


def _admission_record(d: Driver, key: str) -> list:
    wl = d.workloads.get(key)
    adm = wl.admission if wl is not None else None
    if adm is None:
        return [key]
    return [key, adm.cluster_queue, sorted(
        (a.name, a.count, sorted(a.flavors.items()))
        for a in adm.pod_set_assignments)]


def _finish_due(d: Driver, running: list, cycle: int) -> tuple[list, int]:
    finished = 0
    still = []
    for finish_at, key in running:
        wl = d.workloads.get(key)
        if wl is None or not wl.has_quota_reservation:
            continue  # evicted/preempted: re-tracked when re-admitted
        if finish_at <= cycle:
            d.finish_workload(key)
            finished += 1
        else:
            still.append((finish_at, key))
    return still, finished


def run_bench(d: Driver, clock: VirtualClock, total: int, waves,
              runtime_cycles: int = RUNTIME_CYCLES) -> dict:
    """Drain the scenario one ``schedule_once`` per cycle."""
    finished = 0
    running: list[tuple[int, str]] = []
    cycle = 0
    cycle_times = []
    preempted = 0
    decisions = []
    pending = sorted(waves.items(), key=lambda kv: WAVE_AT_CYCLE[kv[0]])
    t0 = time.perf_counter()
    while finished < total:
        for cls, wls in list(pending):
            if cycle >= WAVE_AT_CYCLE[cls]:
                for wl in wls:
                    d.create_workload(wl)
                pending.remove((cls, wls))
        cycle += 1
        clock.t += 1.0
        c0 = time.perf_counter()
        stats = d.schedule_once()
        cycle_times.append(time.perf_counter() - c0)
        preempted += len(stats.preempted_targets)
        decisions.append([_admission_record(d, k)
                          for k in sorted(stats.admitted)])
        for key in stats.admitted:
            running.append((cycle + runtime_cycles, key))
        running, n = _finish_due(d, running, cycle)
        finished += n
        if cycle > total * 4 + 1000:
            break
    return dict(wall=time.perf_counter() - t0, cycles=cycle,
                cycle_times=cycle_times, finished=finished, total=total,
                preempted=preempted, decisions=decisions)


def build_northstar(n_cqs: int = 1000, n_wl: int = 100_000,
                    device: str = "cuda", cqs_per_cohort: int = 5):
    """1,000 CQs in cohorts of 5 with ``n_wl`` pending workloads →
    (driver, clock, total, preemptor_wave)."""
    clock = VirtualClock()
    d = Driver(clock=clock, device=device)
    d.apply_resource_flavor(ResourceFlavor(name="default"))
    per_cq = max(1, n_wl // n_cqs)
    for i in range(n_cqs):
        d.apply_cluster_queue(_preempting_cq(
            f"cq-{i}", f"cohort-{i // cqs_per_cohort}",
            {"cpu": ResourceQuota(nominal=20_000, borrowing_limit=100_000)}))
        d.apply_local_queue(LocalQueue(name=f"lq-{i}",
                                       cluster_queue=f"cq-{i}"))
    total = 0
    for i in range(n_cqs):
        for k in range(per_cq):
            total += 1
            if k % 3 == 2:        # medium: 2500/pod x 2 pods
                per_pod, count, prio = 2500, 1 + (k % 2), 100
            else:                 # small: 500/pod x 1..4 pods (ragged)
                per_pod, count, prio = 500, (1, 2, 4)[k % 3], 50
            d.create_workload(Workload(
                name=f"wl-{i}-{k}", queue_name=f"lq-{i}",
                priority=prio, creation_time=float(total),
                pod_sets=[PodSet(name="main", count=count,
                                 requests={"cpu": per_pod})]))

    def preemptor_wave(start_time: float) -> int:
        """One high-priority gang per CQ that fills its nominal quota."""
        for i in range(n_cqs):
            d.create_workload(Workload(
                name=f"pre-{i}", queue_name=f"lq-{i}", priority=200,
                creation_time=start_time + i + 1,
                pod_sets=[PodSet(name="main", count=4,
                                 requests={"cpu": 5000})]))
        return n_cqs

    return d, clock, total, preemptor_wave


def run_northstar(d: Driver, clock: VirtualClock, preemptor_wave,
                  cycles: int = 30, runtime: int = 4,
                  inject_at: int = -1) -> dict:
    """``cycles`` per-cycle ``schedule_once`` calls, the preemptor wave
    injected at ``inject_at`` (default a third of the way in)."""
    inject_at = inject_at if inject_at >= 0 else cycles // 3
    cycle_times = []
    admitted = preempted = 0
    running: list[tuple[int, str]] = []
    decisions = []
    t0 = time.perf_counter()
    for cycle in range(cycles):
        if cycle == inject_at:
            preemptor_wave(clock.t)
        clock.t += 1.0
        c0 = time.perf_counter()
        stats = d.schedule_once()
        cycle_times.append(time.perf_counter() - c0)
        admitted += len(stats.admitted)
        preempted += len(stats.preempted_targets)
        decisions.append([_admission_record(d, k)
                          for k in sorted(stats.admitted)])
        for key in stats.admitted:
            running.append((cycle + runtime, key))
        running, _ = _finish_due(d, running, cycle)
    return dict(wall=time.perf_counter() - t0, cycles=cycles,
                cycle_times=cycle_times, admitted=admitted,
                preempted=preempted, decisions=decisions)


FS_WEIGHTS = (1.0, 2.0, 4.0, 1.0, 0.5)


def northstar_fs_spec(t, d, n_cqs: int = 1000, n_wl: int = 100_000) -> int:
    """Populate driver ``d`` (of either package, ``t`` its api.types
    module) with the fair-sharing north-star cluster: CQs in cohorts of
    5 with fair-sharing weights cycling (1, 2, 4, 1, 0.5), one flavor
    with cpu nominal 4,000 and borrowingLimit 80,000 per CQ, and
    ``n_wl // n_cqs`` workloads of 2,000 mCPU at priority 50 per CQ.
    Per-CQ demand is far above nominal, but the five CQs of a cohort
    fill its whole quota at nominal, so no CQ ever borrows: every DRS in
    the tournament is 0 and timestamps decide.  Returns the workload
    count."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    per_cq = max(1, n_wl // n_cqs)
    for i in range(n_cqs):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort=f"cohort-{i // 5}",
            fair_sharing=t.FairSharing(weight=FS_WEIGHTS[i % 5]),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=4_000,
                                           borrowing_limit=80_000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{i}",
                                         cluster_queue=f"cq-{i}"))
    total = 0
    for i in range(n_cqs):
        for k in range(per_cq):
            total += 1
            d.create_workload(t.Workload(
                name=f"wl-{i}-{k}", queue_name=f"lq-{i}", priority=50,
                creation_time=float(total),
                pod_sets=[t.PodSet(name="main", count=1,
                                   requests={"cpu": 2_000})]))
    return total


def build_northstar_fs(n_cqs: int = 1000, n_wl: int = 100_000,
                       device: str = "cuda"):
    """The fair-sharing north-star run's cluster on a
    ``Driver(fair_sharing=True)`` → (driver, clock, total)."""
    clock = VirtualClock()
    d = Driver(clock=clock, fair_sharing=True, device=device)
    total = northstar_fs_spec(api_types, d, n_cqs, n_wl)
    return d, clock, total


def run_northstar_fs(d, clock: VirtualClock, cycles: int = 30,
                     runtime: int = 4) -> dict:
    """``cycles`` per-cycle ``schedule_once`` calls; each admission
    finishes ``runtime`` cycles later (scripts/northstar_e2e.py
    ``run_fs_path``).  Works on either package's Driver."""
    cycle_times = []
    admitted = skipped = 0
    running: list[tuple[int, str]] = []
    decisions = []
    t0 = time.perf_counter()
    for cycle in range(cycles):
        clock.t += 1.0
        c0 = time.perf_counter()
        stats = d.schedule_once()
        cycle_times.append(time.perf_counter() - c0)
        admitted += len(stats.admitted)
        skipped += len(stats.skipped)
        decisions.append([_admission_record(d, k) for k in stats.admitted])
        for key in stats.admitted:
            running.append((cycle + runtime, key))
        running, _ = _finish_due(d, running, cycle)
    return dict(wall=time.perf_counter() - t0, cycles=cycles,
                cycle_times=cycle_times, admitted=admitted,
                skipped=skipped, decisions=decisions)


def decision_digest(d: Driver, decisions=None) -> str:
    """sha256 of the driver's event log in order (QuotaReserved /
    Preempted / Finished / ...) plus, per cycle, each admission's CQ and
    flavors."""
    h = hashlib.sha256()
    h.update(json.dumps(d.events).encode())
    if decisions is not None:
        h.update(json.dumps(decisions).encode())
    return h.hexdigest()


def percentile(times: list, q: float) -> float:
    s = sorted(times)
    return s[min(len(s) - 1, int(len(s) * q))] if s else 0.0


# ----------------------------------------------------------------------
# The fused burst path (Driver.schedule_burst)
# ----------------------------------------------------------------------

def _carry_finishes(d: Driver, all_stats: list, runtime: int) -> dict:
    """Finish schedule (offset from the next cycle → keys) of admissions
    from earlier calls that still hold quota."""
    base = len(all_stats)
    ext: dict = {}
    for j, s in enumerate(all_stats):
        fin = j + runtime
        if fin >= base:
            keys = [k for k in s.admitted
                    if (wl := d.workloads.get(k)) is not None
                    and wl.has_quota_reservation]
            if keys:
                ext[fin - base] = keys
    return ext


def drain_bench_burst(d: Driver, clock: VirtualClock, total: int, waves,
                      runtime_cycles: int = RUNTIME_CYCLES) -> dict:
    """Drain the perf scenario through ``Driver.schedule_burst`` (the
    JAX package's bench.py ``run_burst``): each call runs up to the next
    wave, finishes run inside the burst (``runtime`` plus the carried
    finish schedule of earlier calls).  Per-cycle times are measured
    between applied-cycle boundaries, finish work excluded."""
    cycle_times: list = []
    decisions: list = []
    preempted = 0
    all_stats: list = []
    pending = sorted(waves.items(), key=lambda kv: WAVE_AT_CYCLE[kv[0]])
    last_t = time.perf_counter()

    def on_cycle_start(_k):
        clock.t += 1.0

    def on_cycle(_k, stats):
        nonlocal last_t, preempted
        now = time.perf_counter()
        cycle_times.append(max(0.0, now - last_t - stats.finish_s))
        last_t = now
        preempted += len(stats.preempted_targets)
        decisions.append([_admission_record(d, k)
                          for k in sorted(stats.admitted)])

    t0 = time.perf_counter()
    finished = 0
    while True:
        finished = sum(1 for wl in d.workloads.values() if wl.is_finished)
        if finished >= total and not pending:
            break
        cycle = len(cycle_times)
        for cls, wls in list(pending):
            if cycle >= WAVE_AT_CYCLE[cls]:
                for wl in wls:
                    d.create_workload(wl)
                pending.remove((cls, wls))
        next_wave = min((WAVE_AT_CYCLE[c] for c, _ in pending),
                        default=None)
        base = len(all_stats)
        target = max(base + 1,
                     next_wave if next_wave is not None else base + 64)
        ext = _carry_finishes(d, all_stats, runtime_cycles)
        last_t = time.perf_counter()
        stats = d.schedule_burst(target - base, runtime=runtime_cycles,
                                 external_finishes=ext, on_cycle=on_cycle,
                                 on_cycle_start=on_cycle_start)
        all_stats.extend(stats)
        if not stats and pending:
            # quiet cycles until the next wave arrives
            while len(cycle_times) < next_wave:
                clock.t += 1.0
                cycle_times.append(0.0)
                decisions.append([])
            continue
        if len(all_stats) > total * 4 + 1000:
            break
    return dict(wall=time.perf_counter() - t0, cycles=len(cycle_times),
                cycle_times=cycle_times, finished=finished, total=total,
                preempted=preempted, decisions=decisions)


def northstar_burst(d: Driver, clock: VirtualClock, preemptor_wave,
                    cycles: int = 30, runtime: int = 4,
                    inject_at: int = -1, pipeline: bool = True) -> dict:
    """The north-star run through ``Driver.schedule_burst`` (the main
    phase of the JAX package's scripts/northstar_e2e.py
    ``run_burst_path``): windows of clean cycles decided in single
    launches, the preemptor wave injected at ``inject_at`` (default a
    third of the way in)."""
    inject_at = inject_at if inject_at >= 0 else cycles // 3
    cycle_times: list = []
    decisions: list = []
    admitted = preempted = 0
    all_stats: list = []
    last_t = time.perf_counter()

    def on_cycle_start(_k):
        clock.t += 1.0

    def on_cycle(_k, stats):
        nonlocal last_t, admitted, preempted
        now = time.perf_counter()
        cycle_times.append(max(0.0, now - last_t - stats.finish_s))
        last_t = now
        admitted += len(stats.admitted)
        preempted += len(stats.preempted_targets)
        decisions.append([_admission_record(d, k)
                          for k in sorted(stats.admitted)])

    t0 = time.perf_counter()
    injected = False
    while len(all_stats) < cycles:
        if not injected and len(all_stats) >= inject_at:
            preemptor_wave(clock.t)
            injected = True
        target = cycles if injected else inject_at
        base = len(all_stats)
        ext = _carry_finishes(d, all_stats, runtime)
        last_t = time.perf_counter()
        stats = d.schedule_burst(target - base, runtime=runtime,
                                 external_finishes=ext, on_cycle=on_cycle,
                                 on_cycle_start=on_cycle_start,
                                 pipeline=pipeline)
        all_stats.extend(stats)
        if not stats:
            if injected:
                break
            from .scheduler.scheduler import CycleStats
            while len(all_stats) < inject_at:
                clock.t += 1.0
                all_stats.append(CycleStats())
                cycle_times.append(0.0)
                decisions.append([])
    return dict(wall=time.perf_counter() - t0, cycles=len(all_stats),
                cycle_times=cycle_times, admitted=admitted,
                preempted=preempted, decisions=decisions)


def burst_boundary_report(bstats: dict) -> dict:
    """The burst boundary pipeline from ``BurstSolver.stats``: window
    boundaries whose pack + launch overlapped the previous apply,
    speculations discarded, serial windows, and the delta-pack reuse."""
    overlapped = bstats.get("burst_overlapped_packs", 0)
    packs = bstats.get("burst_packs", 0)
    return {
        "overlapped_packs": overlapped,
        "spec_dispatches": bstats.get("burst_spec_dispatches", 0),
        "spec_cancelled": bstats.get("burst_spec_cancelled", 0),
        "serial_windows": bstats.get("burst_serial_windows", 0),
        "serial_pack_s": round(bstats.get("burst_pack_s", 0.0), 4),
        "boundary_overlap_share": round(
            overlapped / max(1, overlapped + packs), 3),
        "spec_fetch_wait_s": round(
            bstats.get("burst_spec_fetch_wait_s", 0.0), 4),
        "target_divergences": bstats.get("burst_target_divergences", 0),
        "delta_packs": bstats.get("burst_delta_packs", 0),
        "full_packs": bstats.get("burst_full_packs", 0),
        "rows_reused": bstats.get("rows_reused", 0),
        "rows_repacked": bstats.get("rows_repacked", 0),
        "delta_pack_s": round(bstats.get("delta_pack_s", 0.0), 4),
    }


# ----------------------------------------------------------------------
# Topology-aware scheduling (tas-4k)
# ----------------------------------------------------------------------

# the level labels of Kueue's TAS documentation for GPU node pools
TAS_LEVELS = ("cloud.google.com/gce-topology-block",
              "cloud.google.com/gce-topology-subblock",
              "kubernetes.io/hostname")
TAS_GPU = "nvidia.com/gpu"
TAS_NODE = {TAS_GPU: 8, "cpu": 192_000, "pods": 110}
TAS_FLAVOR = "tas-gpu"
TAS_8GPU_COUNTS = (1, 2, 4, 8, 16, 32, 64, 128)
# (request, share): required subblock, preferred subblock (spilling to
# the block), required block, unconstrained
TAS_MIX = (("required", 1, 0.4), ("preferred", 1, 0.3),
           ("required", 0, 0.2), ("unconstrained", None, 0.1))


@contextlib.contextmanager
def tas_gates(device_kernel: bool = True, **profiles):
    """TopologyAwareScheduling on and TASDeviceKernel as given (plus any
    ``TASProfile*`` gates) in this package's ``features`` for the
    duration; every gate returns to what it was."""
    from . import features
    gates = {"TopologyAwareScheduling": True,
             "TASDeviceKernel": device_kernel, **profiles}
    with contextlib.ExitStack() as stack:
        for name, value in gates.items():
            stack.enter_context(
                features.set_feature_gate_during_test(name, value))
        yield


def tas_spec(t, d, node_info, *, blocks: int = 8, subblocks: int = 16,
             hosts: int = 32, n_cqs: int = 32, n_cohorts: int = 4,
             per_cq: int = 200, seed: int = 0) -> dict:
    """Populate driver ``d`` (of either package; ``t`` its api.types
    module, ``node_info`` its ``cache.tas_cache.NodeInfo``) with the
    tas-4k cluster: a three-level topology (block → subblock → host)
    of ``blocks x subblocks x hosts`` nodes with 8 GPUs, 192 CPU and 110
    pods each; one TAS flavor; ``n_cqs`` ClusterQueues in ``n_cohorts``
    cohorts whose nominal quotas add up to the cluster (borrowing within
    the cohort unlimited); ``per_cq`` single-PodSet workloads per CQ,
    half of 8-GPU pods (one per host, 1-128 pods) and half of 1-GPU pods
    (8-64), asking for a topology as ``TAS_MIX`` says.  Returns each
    workload's runtime in cycles after admission (3-12)."""
    rng = np.random.default_rng(seed)
    d.apply_topology(t.Topology(name="gpu-topology", levels=list(TAS_LEVELS)))
    d.apply_resource_flavor(t.ResourceFlavor(name=TAS_FLAVOR,
                                             topology_name="gpu-topology"))
    for b in range(blocks):
        for sb in range(subblocks):
            for h in range(hosts):
                d.cache.tas.add_or_update_node(node_info(
                    name=f"gpu-{b}-{sb}-{h}",
                    labels=dict(zip(TAS_LEVELS, (
                        f"block-{b}", f"subblock-{b}-{sb}",
                        f"gpu-{b}-{sb}-{h}"))),
                    capacity=dict(TAS_NODE)))
    n_nodes = blocks * subblocks * hosts
    per_cohort = max(1, n_cqs // n_cohorts)
    for i in range(n_cqs):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort=f"cohort-{i // per_cohort}",
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu", TAS_GPU],
                flavors=[t.FlavorQuotas(name=TAS_FLAVOR, resources={
                    "cpu": t.ResourceQuota(
                        nominal=n_nodes * TAS_NODE["cpu"] // n_cqs),
                    TAS_GPU: t.ResourceQuota(
                        nominal=n_nodes * TAS_NODE[TAS_GPU] // n_cqs)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{i}",
                                         cluster_queue=f"cq-{i}"))
    levels = {1: TAS_LEVELS[1], 0: TAS_LEVELS[0]}
    shares = np.array([m[2] for m in TAS_MIX])
    runtimes = {}
    total = 0
    for k in range(per_cq):
        for i in range(n_cqs):
            total += 1
            kind, level, _ = TAS_MIX[int(rng.choice(len(TAS_MIX),
                                                    p=shares))]
            if kind == "unconstrained":
                req = t.PodSetTopologyRequest(unconstrained=True)
            else:
                req = t.PodSetTopologyRequest(**{kind: levels[level]})
            if k == 0 and i % per_cohort == 0:
                # a gang of 1.5 blocks opens each cohort: it must split
                # across blocks (preferred) or cannot fit (required)
                req = t.PodSetTopologyRequest(
                    **{("preferred", "required")[i // per_cohort % 2]:
                       levels[1 - i // per_cohort % 2]})
                count = subblocks * hosts * 3 // 2
                per_pod = {TAS_GPU: 8, "cpu": 96_000}
            elif rng.random() < 0.5:
                counts = TAS_8GPU_COUNTS
                if kind == "required" and level == 1:
                    # a gang that requires a subblock fits in one
                    counts = tuple(c for c in counts if c <= hosts)
                count = int(rng.choice(counts))
                per_pod = {TAS_GPU: 8, "cpu": 96_000}
            else:
                count = int(rng.integers(8, 65))
                per_pod = {TAS_GPU: 1, "cpu": 12_000}
            name = f"wl-{i}-{k}"
            d.create_workload(t.Workload(
                name=name, queue_name=f"lq-{i}", priority=50,
                creation_time=float(total),
                pod_sets=[t.PodSet(name="main", count=count,
                                   requests=per_pod, topology_request=req)]))
            runtimes[name] = int(rng.integers(3, 13))
    return runtimes


def build_tas(device: str = "cuda", **kw):
    """The tas-4k cluster on this package's Driver → (driver, clock,
    runtimes by workload name); keywords as ``tas_spec``.  The TAS gates
    are the caller's to set (``tas_gates``)."""
    from .cache.tas_cache import NodeInfo
    clock = VirtualClock()
    d = Driver(clock=clock, device=device)
    runtimes = tas_spec(api_types, d, NodeInfo, **kw)
    return d, clock, runtimes


def _tas_admission_record(d, key: str) -> list:
    """An admission's CQ, flavors and topology domains with counts."""
    adm = d.workloads[key].admission
    return [key, adm.cluster_queue, sorted(
        (a.name, a.count, sorted(a.flavors.items()),
         [[list(dom.values), dom.count]
          for dom in a.topology_assignment.domains]
         if a.topology_assignment else None)
        for a in adm.pod_set_assignments)]


def run_tas(d, clock: VirtualClock, runtimes: dict, cycles: int = 60) -> dict:
    """``cycles`` per-cycle ``schedule_once`` calls on either package's
    Driver; each admission finishes its runtime later.  ``events_at``
    holds the event-log length after each cycle (``tas_digest`` of a
    prefix)."""
    cycle_times = []
    admitted = 0
    running: list[tuple[int, str]] = []
    decisions = []
    events_at = []
    t0 = time.perf_counter()
    for cycle in range(cycles):
        clock.t += 1.0
        c0 = time.perf_counter()
        stats = d.schedule_once()
        cycle_times.append(time.perf_counter() - c0)
        admitted += len(stats.admitted)
        decisions.append([_tas_admission_record(d, k)
                          for k in sorted(stats.admitted)])
        for key in stats.admitted:
            running.append((cycle + runtimes[key.split("/")[-1]], key))
        running, _ = _finish_due(d, running, cycle)
        events_at.append(len(d.events))
    return dict(wall=time.perf_counter() - t0, cycles=cycles,
                cycle_times=cycle_times, admitted=admitted,
                decisions=decisions, events_at=events_at)


def tas_digest(d, r: dict, cycles: int | None = None) -> str:
    """``decision_digest`` of the first ``cycles`` cycles of a
    ``run_tas`` result (all when None): events and per-cycle admissions
    with their topology assignments."""
    n = r["cycles"] if cycles is None else cycles
    h = hashlib.sha256()
    h.update(json.dumps(d.events[:r["events_at"][n - 1]]).encode())
    h.update(json.dumps(r["decisions"][:n]).encode())
    return h.hexdigest()


class TASBranches:
    """While entered, counts (in ``counts``) the branch each query of this
    package's ``TASFlavorSnapshot._find_device`` took — a required level
    that fits or fails (the message path), a preferred level that fits
    at once or after climbing, the root-split fallback, unconstrained —
    the ``simulate_empty`` retries that follow a failed fit
    (``FlavorAssigner._find_tas``), the calls of each ``ops.tas_kernel``
    function, and the host scalar walk's ``_fill_in_counts``."""

    BRANCHES = ("required_fit", "required_fail", "preferred_fit",
                "preferred_climb", "root_split", "unconstrained",
                "simulate_empty_after_failed_fit")
    CALLS = ("fill_counts", "best_fit_descend", "split_across_roots",
             "scalar_walk")

    def __init__(self):
        self.counts = dict.fromkeys(self.BRANCHES + self.CALLS, 0)
        self._query = None
        self._failed_fit = False
        self._undo = []

    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def __enter__(self):
        from .cache.tas_snapshot import TASFlavorSnapshot
        from .ops import tas_kernel
        from .scheduler.flavorassigner import FlavorAssigner
        counts = self.counts

        def find_device(orig):
            def wrapped(snap, count, per_pod, request, assumed,
                        required_idx, preferred_idx):
                self._query = query = dict.fromkeys(self.CALLS[:3], 0)
                out = orig(snap, count, per_pod, request, assumed,
                           required_idx, preferred_idx)
                self._query = None
                if request.unconstrained:
                    key = "unconstrained"
                elif required_idx is not None:
                    key = ("required_fit" if out[0] is not None
                           else "required_fail")
                elif query["split_across_roots"]:
                    key = "root_split"
                elif query["best_fit_descend"] > 1:
                    key = "preferred_climb"
                else:
                    key = "preferred_fit"
                counts[key] += 1
                return out
            return wrapped

        def kernel(name):
            def make(orig):
                def wrapped(*args, **kw):
                    counts[name] += 1
                    if self._query is not None:
                        self._query[name] += 1
                    return orig(*args, **kw)
                return wrapped
            return make

        def find_tas(orig):
            def wrapped(fa, assignment, requests, simulate_empty,
                        record=True):
                ok = orig(fa, assignment, requests, simulate_empty,
                          record=record)
                if simulate_empty and self._failed_fit:
                    counts["simulate_empty_after_failed_fit"] += 1
                self._failed_fit = not simulate_empty and not ok
                return ok
            return wrapped

        def fill_in_counts(orig):
            def wrapped(*args, **kw):
                counts["scalar_walk"] += 1
                return orig(*args, **kw)
            return wrapped

        self._patch(TASFlavorSnapshot, "_find_device", find_device)
        self._patch(TASFlavorSnapshot, "_fill_in_counts", fill_in_counts)
        self._patch(FlavorAssigner, "_find_tas", find_tas)
        for name in self.CALLS[:3]:
            self._patch(tas_kernel, name, kernel(name))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()
        return False
