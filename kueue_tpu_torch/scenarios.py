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

Every workload is generated from the scenario's parameters alone, so two
runs (two devices, or this package and the JAX package) see the same
inputs; ``decision_digest`` hashes what a run decided.
"""

from __future__ import annotations

import hashlib
import json
import time

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
