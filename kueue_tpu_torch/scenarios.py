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
- ``build_entry_scenario``/``packed_cycle``/``entry``: the JAX package's
  ``__graft_entry__`` scenario (2 cohorts x 2 CQs, 24 workloads, optional
  contention and preemption), its packed first cycle, and the one-call
  cycle solver as a step on those planes; ``dryrun_multichip`` is
  ``__graft_entry__.dryrun_multichip`` over the port's per-cycle mesh.
- ``shards=`` of ``build_bench`` / ``build_northstar`` /
  ``build_northstar_fs`` (``shards_env``): the same drains with the
  Driver's per-cycle mesh (``KUEUE_TPU_SHARDS``).
- ``probe_synth``: the synthetic north-star cycle of
  ``scripts/northstar_probe.py`` (100,000 heads x 1,000 CQs, no host
  objects), driven by ``kueue_tpu_torch.probe``.
- ``build_tas``/``run_tas``: topology-aware scheduling on a GPU cluster
  (tas-4k) — 8 blocks x 16 subblocks x 32 hosts of 8 GPUs, 32 CQs in 4
  cohorts, 6,400 gang workloads asking for a subblock or a block
  (required or preferred) or for no topology, 60 cycles; the digest
  covers every admission's topology domains.  ``TASBranches`` counts
  which branch of ``TASFlavorSnapshot._find_device`` each query took.
- ``sustained_spec``/``sustained_drain``: the JAX tests' sustained burst
  drain (2 CQs, 72 workloads) with a high-priority arrival at cycle 36,
  serial or forest-sharded (``BurstSolver.set_shards``), optionally
  losing devices half-way; with ``n_cqs`` the same drain at north-star
  width (``northstar_resident_spec``: 1,000 CQs in cohorts of 5, a
  backlog in every fifth, 40 reclaiming arrivals at cycle 36), whose
  window boundaries are delta packs that the shard-resident copy serves.

Every workload is generated from the scenario's parameters alone, so two
runs (two devices, or this package and the JAX package) see the same
inputs; ``decision_digest`` hashes what a run decided.

Collection, as the reference scripts run it: the builds end with
``freeze_heap`` (``gc.collect(); gc.freeze()``), the drains are
``measured`` (``gc.disable()``, enabled again in a ``finally``), and
``release`` (``gc.unfreeze(); gc.collect()``) frees a finished run's
graph before the next build.  Decisions do not depend on it.
"""

from __future__ import annotations

import contextlib
import functools
import gc
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


@contextlib.contextmanager
def shards_env(shards: int):
    """``KUEUE_TPU_SHARDS=shards`` while the block runs (a Driver built
    in it sets the per-cycle mesh; 0 leaves the environment as it is)."""
    if not shards:
        yield
        return
    import os
    prev = os.environ.get("KUEUE_TPU_SHARDS")
    os.environ["KUEUE_TPU_SHARDS"] = str(shards)
    try:
        yield
    finally:
        if prev is None:
            del os.environ["KUEUE_TPU_SHARDS"]
        else:
            os.environ["KUEUE_TPU_SHARDS"] = prev


def freeze_heap() -> None:
    """Collect, then move everything alive into the permanent generation
    (``gc.freeze``): what a build leaves is never scanned again by a
    collection, as ``scripts/northstar_e2e.py`` ``build()`` (:199-200,
    :517-518) and ``bench.py`` (:312-313) do after building."""
    gc.collect()
    gc.freeze()


def release() -> None:
    """Undo ``freeze_heap`` and collect (``bench.py`` :332-333): a
    finished phase's driver graph, once unreferenced, is freed before
    the next phase builds its own."""
    gc.unfreeze()
    gc.collect()


def measured(fn):
    """``fn`` run with automatic collection off, as the reference's
    drains run under ``gc.disable()`` (northstar_e2e.py :292/:443,
    :592/:634); on again afterwards, also when ``fn`` raises (left off
    when it was off before)."""
    @functools.wraps(fn)
    def run(*args, **kw):
        was = gc.isenabled()
        gc.disable()
        try:
            return fn(*args, **kw)
        finally:
            if was:
                gc.enable()
    return run


def build_bench(scale: float = 1.0, device: str = "cuda",
                solver_backend: str = "auto", shards: int = 0):
    """The perf scenario at ``scale`` → (driver, clock, total, waves);
    ``shards`` > 1: the Driver's per-cycle mesh (``shards_env``)."""
    clock = VirtualClock()
    with shards_env(shards):
        d = Driver(clock=clock, device=device,
                   solver_backend=solver_backend)
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
    freeze_heap()
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


@measured
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
                    device: str = "cuda", cqs_per_cohort: int = 5,
                    shards: int = 0):
    """1,000 CQs in cohorts of 5 with ``n_wl`` pending workloads →
    (driver, clock, total, preemptor_wave); ``shards`` as
    ``build_bench``'s."""
    clock = VirtualClock()
    with shards_env(shards):
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

    freeze_heap()
    return d, clock, total, preemptor_wave


@measured
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
                       device: str = "cuda", shards: int = 0):
    """The fair-sharing north-star run's cluster on a
    ``Driver(fair_sharing=True)`` → (driver, clock, total); ``shards``
    as ``build_bench``'s."""
    clock = VirtualClock()
    with shards_env(shards):
        d = Driver(clock=clock, fair_sharing=True, device=device)
    total = northstar_fs_spec(api_types, d, n_cqs, n_wl)
    freeze_heap()
    return d, clock, total


@measured
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


@measured
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


@measured
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
        # the forest-sharded burst (absent on the serial path)
        **{k[len("burst_"):]: bstats[k] for k in (
            "burst_sharded_dispatches", "burst_resident_hits",
            "burst_resident_misses", "burst_resident_scatter_rows",
            "burst_resident_scatter_ranges", "burst_boundary_bytes_h2d",
            "burst_boundary_bytes_equiv", "burst_shard_degradations")
           if k in bstats},
    }


def sustained_spec(t, d, per_cq: int = 36) -> None:
    """tests/test_burst_pipeline.py ``sustained_spec``: 2 CQs of one
    cohort (4,000 mCPU nominal each), ``per_cq`` workloads of 2,000 mCPU
    each with priorities 0/10/20 — more than one K = 32 window of work,
    finishes feeding re-admission for dozens of cycles.  ``t`` is this
    package's api.types."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for q in range(2):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-0-{q}", cohort="co-0",
            queueing_strategy=t.QueueingStrategy.BEST_EFFORT_FIFO,
            preemption=t.PreemptionPolicy(),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=4000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-0-{q}",
                                         cluster_queue=f"cq-0-{q}"))
    n = 0
    for q in range(2):
        for i in range(per_cq):
            n += 1
            d.create_workload(t.Workload(
                name=f"w-{q}-{i}", queue_name=f"lq-0-{q}",
                priority=(i % 3) * 10, creation_time=float(n),
                pod_sets=[t.PodSet(name="main", count=1,
                                   requests={"cpu": 2000})]))


def northstar_resident_spec(t, d, n_cqs: int = 1000, per_cq: int = 100,
                            active_every: int = 5) -> None:
    """The north-star cluster of ``build_northstar`` (``n_cqs`` CQs in
    cohorts of 5, 20,000 mCPU nominal and 100,000 borrowing each, cohort
    reclaim and in-CQ priority preemption) with the north-star workload
    mix queued in every ``active_every``-th CQ only: one busy tenant per
    cohort borrowing its neighbours' idle quota.  A window boundary then
    re-walks the busy CQs and the arrivals — a delta pack — instead of
    every CQ.  ``t`` is this package's api.types."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for i in range(n_cqs):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{i}", cohort=f"cohort-{i // 5}",
            preemption=t.PreemptionPolicy(
                reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
                within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY),
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=20_000,
                                           borrowing_limit=100_000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{i}",
                                         cluster_queue=f"cq-{i}"))
    n = 0
    for i in range(0, n_cqs, active_every):
        for k in range(per_cq):
            n += 1
            if k % 3 == 2:        # medium: 2500/pod x 2 pods
                per_pod, count, prio = 2500, 1 + (k % 2), 100
            else:                 # small: 500/pod x 1..4 pods (ragged)
                per_pod, count, prio = 500, (1, 2, 4)[k % 3], 50
            d.create_workload(t.Workload(
                name=f"wl-{i}-{k}", queue_name=f"lq-{i}", priority=prio,
                creation_time=float(n), pod_sets=[t.PodSet(
                    name="main", count=count, requests={"cpu": per_pod})]))


def northstar_arrivals(t, n_cqs: int, n: int) -> list:
    """``n`` high-priority gangs (4 x 5,000 mCPU) in the idle CQs 1, 6,
    11, ... of ``northstar_resident_spec``: each reclaims its nominal
    quota from its cohort's busy borrower.  ``t`` is this package's
    api.types."""
    return [t.Workload(
        name=f"arrival-{j}", queue_name=f"lq-{(5 * j + 1) % n_cqs}",
        priority=200, creation_time=1e6 + j, pod_sets=[t.PodSet(
            name="main", count=4, requests={"cpu": 5000})])
        for j in range(n)]


@measured
def sustained_drain(device: str = "cuda", shards: int = 0,
                    cycles: int = 80, runtime: int = 2, arrival: int = 36,
                    lose: int = 0, n_cqs: int = 0) -> dict:
    """The sustained drain through ``schedule_burst`` with a
    high-priority arrival at applied cycle ``arrival``
    (tests/test_multichip_parity.py :148): ``shards > 1`` shards the
    burst over ``parallel.sharded.make_burst_mesh(shards)``.  With
    ``lose``, the drain runs as two calls of ``cycles / 2`` with
    ``lose_devices(lose)`` between them (:182).  ``n_cqs > 0`` drains
    ``northstar_resident_spec(n_cqs)`` instead, with ``n_cqs / 25``
    ``northstar_arrivals`` at ``arrival`` (pass a ``runtime`` longer
    than a window, as 30, so that the busy CQs stay full).  Returns the
    per-cycle records (admitted, skipped, inadmissible, preempted,
    preempting), the burst solver's stats, the shard counts before and
    after, and the Driver.  The call builds and drains, and the whole of
    it is measured: it runs with collection off and freezes nothing."""
    from .api import types as t
    from .ops.burst import BurstSolver
    clock = VirtualClock()
    d = Driver(clock=clock, device=device)
    if n_cqs:
        northstar_resident_spec(t, d, n_cqs)
        arrivals = northstar_arrivals(t, n_cqs, max(1, n_cqs // 25))
    else:
        sustained_spec(t, d)
        arrivals = [t.Workload(
            name="boss", queue_name="lq-0-0", priority=100,
            creation_time=500.0, pod_sets=[t.PodSet(
                name="main", count=1, requests={"cpu": 4000})])]
    bs = BurstSolver(device=device)
    if shards > 1:
        bs.set_shards(shards)
    d._burst_solver = bs

    def on_cycle_start(k):
        if k == arrival:
            for wl in arrivals:
                d.create_workload(wl)
        clock.t += 1.0

    calls = (cycles // 2, cycles - cycles // 2) if lose else (cycles,)
    stats, n_shards = [], [bs.n_shards]
    for i, n in enumerate(calls):
        if i:
            n_shards.append(bs.lose_devices(lose))
        stats += d.schedule_burst(n, runtime=runtime,
                                  on_cycle_start=on_cycle_start)
    records = [(sorted(x.admitted), sorted(x.skipped),
                sorted(x.inadmissible), sorted(x.preempted_targets),
                sorted(x.preempting)) for x in stats]
    return dict(records=records, stats=dict(bs.stats), shards=n_shards,
                driver=d)


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
    freeze_heap()
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


@measured
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


# ----------------------------------------------------------------------
# The one-call cycle solver: entry() and the north-star probe
# ----------------------------------------------------------------------

def build_entry_scenario(n_cohorts=2, cqs_per_cohort=2, n_flavors=2,
                         n_workloads=24, contended=False, preemption=False,
                         use_device_solver=False, device: str = "cuda"):
    """A deterministic borrowing-enabled scenario through the real driver
    (the JAX package's ``__graft_entry__._build_scenario``).

    ``contended=True`` gives flavor-0 a small nominal and mixes request
    sizes so the first cycle exercises in-scan skips, borrowing and
    slot-1 flavor fallback; ``preemption=True`` enables reclaim /
    lower-priority preemption on every CQ.  ``device`` is the Driver's
    (its solver's, with ``use_device_solver``)."""
    t = [100.0]

    def clock():
        t[0] += 1.0
        return t[0]

    d = Driver(clock=clock, use_device_solver=use_device_solver,
               device=device)
    pre_policy = (PreemptionPolicy(
        reclaim_within_cohort=ReclaimWithinCohort.ANY,
        within_cluster_queue=WithinClusterQueue.LOWER_PRIORITY)
        if preemption else PreemptionPolicy())
    flavors = [f"flavor-{i}" for i in range(n_flavors)]
    for f in flavors:
        d.apply_resource_flavor(ResourceFlavor(name=f))
    if contended:
        cpu_quota = {flavors[0]: ResourceQuota(nominal=2000,
                                               borrowing_limit=8000)}
        for f in flavors[1:]:
            cpu_quota[f] = ResourceQuota(nominal=8000, borrowing_limit=8000)
        sizes = [1500, 2500, 6000, 12_000]
    else:
        cpu_quota = {f: ResourceQuota(nominal=8000, borrowing_limit=8000)
                     for f in flavors}
        sizes = [500, 750, 1000, 1250]
    for c in range(n_cohorts):
        d.apply_cohort(api_types.Cohort(name=f"cohort-{c}"))
        for q in range(cqs_per_cohort):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(ClusterQueue(
                name=name, cohort=f"cohort-{c}",
                preemption=pre_policy,
                resource_groups=[ResourceGroup(
                    covered_resources=["cpu", "memory"],
                    flavors=[FlavorQuotas(name=f, resources={
                        "cpu": cpu_quota[f],
                        "memory": ResourceQuota(nominal=64 << 30)})
                             for f in flavors])]))
            d.apply_local_queue(LocalQueue(name=f"lq-{c}-{q}",
                                           cluster_queue=name))
    for i in range(n_workloads):
        c = i % n_cohorts
        q = (i // n_cohorts) % cqs_per_cohort
        count = 1 if contended else 1 + i % 2
        d.create_workload(Workload(
            name=f"wl-{i}", queue_name=f"lq-{c}-{q}",
            priority=(i * 7) % 3, creation_time=float(i + 1),
            pod_sets=[PodSet(name="main", count=count,
                             requests={"cpu": sizes[i % 4],
                                       "memory": 1 << 30})]))
    return d


def packed_cycle(**kw):
    """(driver, heads, snapshot, packed first cycle) of
    ``build_entry_scenario(**kw)`` (``__graft_entry__._packed_cycle``)."""
    from .ops.packing import pack_cycle
    d = build_entry_scenario(**kw)
    heads = d.queues.heads_nonblocking()
    snapshot = d.cache.snapshot()
    # nominate resolves each head's LocalQueue → ClusterQueue binding
    # (reference scheduler.go:336); the packer needs it set
    d.scheduler.nominate(heads, snapshot)
    return d, heads, snapshot, pack_cycle(snapshot, heads)


def entry(device: str = "cuda"):
    """(step, example_args): the one-call cycle solver on the packed first
    cycle of the entry scenario, its planes on ``device`` (the card by
    default; raises without one).  ``step(*example_args)`` returns
    ``ops.cycle.solve_cycle``'s six outputs."""
    from .ops.cycle import solve_cycle
    from .parallel import cycle_args

    _, _, _, packed = packed_cycle(device="cpu")
    depth = packed.depth

    def step(*args):
        return solve_cycle(*args, depth=depth)

    return step, cycle_args(packed, device=device)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The port's ``__graft_entry__.dryrun_multichip``: over an
    ``n_devices`` (wl, cq) mesh of ``device`` (``make_mesh``; on one card
    a virtual mesh must be on), check

    1. the sharded one-call solver's first cycle of the contended entry
       scenario (64 CQs, W >= 64) against the host scheduler on the
       same snapshot: the admitted set, the admission order and every
       admitted workload's flavors, with in-scan skips, borrowing and
       flavor fallback all present;
    2. ``sharded_cycle_fn`` against the unsharded ``solve_cycle``: all
       six outputs equal, and both timed (host clock around a
       synchronised call, after a warm call);
    3. six production cycles with a preemptor wave through
       ``CycleSolver.set_mesh``, each equal to the host scheduler's,
       with sharded (and sharded preempt) dispatches and preemptions;
    4. three such cycles on the hybrid layout (``make_hybrid_mesh`` over
       4 or 2 hosts).

    Prints the reference's line and returns its counts."""
    import torch

    from .ops.cycle import cycle_order_np, solve_cycle
    from .parallel.sharded import (cycle_args, make_hybrid_mesh, make_mesh,
                                   sharded_cycle_fn)
    mesh = make_mesh(n_devices, device=device)
    if mesh is None:
        raise RuntimeError(f"make_mesh({n_devices}): fewer {device} "
                           f"devices than that")
    shape = dict(n_cohorts=16, cqs_per_cohort=4, n_flavors=2,
                 n_workloads=192, contended=True)
    driver, _, _, packed = packed_cycle(device="cpu", **shape)
    W = packed.wl_cq.shape[0]
    assert packed.wl_count >= 64, packed.wl_count
    args = cycle_args(packed, device=device)
    fn = sharded_cycle_fn(mesh, depth=packed.depth)
    admitted, slots, borrows, preempt0, fit_slot0, borrows0 = [
        o.cpu().numpy() for o in fn(*args)]

    # -- exact first-cycle equality against the host scheduler ----------
    host_driver = build_entry_scenario(device="cpu", **shape)
    host_stats = host_driver.schedule_once()
    order = cycle_order_np(borrows0, packed.wl_priority, packed.wl_timestamp)
    dev_order = [packed.wl_keys[int(wi)] for wi in order
                 if wi < packed.wl_count and admitted[int(wi)]]
    assert dev_order == list(host_stats.admitted), (
        f"admission order diverged:\ndevice={dev_order}\n"
        f"host={list(host_stats.admitted)}")
    mismatched = []
    for wi in range(packed.wl_count):
        if not admitted[wi]:
            continue
        key = packed.wl_keys[wi]
        host_wl = host_driver.workload(key)
        host_map = {a.name: dict(a.flavors)
                    for a in host_wl.admission.pod_set_assignments}
        cq = driver.cache.cluster_queue(
            packed.cq_names[int(packed.wl_cq[wi])])
        flavor = cq.spec.resource_groups[0].flavors[int(slots[wi])].name
        dev_map = {a.name: {res: flavor for res in a.flavors}
                   for a in host_wl.admission.pod_set_assignments}
        if host_map != dev_map:
            mismatched.append((key, host_map, dev_map))
    assert not mismatched, mismatched[:3]
    assert dev_order, "dry run admitted nothing: scenario degenerate"
    n = packed.wl_count
    n_skipped = len(host_stats.skipped)
    n_borrow = int(borrows0[:n].sum())
    n_slot1 = int((slots[:n] > 0).sum())
    assert n_skipped > 0, "no in-scan skips: contention missing"
    assert n_borrow > 0, "no borrowing heads: scenario degenerate"
    assert n_slot1 > 0, "no flavor fallback: scenario degenerate"

    # -- sharded against unsharded: parity and time ----------------------
    def unsharded(*a):
        return solve_cycle(*a, depth=packed.depth)

    ref = [o.cpu().numpy() for o in unsharded(*args)]
    got = [admitted, slots, borrows, preempt0, fit_slot0, borrows0]
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.dtype == g.dtype and np.array_equal(r, g), (
            f"sharded output {i} diverged")

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def steady(f):
        f(*args)
        sync()
        t0 = time.perf_counter()
        f(*args)
        sync()
        return time.perf_counter() - t0

    t_unsharded = steady(unsharded)
    t_sharded = steady(fn)

    # -- the production mesh route: 6 cycles with preemption -------------
    pre_shape = dict(n_cohorts=4, cqs_per_cohort=2, n_flavors=1,
                     n_workloads=32, preemption=True)

    def preemptor_wave(d, k):
        for i in range(k):
            c = i % pre_shape["n_cohorts"]
            d.create_workload(Workload(
                name=f"boss-{i}", queue_name=f"lq-{c}-0", priority=100,
                creation_time=1000.0 + i,
                pod_sets=[PodSet(name="main", count=1,
                                 requests={"cpu": 8000,
                                           "memory": 1 << 30})]))

    def parity(dev_d, cycles, wave_at, k):
        host_d = build_entry_scenario(device="cpu", **pre_shape)
        seq = []
        for cyc in range(cycles):
            if cyc == wave_at:
                preemptor_wave(dev_d, k)
                preemptor_wave(host_d, k)
            sd = dev_d.schedule_once()
            sh = host_d.schedule_once()
            assert sd.admitted == sh.admitted, (
                f"cycle {cyc} admitted diverged:\nmesh={sd.admitted}\n"
                f"host={sh.admitted}")
            assert sorted(sd.preempted_targets) == sorted(
                sh.preempted_targets), f"cycle {cyc} preemptions diverged"
            assert sorted(sd.skipped) == sorted(sh.skipped)
            seq.append((len(sd.admitted), len(sd.preempted_targets)))
        return seq

    dev_d = build_entry_scenario(use_device_solver=True, device=device,
                                 **pre_shape)
    dev_d.scheduler.solver.set_mesh(mesh)
    seq = parity(dev_d, 6, 2, 4)
    sstats = dev_d.scheduler.solver.stats
    assert sstats["sharded_dispatches"] > 0, sstats
    assert sstats["sharded_preempt_dispatches"] > 0, (
        "the preemption-aware admit scan never ran sharded", sstats, seq)
    assert any(p for _, p in seq), "no preemptions fired"

    # -- the hybrid layout: cq within a host, wl across hosts ------------
    hybrid_cycles = 0
    n_hosts = next((h for h in (4, 2) if n_devices % h == 0), None)
    hmesh = None
    if n_hosts is not None:
        hmesh = make_hybrid_mesh(n_hosts=n_hosts, devices=mesh.devices)
        hyb_d = build_entry_scenario(use_device_solver=True, device=device,
                                     **pre_shape)
        hyb_d.scheduler.solver.set_mesh(hmesh)
        hybrid_cycles = len(parity(hyb_d, 3, 1, 2))
        assert hyb_d.scheduler.solver.stats["sharded_dispatches"] > 0
    out = dict(
        mesh=mesh.shape, W=W, heads=packed.wl_count,
        exact_match=len(dev_order), skipped=n_skipped, borrowing=n_borrow,
        flavor_fallback=n_slot1, sharded_outputs_equal=6,
        t_unsharded_ms=t_unsharded * 1e3, t_sharded_ms=t_sharded * 1e3,
        production_mesh_cycles=len(seq),
        sharded_dispatches=sstats["sharded_dispatches"],
        sharded_preempt_dispatches=sstats["sharded_preempt_dispatches"],
        preemptions=sum(p for _, p in seq), hybrid_mesh=(
            hmesh.shape if hmesh is not None else None),
        hybrid_dcn_cycles=hybrid_cycles)
    print(f"dryrun_multichip ok: mesh={mesh.shape} W={W} "
          f"heads={packed.wl_count} exact_match={len(dev_order)} admitted "
          f"(set+order+flavors vs host first cycle) skipped={n_skipped} "
          f"borrowing={n_borrow} flavor_fallback={n_slot1}; "
          f"sharded_outputs_equal=6/6 t_unsharded={t_unsharded * 1e3:.1f}ms "
          f"t_sharded={t_sharded * 1e3:.1f}ms; production_mesh_cycles="
          f"{len(seq)} sharded_dispatches={sstats['sharded_dispatches']} "
          f"sharded_preempt_dispatches="
          f"{sstats['sharded_preempt_dispatches']} preemptions="
          f"{out['preemptions']} (exact host parity); hybrid_dcn_cycles="
          f"{hybrid_cycles} (cq-within-host layout, exact host parity)",
          flush=True)
    return out


def probe_synth(W=100_000, C=1_000, S=4, R=3, cohorts=64, seed=0):
    """A synthetic packed cycle at north-star scale (no host objects: it
    probes the device plane, not the packer) → (the 14 numpy planes of
    ``solve_cycle``, depth).  ``scripts/northstar_probe.py`` ``synth``."""
    rng = np.random.default_rng(seed)
    N = C + cohorts
    parent = np.full(N, -1, dtype=np.int32)
    parent[:C] = C + rng.integers(0, cohorts, C)      # CQ → cohort
    F = S * R
    nominal = rng.integers(8, 64, (C, F)).astype(np.int32) * 1000
    subtree = np.zeros((N, F), dtype=np.int32)
    subtree[:C] = nominal
    for c in range(C):                                # cohort subtree sums
        subtree[parent[c]] += nominal[c]
    guaranteed = subtree.copy()
    usage0 = (nominal * rng.random((C, F)) * 0.8).astype(np.int32)
    usage0 = np.concatenate([usage0, np.zeros((cohorts, F), np.int32)])
    for c in range(C):
        usage0[parent[c]] += usage0[c]
    borrow_cap = np.full((N, F), 2**31 // 64, dtype=np.int32)
    has_blim = np.zeros((N, F), dtype=bool)
    slot_fr = np.zeros((C, S, R), dtype=np.int32)
    for s in range(S):
        for r in range(R):
            slot_fr[:, s, r] = s * R + r
    slot_valid = np.ones((C, S), dtype=bool)
    can_preempt = np.zeros(C, dtype=bool)
    wl_cq = rng.integers(0, C, W).astype(np.int32)
    wl_requests = rng.integers(1, 16, (W, R)).astype(np.int32) * 500
    wl_priority = rng.integers(0, 100, W).astype(np.int32)
    wl_timestamp = rng.random(W).astype(np.float64)
    depth = 2      # chain node count: CQ -> cohort
    return (usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
            nominal, slot_fr, slot_valid, can_preempt,
            wl_cq, wl_requests, wl_priority, wl_timestamp), depth
