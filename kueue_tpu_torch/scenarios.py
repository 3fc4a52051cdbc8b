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
- ``build_jobs``/``run_jobs``: the job front door at tas-4k's size
  (jobs-tas-4k) — a Configuration from YAML, the cluster from one
  manifest, 6,400 jobs of nine kinds (``JOB_KINDS``) through the
  ``JobManager`` and ``schedule_once`` over 64 steps, a high-priority
  wave that preempts; ``jobs_spec`` builds it on the Driver of the
  package whose modules it is given and ``jobs_digest`` hashes what a
  run decided.
- ``sustained_spec``/``sustained_drain``: the JAX tests' sustained burst
  drain (2 CQs, 72 workloads) with a high-priority arrival at cycle 36,
  serial or forest-sharded (``BurstSolver.set_shards``), optionally
  losing devices half-way; with ``n_cqs`` the same drain at north-star
  width (``northstar_resident_spec``: 1,000 CQs in cohorts of 5, a
  backlog in every fifth, 40 reclaiming arrivals at cycle 36), whose
  window boundaries are delta packs that the shard-resident copy serves.
- ``traffic_spec``/``build_traffic``/``traffic_stream``/``open_loop``/
  ``traffic_probe``: scripts/traffic_soak.py's open loop (its cluster,
  arrival marks, ``rate_seed`` and ``probe``) over ``traffic/``.
- ``soak_cluster``/``soak_workload``: the soak scripts' cluster (CQs in
  cohorts of 4, 4,000m cpu each, BEST_EFFORT_FIFO; optionally the first
  cohorts preempting) and their single-pod workload, shared by the
  traffic open loop and the chaos, OBS and scale soak twins
  (``chaos_soak``, ``obs_soak``, ``scale_soak``).
- ``provisioning_spec``/``build_provisioning``/``run_provisioning``: the
  perf scenario with a provisioning admission check on every CQ, a
  ``ProvisioningController`` over a seeded capacity backend
  (``capacity_outcome``), drained until every workload is finished or
  rejected; either package's Driver.
- ``serving_modules`` and the arms of scripts/serve_soak.py
  (``serve_loop``, ``serve_open_loop``, ``serve_killable``,
  ``serve_wall``; ``thread_target`` runs a service thread on its
  builder's device and stream), federation_soak.py (``fed_arm``) and
  dist_soak.py (``dist_saturation``, ``dist_kill_front_end_shard``,
  ``dist_kill_submitter``, ``dist_kill_service_mid_cycle``,
  ``start_fed_workers`` + ``dist_kill_federation_worker``,
  ``dist_socket_faults``, over ``DistRun`` and ``Lockstep``): the
  admission service, the MultiKueue federation and supervised child
  processes on the port's Driver; the first two take either package's
  modules.
- ``bench_objects``, ``cli_bench_docs``/``cli_serve_docs``/
  ``write_manifests``/``store_digest`` and ``cli_serve_sequence``/
  ``cli_serve_in_process``: the perf scenario as a kueuectl manifest
  store (``cli.py``), and its daemon handing the lease over as child
  processes, or serving in this process while another thread applies.

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
import sys
import time
from collections import Counter

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
    flavor, queues, waves, total = bench_objects(scale)
    d.apply_resource_flavor(flavor)
    for cq, lq in queues:
        d.apply_cluster_queue(cq)
        d.apply_local_queue(lq)
    freeze_heap()
    return d, clock, total, waves


def bench_objects(scale: float = 1.0):
    """The perf scenario's objects at ``scale`` → (flavor, [(cq, lq)],
    waves, total): what ``build_bench`` applies and creates."""
    total = 0
    queues = []
    waves: dict[str, list[Workload]] = {c[0]: [] for c in CLASSES}
    for c in range(N_COHORTS):
        for q in range(CQS_PER_COHORT):
            name = f"cq-{c}-{q}"
            queues.append((
                _preempting_cq(name, f"cohort-{c}", {
                    "cpu": ResourceQuota(nominal=20 * UNIT,
                                         borrowing_limit=100 * UNIT)}),
                LocalQueue(name=f"lq-{c}-{q}", cluster_queue=name)))
            for cls, count, units, prio in CLASSES:
                for k in range(max(1, int(count * scale))):
                    total += 1
                    waves[cls].append(Workload(
                        name=f"{cls}-{c}-{q}-{k}", queue_name=f"lq-{c}-{q}",
                        priority=prio, creation_time=float(total),
                        pod_sets=[PodSet(name="main", count=1,
                                         requests={"cpu": units * UNIT})]))
    return ResourceFlavor(name="default"), queues, waves, total


def _admission_record(d: Driver, key: str) -> list:
    wl = d.workloads.get(key)
    adm = wl.admission if wl is not None else None
    if adm is None:
        return [key]
    return [key, adm.cluster_queue, sorted(
        (a.name, a.count, sorted(a.flavors.items()))
        for a in adm.pod_set_assignments)]


def finish_due(d: Driver, running: list, cycle: int) -> tuple[list, int]:
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
        running, n = finish_due(d, running, cycle)
        finished += n
        if cycle > total * 4 + 1000:
            break
    return dict(wall=time.perf_counter() - t0, cycles=cycle,
                cycle_times=cycle_times, finished=finished, total=total,
                preempted=preempted, decisions=decisions)


def build_northstar(n_cqs: int = 1000, n_wl: int = 100_000,
                    device: str = "cuda", cqs_per_cohort: int = 5,
                    shards: int = 0, solver_backend: str = "auto"):
    """1,000 CQs in cohorts of 5 with ``n_wl`` pending workloads →
    (driver, clock, total, preemptor_wave); ``shards`` and
    ``solver_backend`` as ``build_bench``'s."""
    clock = VirtualClock()
    with shards_env(shards):
        d = Driver(clock=clock, device=device,
                   solver_backend=solver_backend)
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


def calibration_table(solver) -> list:
    """The router's table by bucket: each (kind, W, key_len) with its
    routes' ms, the measured fastest (``ops.solver.fastest_route``; the
    device for the preempt rows) and the route ``ops.solver.choose_route``
    takes there."""
    from .ops.solver import choose_route, fastest_route
    rows = {}
    for (route, kind, W, key_len), t in solver.calibration.items():
        rows.setdefault((kind, W, key_len), {})[route] = t * 1e3
    dev = solver.device.type
    out = []
    for (kind, W, key_len), ms in sorted(rows.items()):
        mfw = key_len if kind == "forest" else None
        out.append(dict(
            kind=kind, W=W, key_len=key_len, ms=ms,
            fastest=fastest_route(solver.calibration, dev, kind, W, mfw),
            route=choose_route(solver.calibration, dev, solver.backend,
                               kind, W, mfw)))
    return out


CALIBRATION_STATS = ("calibration_loaded", "calibration_rejected",
                     "native_calibration_failures")


def warmup_record(d: Driver, max_heads: int) -> dict:
    """``CycleSolver.warmup`` on the Driver's snapshot, timed apart from
    the kernel library's load (its build, when stale, in
    ``build_s``): the seconds, the round trip, the table
    (``calibration_table``) and the calibration counters."""
    from . import kernels
    s = d.scheduler.solver
    load_s = None
    if s.device.type == "cuda":
        t0 = time.perf_counter()
        kernels.load()
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.warmup(d.cache.snapshot(), max_heads)
    return dict(warmup_s=time.perf_counter() - t0, load_s=load_s,
                build_s=kernels.BUILD["seconds"],
                rtt_ms=None if s.rtt_s is None else s.rtt_s * 1e3,
                table=calibration_table(s),
                **{k: s.stats[k] for k in CALIBRATION_STATS})


def route_counts(solver) -> dict:
    """The dispatches of a drain by route (``DispatchHandle.route``)."""
    return dict(cuda=solver.stats["cuda_dispatches"],
                cpu=solver.stats["cpu_dispatches"],
                native=solver.stats["native_dispatches"],
                no_fit=solver.stats["skipped_dispatches"],
                singleton=solver.stats["singleton_dispatches"])


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
        running, _ = finish_due(d, running, cycle)
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
        running, _ = finish_due(d, running, cycle)
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


def cycle_record(d: Driver, stats) -> list:
    """One applied cycle's decisions, read right after it: each
    admission's record (key, CQ, flavors of each pod set), the
    preempted targets and the skipped heads, each in key order."""
    return [[_admission_record(d, k) for k in sorted(stats.admitted)],
            sorted(stats.preempted_targets), sorted(stats.skipped)]


def records_digest(records: list) -> str:
    """sha256 of a run's per-cycle ``cycle_record``s: equal for two
    drains (per cycle or burst, card or CPU) that decided alike."""
    return hashlib.sha256(json.dumps(records).encode()).hexdigest()


def percentile(times: list, q: float) -> float:
    s = sorted(times)
    return s[min(len(s) - 1, int(len(s) * q))] if s else 0.0


# ----------------------------------------------------------------------
# The fused burst path (Driver.schedule_burst)
# ----------------------------------------------------------------------

def carry_finishes(d: Driver, all_stats: list, runtime: int) -> dict:
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
        ext = carry_finishes(d, all_stats, runtime_cycles)
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
        ext = carry_finishes(d, all_stats, runtime)
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
        running, _ = finish_due(d, running, cycle)
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
# The job front door (jobs-tas-4k)
# ----------------------------------------------------------------------

# the integrations the job front door drives, round robin
JOB_KINDS = ("BatchJob", "JobSet", "PyTorchJob", "MPIJob", "RayJob",
             "AppWrapper", "PodGroup", "StatefulSet", "LeaderWorkerSet")
JOBS_CPU_FLAVOR = "cpu-pool"
JOBS_ACCEL = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
JOBS_CPU_TOLERATION = {"key": "pool", "operator": "Equal", "value": "cpu",
                       "effect": "NoSchedule"}
JOBS_PRIORITY = {"low": 0, "high": 1000}
JOBS_CPU_PER_CQ = 16             # CPUs of the CPU flavor per ClusterQueue
# Kueue's Configuration: the TAS gate on, WaitForPodsReady enabled
# without blocking admission (a not-ready gang is evicted after 10 s and
# requeued with backoff, at most 3 times), fair sharing off
JOBS_CONFIG = """\
apiVersion: config.kueue.x-k8s.io/v1beta1
kind: Configuration
namespace: kueue-system
manageJobsWithoutQueueName: false
waitForPodsReady:
  enable: true
  blockAdmission: false
  timeout: 10s
  requeuingStrategy:
    timestamp: Eviction
    backoffLimitCount: 3
    backoffBaseSeconds: 5
    backoffMaxSeconds: 60
integrations:
  frameworks:
  - batch/job
  - pod
  - pod-group
  - jobset.x-k8s.io/jobset
  - kubeflow.org/pytorchjob
  - kubeflow.org/mpijob
  - ray.io/rayjob
  - workload.codeflare.dev/appwrapper
  - statefulset
  - leaderworkerset.x-k8s.io/leaderworkerset
fairSharing:
  enable: false
featureGates:
  TopologyAwareScheduling: true
"""
def _front_door():
    """This package's modules that the job front door uses, by their
    last name (``m.manifests``, ``m.kubeflow``, ``m.driver``, ...): the
    ``m`` that ``jobs_spec`` / ``jobs_configuration`` take."""
    import types as _types
    from . import config, features, jobframework, jobs
    from .api import manifests, types
    from .cache import tas_cache
    from .controller import driver
    from .jobs import appwrapper, kubeflow, pod, ray, serving
    from .webhooks import validation
    return _types.SimpleNamespace(
        types=types, manifests=manifests, config=config, features=features,
        validation=validation, jobframework=jobframework, jobs=jobs,
        appwrapper=appwrapper, kubeflow=kubeflow, pod=pod, ray=ray,
        serving=serving, tas_cache=tas_cache, driver=driver)


@contextlib.contextmanager
def restore_gates():
    """Every feature gate of this package back to what it was when the
    block ends: ``Driver.from_config`` sets the configuration's gates
    process-wide."""
    from . import features
    saved = dict(features._overrides)
    try:
        yield
    finally:
        features._overrides.clear()
        features._overrides.update(saved)


def jobs_configuration(m, text: str = JOBS_CONFIG):
    """``text`` through package ``m``'s ``config.load`` (which reads a
    file: a temporary one) and ``config.validate``."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".yaml")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        cfg = m.config.load(path)
    finally:
        os.unlink(path)
    errors = m.config.validate(cfg)
    if errors:
        raise m.config.ConfigValidationError(errors)
    return cfg


def jobs_manifests(*, n_nodes: int, n_cqs: int = 32,
                   n_cohorts: int = 4) -> str:
    """The cluster of the job front door as one multi-document manifest:
    two WorkloadPriorityClasses, the GPU Topology (block → subblock →
    host), a GPU flavor on it and a CPU flavor with a toleration, the
    cohorts, ``n_cqs`` ClusterQueues over both flavors (the GPU quotas
    add up to ``n_nodes`` TAS nodes; borrowing within the cohort
    unlimited; reclaim within the cohort and lower-priority preemption
    within the queue) and a LocalQueue each."""
    import yaml
    per_cohort = max(1, n_cqs // n_cohorts)
    api = "kueue.x-k8s.io/v1beta1"
    docs = [{"apiVersion": api, "kind": "WorkloadPriorityClass",
             "metadata": {"name": name}, "value": value,
             "description": f"{name} priority jobs"}
            for name, value in JOBS_PRIORITY.items()]
    docs.append({"apiVersion": "kueue.x-k8s.io/v1alpha1", "kind": "Topology",
                 "metadata": {"name": "gpu-topology"},
                 "spec": {"levels": [{"nodeLabel": lv}
                                     for lv in TAS_LEVELS]}})
    docs.append({"apiVersion": api, "kind": "ResourceFlavor",
                 "metadata": {"name": TAS_FLAVOR},
                 "spec": {"nodeLabels": dict(JOBS_ACCEL),
                          "topologyName": "gpu-topology"}})
    docs.append({"apiVersion": api, "kind": "ResourceFlavor",
                 "metadata": {"name": JOBS_CPU_FLAVOR},
                 "spec": {"nodeLabels": {"node-pool": "cpu"},
                          "tolerations": [dict(JOBS_CPU_TOLERATION)]}})
    docs += [{"apiVersion": "kueue.x-k8s.io/v1alpha1", "kind": "Cohort",
              "metadata": {"name": f"cohort-{c}"}, "spec": {}}
             for c in range(n_cohorts)]
    for i in range(n_cqs):
        docs.append({
            "apiVersion": api, "kind": "ClusterQueue",
            "metadata": {"name": f"cq-{i}"},
            "spec": {
                "cohort": f"cohort-{i // per_cohort}",
                "namespaceSelector": {},
                "queueingStrategy": "BestEffortFIFO",
                "preemption": {"reclaimWithinCohort": "Any",
                               "withinClusterQueue": "LowerPriority"},
                "resourceGroups": [{
                    "coveredResources": ["cpu", TAS_GPU],
                    "flavors": [
                        {"name": TAS_FLAVOR, "resources": [
                            {"name": "cpu", "nominalQuota":
                             f"{n_nodes * TAS_NODE['cpu'] // n_cqs}m"},
                            {"name": TAS_GPU, "nominalQuota":
                             n_nodes * TAS_NODE[TAS_GPU] // n_cqs}]},
                        {"name": JOBS_CPU_FLAVOR, "resources": [
                            {"name": "cpu",
                             "nominalQuota": JOBS_CPU_PER_CQ},
                            {"name": TAS_GPU, "nominalQuota": 0}]}]}]}})
        docs.append({"apiVersion": api, "kind": "LocalQueue",
                     "metadata": {"name": f"lq-{i}",
                                  "namespace": "default"},
                     "spec": {"clusterQueue": f"cq-{i}"}})
    return yaml.safe_dump_all(docs, sort_keys=False)


_APPLY = {"WorkloadPriorityClass": "apply_workload_priority_class",
          "Topology": "apply_topology",
          "ResourceFlavor": "apply_resource_flavor",
          "Cohort": "apply_cohort", "ClusterQueue": "apply_cluster_queue",
          "LocalQueue": "apply_local_queue"}


def _gang_counts(hosts: int, block: int) -> tuple:
    """Pods of 8 GPUs (one a host) a gang asks for under a subblock
    (index 0) or a block (index 1) request."""
    sub = sorted({c for c in (1, 2, 4, hosts // 4, hosts // 2, hosts)
                  if c >= 1})
    blk = sorted({c for c in (hosts, 2 * hosts, block // 4, block // 2)
                  if c >= 1})
    return sub, blk


def _jobs_job(m, kind: str, name: str, queue: str, prio: str, rng,
              hosts: int, block: int, opening: bool, invalid: bool):
    """One job of ``kind`` (``JOB_KINDS``) for LocalQueue ``queue``.  The
    kubeflow gangs and the JobSet take 8-GPU pods on the TAS flavor with
    a topology request; the rest take CPU pods on the CPU flavor.  An
    ``opening`` gang asks for 1.5 blocks (preferred: it splits across
    blocks; required: it cannot fit); an ``invalid`` one carries a
    topology request the job webhook refuses."""
    t = m.types
    gpu_pod = {TAS_GPU: 8, "cpu": 96_000}

    def cpu() -> int:
        return int(rng.choice((500, 1000, 2000, 4000)))

    if kind in ("PyTorchJob", "MPIJob"):
        sub, blk = _gang_counts(hosts, block)
        level = int(rng.integers(2))
        mode = ("required", "preferred")[int(rng.integers(2))]
        workers = int(rng.choice((sub, blk)[level]))
        if opening:
            level, workers = 0, block * 3 // 2
            mode = "preferred" if kind == "PyTorchJob" else "required"
        req = t.PodSetTopologyRequest(**{mode: TAS_LEVELS[level]})
        head_req = req
        if invalid:
            req = (t.PodSetTopologyRequest(required="not a label!!")
                   if kind == "PyTorchJob" else
                   t.PodSetTopologyRequest(required=TAS_LEVELS[1],
                                           preferred=TAS_LEVELS[0]))
        head, cls = (("Master", m.kubeflow.PyTorchJob) if kind == "PyTorchJob"
                     else ("Launcher", m.kubeflow.MPIJob))
        return cls(name, replicas=[
            m.kubeflow.ReplicaSpec(role="Worker", replicas=workers,
                                   requests=dict(gpu_pod),
                                   topology_request=req),
            m.kubeflow.ReplicaSpec(role=head, replicas=1,
                                   requests=dict(gpu_pod),
                                   topology_request=head_req)],
            queue=queue, priority_class=prio)
    if kind == "JobSet":
        return m.jobs.JobSet(name, replicated_jobs=[
            m.jobs.ReplicatedJobSpec(
                name="leader", requests={TAS_GPU: 1, "cpu": 12_000},
                topology_request=t.PodSetTopologyRequest(unconstrained=True)),
            m.jobs.ReplicatedJobSpec(
                name="workers", replicas=int(rng.integers(1, 5)),
                parallelism=int(rng.choice((1, 2, 4))),
                requests=dict(gpu_pod),
                topology_request=t.PodSetTopologyRequest(
                    preferred=TAS_LEVELS[1]))],
            queue=queue, priority_class=prio)
    if kind == "BatchJob":
        return m.jobs.BatchJob(name, parallelism=int(rng.integers(1, 9)),
                               requests={"cpu": cpu()}, queue=queue,
                               priority_class=prio)
    if kind == "RayJob":
        return m.ray.RayJob(
            name, head_requests={"cpu": 2000},
            worker_groups=[m.ray.WorkerGroupSpec(
                name="workers", replicas=int(rng.integers(1, 4)),
                requests={"cpu": cpu()})],
            submitter_requests={"cpu": 500}, queue=queue,
            priority_class=prio)
    if kind == "AppWrapper":
        return m.appwrapper.AppWrapper(name, components=[
            m.appwrapper.Component(name=f"c{j}",
                                   count=int(rng.integers(1, 4)),
                                   requests={"cpu": cpu()})
            for j in range(int(rng.integers(1, 4)))],
            queue=queue, priority_class=prio)
    if kind == "PodGroup":
        n = int(rng.integers(2, 7))
        group = m.pod.PodGroup(name, total_count=n, queue=queue)
        for j in range(n):
            group.add_pod(m.pod.Pod(name=f"{name}-{j}",
                                    requests={"cpu": cpu()}))
        return group
    if kind == "StatefulSet":
        return m.serving.StatefulSet(name, replicas=int(rng.integers(1, 5)),
                                     requests={"cpu": 1000}, queue=queue,
                                     priority_class=prio)
    return m.serving.LeaderWorkerSet(name, groups=[
        m.serving.LWSGroup(index=g, workers=int(rng.integers(1, 4)),
                           leader_requests={"cpu": 1000},
                           worker_requests={"cpu": cpu()})
        for g in range(int(rng.integers(1, 3)))],
        queue=queue, priority_class=prio)


def jobs_spec(m, d, *, blocks: int = 8, subblocks: int = 16,
              hosts: int = 32, n_cqs: int = 32, n_cohorts: int = 4,
              n_jobs: int = 6000, steps: int = 64, seed: int = 0) -> dict:
    """Populate driver ``d`` of the package whose modules ``m`` holds
    (by ``_front_door``'s names) with the cluster of ``jobs_manifests``
    through ``api.manifests`` and the Driver's ``apply_*``, and tas-4k's
    ``blocks x subblocks x hosts`` GPU nodes (as ``tas_spec`` adds them,
    labelled for the GPU flavor); plan ``n_jobs`` jobs, round robin over
    ``JOB_KINDS`` and the ClusterQueues, arriving in waves every 2 steps
    over the first three quarters of ``steps``, then a wave of
    ``n_jobs / 15`` high-priority jobs at half time that must preempt.
    Each cohort opens with a 1.5-block PyTorchJob (preferred) and MPIJob
    (required); every 150th kubeflow gang of a kind carries a topology
    request the webhook refuses.  Returns the plan: arrivals by step,
    each job's runtime (3-12 steps once its pods are ready) and, for the
    kubeflow gangs, the steps from start until its pods are ready (0, or
    30 for one in 40: the 10 s PodsReady timeout evicts it first)."""
    rng = np.random.default_rng(seed)
    n_nodes = blocks * subblocks * hosts
    for obj in m.manifests.load_manifests(jobs_manifests(
            n_nodes=n_nodes, n_cqs=n_cqs, n_cohorts=n_cohorts)):
        getattr(d, _APPLY[type(obj).__name__])(obj)
    for b in range(blocks):
        for sb in range(subblocks):
            for h in range(hosts):
                d.cache.tas.add_or_update_node(m.tas_cache.NodeInfo(
                    name=f"gpu-{b}-{sb}-{h}",
                    labels={**dict(zip(TAS_LEVELS, (
                        f"block-{b}", f"subblock-{b}-{sb}",
                        f"gpu-{b}-{sb}-{h}"))), **JOBS_ACCEL},
                    capacity=dict(TAS_NODE)))
    per_cohort = max(1, n_cqs // n_cohorts)
    waves = max(1, (steps * 3 // 4) // 2)
    high_at = steps // 2
    arrivals: dict[int, list] = {}
    runtime: dict[str, int] = {}
    ready_after: dict[str, int] = {}
    n_high = n_jobs // 15
    for i in range(n_jobs + n_high):
        high = i >= n_jobs
        kind = JOB_KINDS[i % len(JOB_KINDS)]
        cq = i % n_cqs
        step = high_at if high else 2 * (i * waves // n_jobs)
        opening = (not high and i < len(JOB_KINDS) * n_cqs
                   and cq % per_cohort == 0)
        nth = i // len(JOB_KINDS)
        invalid = (kind in ("PyTorchJob", "MPIJob") and not opening
                   and nth % 150 == 149)
        job = _jobs_job(m, kind, f"{kind.lower()}-{i}", f"lq-{cq}",
                        "high" if high else "low", rng, hosts,
                        subblocks * hosts, opening, invalid)
        arrivals.setdefault(step, []).append(job)
        runtime[job.key] = int(rng.integers(3, 13))
        if kind in ("PyTorchJob", "MPIJob"):
            ready_after[job.key] = 30 if rng.random() < 0.025 else 0
    return dict(modules=m, arrivals=arrivals, runtime=runtime,
                ready_after=ready_after, steps=steps)


def build_jobs(device: str = "cuda", **kw):
    """The job front door on this package's Driver → (driver, clock,
    JobManager, plan): the Configuration from ``JOBS_CONFIG`` (``load``
    + ``validate``), ``Driver.from_config`` on ``device``, then
    ``jobs_spec(**kw)``.  ``from_config`` sets the configuration's
    feature gates process-wide: run the build and the drain inside
    ``restore_gates()``."""
    m = _front_door()
    clock = VirtualClock()
    d = m.driver.Driver.from_config(jobs_configuration(m), clock,
                                    device=device)
    plan = jobs_spec(m, d, **kw)
    manager = m.jobframework.JobManager(d)
    freeze_heap()
    return d, clock, manager, plan


def _template_state(job) -> list:
    """A job's pods as it would run them: per pod template (per pod of a
    pod group) its count or phase, node selector and tolerations."""
    if hasattr(job, "pods"):
        return [[p.name, p.phase, p.gated, sorted(p.node_selector.items())]
                for p in job.pods]
    return [[tp.name, tp.count, sorted(tp.node_selector.items()),
             [[x.key, x.operator, x.value, x.effect]
              for x in tp.tolerations]] for tp in job.templates]


def _restored(job) -> bool:
    """A stopped job holds its original templates again (a pod group:
    every member gated)."""
    if hasattr(job, "pods"):
        return all(p.gated for p in job.pods)
    return job.templates == job._original


def _complete(job) -> None:
    """The job's pods succeed (a serving kind is deleted)."""
    kind = job.gvk
    if kind == "BatchJob":
        job.complete_pods(job.completions)
    elif kind == "JobSet":
        for rj in job.replicated_jobs:
            job.complete_replicated_job(rj.name)
    elif kind in ("PyTorchJob", "MPIJob"):
        job.mark_succeeded()
    elif kind == "RayJob":
        job.mark_status("SUCCEEDED")
    elif kind == "AppWrapper":
        job.mark_phase("Succeeded")
    elif kind == "PodGroup":
        for p in job.pods:
            p.phase = "Succeeded"
    else:
        job.deleted = True


@measured
def run_jobs(d, clock: VirtualClock, manager, plan: dict,
             steps: int | None = None) -> dict:
    """``steps`` steps (the plan's by default) of the job front door on
    either package's Driver: per step, ``JobManager.upsert`` of the
    step's arrivals (a refused job's errors are recorded), ``sync``,
    ``Driver.schedule_once``, ``sync``, then the started kubeflow gangs'
    pods turn ready when due (``mark_running``) and jobs whose runtime
    since then is due complete.  ``Stopped`` events are checked for restored
    templates as they happen; ``preempted_unstopped`` lists the jobs
    whose workload was preempted and that never stopped."""
    m = plan["modules"]
    steps = plan["steps"] if steps is None else steps
    runtime, ready_after = plan["runtime"], plan["ready_after"]
    cycle_times, decisions, refused, stopped = [], [], [], []
    started: dict[str, int] = {}
    started_kinds: dict[str, int] = {}
    seen = len(d.events)
    completed = 0

    def observe(step: int) -> None:
        nonlocal seen
        for kind, key, note in d.events[seen:]:
            if kind == "Started":
                started[key] = step
                started_kinds[key.split("/")[0]] = started_kinds.get(
                    key.split("/")[0], 0) + 1
            elif kind == "Stopped":
                started.pop(key, None)
                stopped.append([key, note, _restored(manager.jobs[key])])
        seen = len(d.events)

    t0 = time.perf_counter()
    for step in range(steps):
        clock.t += 1.0
        for job in plan["arrivals"].get(step, ()):
            try:
                manager.upsert(job)
            except m.validation.ValidationError as e:
                refused.append([job.key, list(e.errors)])
        manager.sync()
        observe(step)
        c0 = time.perf_counter()
        stats = d.schedule_once()
        cycle_times.append(time.perf_counter() - c0)
        decisions.append([_tas_admission_record(d, k)
                          for k in sorted(stats.admitted)])
        manager.sync()
        observe(step)
        for key, at in list(started.items()):
            job = manager.jobs[key]
            if key in ready_after and step - at >= ready_after[key]:
                if not job.job_running:
                    job.mark_running()
            if step - at >= ready_after.get(key, 0) + runtime[key]:
                _complete(job)
                del started[key]
                completed += 1
    job_of = {manager.reconciler.workload_key_for(j): k
              for k, j in manager.jobs.items()}
    stopped_jobs = {key for key, _, _ in stopped}
    return dict(wall=time.perf_counter() - t0, steps=steps,
                cycle_times=cycle_times, decisions=decisions,
                refused=refused, stopped=stopped,
                preempted_unstopped=sorted(
                    {job_of[key] for kind, key, _ in d.events
                     if kind == "Preempted"} - stopped_jobs),
                started_kinds=started_kinds, completed=completed,
                jobs=len(manager.jobs) + len(refused),
                admitted=sum(len(x) for x in decisions),
                preempted=sum(e[0] == "Preempted" for e in d.events),
                # evicted for the PodsReady timeout (the only eviction
                # that sets a requeue state), and of those deactivated
                timed_out=sum(w.requeue_state is not None
                              for w in d.workloads.values()),
                deactivated=sum(not w.is_active
                                for w in d.workloads.values()),
                states=[[k, j.is_suspended(), j.finished()[2],
                         _template_state(j)]
                        for k, j in sorted(manager.jobs.items())])


def jobs_digest(d, r: dict) -> str:
    """sha256 of a ``run_jobs`` run: the driver's events (QuotaReserved,
    Preempted, Started, Stopped, Finished, ...), each step's admissions
    with their topology domains, the refused jobs with their errors, the
    stops, and every job's final state."""
    h = hashlib.sha256()
    for part in (d.events, r["decisions"], r["refused"], r["stopped"],
                 r["states"]):
        h.update(json.dumps(part).encode())
    return h.hexdigest()


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


# ----------------------------------------------------------------------
# Open-loop traffic (scripts/traffic_soak.py) and two-phase admission
# with a provisioning check
# ----------------------------------------------------------------------

TRAFFIC_RUNTIMES_S = (2.0, 4.0)   # mean 3 s; 2 concurrent 1500m slots a CQ


def traffic_spec(t, d, n_cqs: int) -> None:
    """scripts/traffic_soak.py ``build``'s cluster (``soak_cluster``) on
    driver ``d`` (of either package, ``t`` its api.types module)."""
    soak_cluster(t, d, n_cqs)


def soak_cluster(t, d, n_cqs: int, preempt_cohorts: int = 0) -> None:
    """The soak scripts' cluster on driver ``d`` (of either package, ``t``
    its api.types module): CQs ``cq-<i>`` in cohorts of 4, 4,000m cpu
    nominal each, BEST_EFFORT_FIFO, a LocalQueue ``lq-<i>`` each
    (traffic_soak.py and chaos_soak.py ``build``; scale_soak.py ``build``
    with the first ``preempt_cohorts`` cohorts reclaiming within the
    cohort and preempting lower priorities), applied in one
    ``Driver.bulk_apply``: one settle on exit instead of one per
    ClusterQueue, the same cluster and the same decisions."""
    pol_pre = t.PreemptionPolicy(
        reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
        within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY)
    with d.bulk_apply():
        d.apply_resource_flavor(t.ResourceFlavor(name="default"))
        for q in range(n_cqs):
            name = f"cq-{q}"
            d.apply_cluster_queue(t.ClusterQueue(
                name=name, cohort=f"co-{q // 4}",
                queueing_strategy=t.QueueingStrategy.BEST_EFFORT_FIFO,
                preemption=(pol_pre if q // 4 < preempt_cohorts
                            else t.PreemptionPolicy()),
                resource_groups=[t.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[t.FlavorQuotas(name="default", resources={
                        "cpu": t.ResourceQuota(nominal=4000)})])]))
            d.apply_local_queue(t.LocalQueue(name=f"lq-{q}",
                                             cluster_queue=name))


def soak_workload(name: str, lq: str, cpu: int, prio: int = 0,
                  t: float = 0.0) -> Workload:
    """One single-pod workload of ``cpu`` milli-cpu created at ``t`` (the
    soak scripts' ``mk``)."""
    return Workload(name=name, queue_name=lq, priority=prio, creation_time=t,
                    pod_sets=[PodSet(name="main", count=1,
                                     requests={"cpu": cpu})])


def log(msg: str) -> None:
    """A progress line on stderr (the soak scripts' ``log``)."""
    print(msg, file=sys.stderr, flush=True)


def traffic_capacity(n_cqs: int) -> float:
    """The quota ceiling in admissions/s: slots / mean service time
    (traffic_soak.py ``capacity_estimate``)."""
    return n_cqs * 2 / (sum(TRAFFIC_RUNTIMES_S) / len(TRAFFIC_RUNTIMES_S))


def traffic_marks(n_cqs: int, remote_fraction: float = 0.0):
    """What each arrival looks like (traffic_soak.py ``spec_for``):
    1,500m, priorities 0 / 10 / 20, runtimes 2 or 4 s, 2% cancels and
    2% priority churn; ``remote_fraction`` of them sent to a worker."""
    from .traffic import TrafficSpec
    return TrafficSpec(n_cqs=n_cqs, cpu_choices=(1500,),
                       priorities=(0, 10, 20),
                       runtime_choices_s=TRAFFIC_RUNTIMES_S,
                       cancel_fraction=0.02, churn_fraction=0.02,
                       remote_fraction=remote_fraction)


def rate_seed(base: int, rate: float) -> int:
    """The stream's seed at ``rate`` (traffic_soak.py ``rate_seed``):
    one rate, one stream, in every arm and in the replay."""
    return base + int(round(rate * 8))


def build_traffic(n_cqs: int = 1000, device: str = "cuda"):
    """traffic_soak.py ``build``'s cluster on a fresh Driver →
    (driver, clock)."""
    clock = VirtualClock()
    d = Driver(clock=clock, use_device_solver=True, device=device)
    traffic_spec(api_types, d, n_cqs)
    freeze_heap()
    return d, clock


def traffic_stream(n_cqs: int, rate: float, seed: int, events=None,
                   process=None, remote_fraction: float = 0.0):
    """traffic_soak.py ``probe``'s stream: Poisson arrivals at ``rate``
    (or ``process``'s) with ``traffic_marks``, seeded by ``seed`` — or
    the recorded ``events`` through a ``ReplayStream``."""
    from .traffic import ArrivalStream, PoissonProcess, ReplayStream
    if events is not None:
        return ReplayStream(events)
    return ArrivalStream(process or PoissonProcess(rate, seed=seed),
                         traffic_marks(n_cqs, remote_fraction), seed=seed)


@measured
def open_loop(d, clock, stream, duration_s: float = 30.0,
              slo_p99_s: float = 8.0, wall_budget_s: float | None = None,
              remote_client=None):
    """``traffic.run_open_loop`` at dt = 1 s (remote-flagged submissions
    to ``remote_client``) → its OpenLoopResult."""
    from .traffic import OpenLoopConfig, run_open_loop
    return run_open_loop(d, clock, stream, OpenLoopConfig(
        duration_s=duration_s, dt_s=1.0, slo_p99_s=slo_p99_s,
        wall_budget_s=wall_budget_s), remote_client=remote_client)


def traffic_probe(n_cqs: int, rate: float, *, seed: int,
                  device: str = "cuda", events=None, **cfg):
    """One fresh-driver open-loop run at ``rate`` (traffic_soak.py
    ``probe``): ``build_traffic``, then ``open_loop`` over
    ``traffic_stream``; ``cfg`` as ``open_loop``'s → (OpenLoopResult,
    with its consumed events and the rate, and the driver)."""
    d, clock = build_traffic(n_cqs, device)
    r = open_loop(d, clock, traffic_stream(n_cqs, rate, seed, events),
                  **cfg)
    r.rate_per_s = rate
    return r, d


PROV_CHECK = "prov"
PROV_BACKOFF_S = 2          # virtual seconds; a cycle is one
PROV_LIMIT = 3              # attempts before a check is rejected


class CheckLog:
    """The driver as an admission-check controller sees it: every
    attribute is the driver's, and each check-state write is also kept
    in ``log`` as ``[key, state, message]``."""

    def __init__(self, driver):
        self._driver = driver
        self.log: list = []

    def __getattr__(self, name):
        return getattr(self._driver, name)

    def set_admission_check_state(self, key, check, state, message=""):
        self.log.append([key, state.value, message])
        self._driver.set_admission_check_state(key, check, state, message)


def capacity_outcome(seed: int, name: str, attempt: int) -> str:
    """The seeded capacity backend's answer to request ``name``: on a
    first attempt 60% ``Provisioned``, 20% ``Failed``, 15%
    ``BookingExpired`` and 5% ``Revoke`` (provisioned, its capacity
    revoked once the workload is admitted); on a retry 75%
    ``Provisioned``, else ``Failed`` again.  crc32, not ``hash``: the
    same answer in every process."""
    import zlib
    b = zlib.crc32(f"{seed}:{name}".encode()) % 100
    if attempt > 1:
        return "Provisioned" if b < 75 else "Failed"
    return ("Provisioned" if b < 60 else "Failed" if b < 80
            else "BookingExpired" if b < 95 else "Revoke")


def provisioning_spec(t, ac, d, *, scale: float = 1.0, seed: int = 0):
    """The perf scenario's 5 cohorts x 6 CQs on driver ``d`` (of either
    package: ``t`` its api.types, ``ac`` its admissionchecks), each CQ
    carrying the provisioning check ``PROV_CHECK``, and a
    ``ProvisioningController`` over a CheckLog of ``d`` whose capacity
    backend answers by ``capacity_outcome`` → (controller, total,
    waves, requests to revoke once admitted)."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    d.apply_admission_check(t.AdmissionCheck(
        name=PROV_CHECK, controller_name=ac.PROVISIONING_CONTROLLER_NAME))
    revoke: list = []

    def backend(req):
        out = capacity_outcome(seed, req.name, req.attempt)
        if out == "Revoke":
            revoke.append(req)
            out = "Provisioned"
        req.state = out
        if out != "Provisioned":
            req.failure_message = "zone stockout"

    ctrl = ac.ProvisioningController(
        CheckLog(d), check_name=PROV_CHECK,
        config=t.ProvisioningRequestConfig(
            name="prov-config", provisioning_class_name="queued-provisioning",
            retry_strategy=t.ProvisioningRequestRetryStrategy(
                backoff_limit_count=PROV_LIMIT,
                backoff_base_seconds=PROV_BACKOFF_S)),
        capacity_backend=backend)
    total = 0
    waves: dict[str, list] = {c[0]: [] for c in CLASSES}
    for c in range(N_COHORTS):
        for q in range(CQS_PER_COHORT):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(t.ClusterQueue(
                name=name, cohort=f"cohort-{c}",
                admission_checks=[PROV_CHECK],
                preemption=t.PreemptionPolicy(
                    reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
                    within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY),
                resource_groups=[t.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[t.FlavorQuotas(name="default", resources={
                        "cpu": t.ResourceQuota(
                            nominal=20 * UNIT,
                            borrowing_limit=100 * UNIT)})])]))
            d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                             cluster_queue=name))
            for cls, count, units, prio in CLASSES:
                for k in range(max(1, int(count * scale))):
                    total += 1
                    waves[cls].append(t.Workload(
                        name=f"{cls}-{c}-{q}-{k}", queue_name=f"lq-{c}-{q}",
                        priority=prio, creation_time=float(total),
                        pod_sets=[t.PodSet(name="main", count=1,
                                           requests={"cpu": units * UNIT})]))
    return ctrl, total, waves, revoke


def build_provisioning(scale: float = 1.0, device: str = "cuda",
                       seed: int = 0):
    """``provisioning_spec`` on a fresh port Driver → (driver, clock,
    controller, total, waves, revoke)."""
    from . import admissionchecks
    clock = VirtualClock()
    d = Driver(clock=clock, device=device)
    ctrl, total, waves, revoke = provisioning_spec(
        api_types, admissionchecks, d, scale=scale, seed=seed)
    freeze_heap()
    return d, clock, ctrl, total, waves, revoke


def _check_kind(state: str, message: str) -> str:
    """A check write's kind: its state and the request state behind it."""
    return f"{state}: {message.split(':', 1)[0]}"


@measured
def run_provisioning(d, clock, ctrl, total: int, waves, revoke,
                     runtime_cycles: int = RUNTIME_CYCLES,
                     max_cycles: int = 10_000) -> dict:
    """Drain the provisioning scenario (either package): per cycle the
    waves due, ``schedule_once`` (quota reserved, checks pending), the
    controller's ``reconcile`` (requests created and answered, checks
    Ready / Retry / Rejected), the capacity revoked under every admitted
    workload whose request the backend marked, and the finishes due,
    until every workload is finished or rejected.  ``decisions`` holds
    per cycle the reservations (CQ and flavors) and every check write."""
    log = ctrl.driver.log
    running: list[tuple[int, str]] = []
    cycle = 0
    cycle_times = []
    decisions = []
    reached: dict[str, int] = {}
    admitted = done = 0          # done: finished or rejected
    pending = sorted(waves.items(), key=lambda kv: WAVE_AT_CYCLE[kv[0]])
    keys = [wl.key for _, wls in pending for wl in wls]
    t0 = time.perf_counter()
    while cycle < max_cycles and done < total:
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
        del log[:]
        ctrl.reconcile()
        for req in list(revoke):
            wl = d.workloads.get(req.workload_key)
            if wl is not None and wl.is_admitted:
                req.state = "CapacityRevoked"
                req.failure_message = "nodes deleted"
                revoke.remove(req)
        for key, state, message in log:
            kind = _check_kind(state, message)
            reached[kind] = reached.get(kind, 0) + 1
            if state == "Ready":
                admitted += 1
                running.append((cycle + runtime_cycles, key))
            done += state == "Rejected"
        decisions.append([[_admission_record(d, k)
                           for k in sorted(stats.admitted)], list(log)])
        running, n = finish_due(d, running, cycle)
        done += n
    finished = sum(d.workloads[k].is_finished for k in keys)
    rejected = sum(not d.workloads[k].is_active for k in keys)
    return dict(wall=time.perf_counter() - t0, cycles=cycle,
                cycle_times=cycle_times, total=total, admitted=admitted,
                finished=finished, rejected=rejected, reached=reached,
                requests=sorted(ctrl.requests), decisions=decisions)


# ----------------------------------------------------------------------
# The serving front, the federation and supervised processes
# (scripts/serve_soak.py, federation_soak.py and dist_soak.py)
# ----------------------------------------------------------------------

def serving_modules(device: str = "cuda"):
    """The modules the serving, federation and process arms below use,
    with ``driver(clock)`` building a Driver and ``fed_spec(**kw)`` a
    federation's FedSpec on ``device``.  A test builds the same
    namespace from the JAX package's modules and runs the same arms
    there."""
    from types import SimpleNamespace

    from . import remote, serving, traffic
    from .chaos import injector
    from .federation import sim
    from .utils import journal
    return SimpleNamespace(
        types=api_types, serving=serving, traffic=traffic, chaos=injector,
        journal=journal, remote=remote, fed=sim,
        driver=lambda clock: Driver(clock=clock, device=device),
        fed_spec=lambda **kw: sim.FedSpec(device=device, **kw))


def serve_driver(m, n_cqs: int, clock):
    """serve_soak.py ``cluster_spec`` (traffic_soak.py's cluster:
    ``traffic_spec``) on ``m.driver(clock)``."""
    d = m.driver(clock)
    traffic_spec(m.types, d, n_cqs)
    return d


def serve_events(stream, duration_s: float) -> list:
    """The submissions of ``stream`` up to ``duration_s`` virtual s.  A
    stream with traffic_soak.py's marks also cancels and reprioritises
    (2% each); the service takes submissions only, so those are left
    out."""
    out = []
    for ev in stream:
        if ev.t > duration_s:
            break
        if ev.kind == "submit":
            out.append(ev)
    return out


def _submit_event(svc, ev):
    ns, name = ev.key.split("/", 1)
    return svc.submit(name=name, namespace=ns, queue_name=f"lq-{ev.cq}",
                      requests={"cpu": ev.cpu_m}, priority=ev.priority,
                      creation_time=svc.epoch + ev.t,
                      runtime_s=ev.runtime_s)


def _by_step(events, cycles: int, dt: float) -> list:
    """Events batched by the step whose cycle time they precede."""
    out, i = [], 0
    for k in range(cycles):
        j = i
        while j < len(events) and events[j].t <= (k + 1) * dt:
            j += 1
        out.append(events[i:j])
        i = j
    return out


def _submit_threads(svc, batch, threads: int) -> list:
    """``batch`` submitted by ``threads`` racing submitter threads (a lane
    each) → the SubmitResults."""
    import threading
    results, errs = [None] * len(batch), []
    gate = threading.Barrier(threads)

    def lane(k):
        try:
            gate.wait()
            for i in range(k, len(batch), threads):
                results[i] = _submit_event(svc, batch[i])
        except Exception as e:   # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=lane, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return results


@measured
def serve_loop(m, n_cqs: int, events, cycles: int, *, k_max: int = 1,
               threads: int = 1, dt: float = 1.0) -> dict:
    """serve_soak.py ``arm_parity``'s service arm: ``events`` through
    ``AdmissionService.submit`` / ``step`` in virtual time, a step a
    ``dt``; ``k_max`` 1 pins K, ``threads`` > 1 submits each step's
    batch from racing submitter threads.  → dict(driver, service,
    decisions (a list a cycle), ks (K a step), accepted)."""
    clock = VirtualClock()
    d = serve_driver(m, n_cqs, clock)
    svc = m.serving.AdmissionService(d, config=m.serving.ServiceConfig(
        dt_s=dt, k_max=k_max, journal_path="", high_water=1 << 30,
        epoch_t=clock.t))
    decisions, ks, accepted = [], [], []
    for batch in _by_step(events, cycles, dt):
        res = (_submit_threads(svc, batch, threads) if threads > 1
               else [_submit_event(svc, ev) for ev in batch])
        accepted += [ev.key for ev, r in zip(batch, res)
                     if r.status == "accepted" and not r.duplicate]
        out = svc.step()
        decisions.extend(out["decisions"])
        ks.append(out["k"])
    return dict(driver=d, service=svc, decisions=decisions, ks=ks,
                accepted=accepted)


@measured
def serve_open_loop(m, n_cqs: int, events, cycles: int,
                    dt: float = 1.0) -> dict:
    """serve_soak.py ``arm_parity``'s batch arm: the same events through
    ``traffic.run_open_loop`` on a fresh Driver → dict(driver,
    decisions)."""
    clock = VirtualClock()
    d = serve_driver(m, n_cqs, clock)
    res = m.traffic.run_open_loop(
        d, clock, m.traffic.ReplayStream(events),
        m.traffic.OpenLoopConfig(duration_s=cycles * dt, dt_s=dt))
    return dict(driver=d, decisions=res.decisions)


@measured
def serve_killable(m, n_cqs: int, events, cycles: int, td: str, tag: str,
                   kill_site=None, kill_at: int = 0,
                   dt: float = 1.0, batches=None, submit=None) -> dict:
    """serve_soak.py ``run_killable`` over ``events`` batched a step (or
    over ``batches``, a list a step, each item given to ``submit(svc,
    item)``): a service with its CycleWAL and ingest journal on disk in
    ``td``; with ``kill_site`` armed at its ``kill_at``-th hit the run
    crashes, recovers (``recover_service`` from the store, the WAL and
    the journal), resubmits the interrupted batch (idempotent tokens)
    and goes on → dict(driver, service, decisions, crashed)."""
    import os
    clock = VirtualClock()
    d = serve_driver(m, n_cqs, clock)
    wal = m.journal.CycleWAL(path=os.path.join(td, f"{tag}.wal"))
    d.attach_wal(wal)
    jpath = os.path.join(td, f"{tag}.ing")
    cfg = m.serving.ServiceConfig(dt_s=dt, k_max=1, journal_path=jpath,
                                  high_water=1 << 30, epoch_t=clock.t)
    svc = m.serving.AdmissionService(d, config=cfg, wal=wal)
    if kill_site is not None:
        m.chaos.install(m.chaos.ChaosInjector(seed=1000 + kill_at)).arm(
            kill_site, at=kill_at)
    if batches is None:
        batches = _by_step(events, cycles, dt)
    submit = submit or _submit_event
    decisions, crashed, s = [], None, 0
    try:
        while s < len(batches):
            try:
                for ev in batches[s]:
                    submit(svc, ev)
                decisions.extend(svc.step()["decisions"])
                s += 1
            except m.chaos.InjectedCrash as e:
                crashed = str(e)
                m.chaos.clear()
                d2 = serve_driver(m, n_cqs, clock)
                svc = m.serving.recover_service(
                    d2, d.workloads.values(), wal,
                    config=m.serving.ServiceConfig(
                        dt_s=dt, k_max=1, journal_path=jpath,
                        high_water=1 << 30, epoch_t=cfg.epoch_t))
                d = d2
    finally:
        m.chaos.clear()
    return dict(driver=d, service=svc, decisions=decisions,
                crashed=crashed)


def lost_and_duplicated(accepted_keys, d, decisions) -> tuple:
    """(accepted submissions missing from the store, keys admitted more
    than once over ``decisions``)."""
    flat = Counter(k for cyc in decisions for k in cyc)
    lost = sum(1 for k in accepted_keys if k not in d.workloads)
    return lost, sum(1 for n in flat.values() if n > 1)


def serve_wall_schedule(cfg: dict, seed: int) -> list:
    """serve_soak.py ``gen_wall_schedule``: a diurnal submission schedule
    (t_rel, name, lq, priority, runtime) replayed at wall pace."""
    import random

    from .traffic import DiurnalProcess
    proc = DiurnalProcess(cfg["wall_trough_rate"], cfg["wall_peak_rate"],
                          period_s=cfg["wall_duration_s"], seed=seed)
    marks = random.Random(seed + 1)
    events, t, i = [], 0.0, 0
    while True:
        t += proc.next_gap(t)
        if t >= cfg["wall_duration_s"]:
            return events
        i += 1
        events.append((t, f"s{i}", f"lq-{marks.randrange(cfg['cqs'])}",
                       marks.choice((0, 10, 20)), cfg["wall_runtime_s"]))


def _pctile(xs, q: float) -> float:
    import math
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def thread_target(fn, device):
    """``fn`` for another thread to run on the calling thread's CUDA
    device and current stream: a Driver's kernels launch on the current
    stream of the thread that runs its cycles, so a service thread
    launches where the Driver's builder queued its uploads (``fn`` as
    it is off the card)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return fn
    stream = torch.cuda.current_stream(dev)

    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            return fn(*args, **kw)
    return run


def serve_wall(cfg: dict, seed: int, td: str, device: str = "cuda") -> dict:
    """serve_soak.py ``arm_wall``: ``AdmissionService.serve`` on a
    service thread (on this thread's device and stream,
    ``thread_target``) in wall-clock time, ``cfg['wall_submitters']``
    submitter threads replaying ``serve_wall_schedule`` at its pace, the
    tail admitted, then a graceful drain; per-window p99 admission
    latency against ``cfg['slo_p99_s']``, mean arrival rate and the K
    values chosen.  The result also names the service thread
    (``service_thread``, its ident)."""
    import os
    import threading
    from .serving import AdmissionService, ServiceConfig
    from .utils.journal import CycleWAL
    d = Driver(clock=time.time, device=device)
    traffic_spec(api_types, d, cfg["cqs"])
    wal = CycleWAL(path=os.path.join(td, "wall.wal"))
    d.attach_wal(wal)
    svc = AdmissionService(d, config=ServiceConfig(
        dt_s=cfg["wall_dt_s"], high_water=cfg["high_water"],
        slo_p99_s=cfg["slo_p99_s"], drain_timeout_s=30.0,
        journal_path=os.path.join(td, "wall.ing"),
        k_max=cfg["k_max"], ewma_halflife_s=2.0), wal=wal)
    events = serve_wall_schedule(cfg, seed)
    stop = threading.Event()
    server = threading.Thread(target=thread_target(svc.serve, device),
                              args=(stop,), daemon=True)
    server.start()
    t_start = time.perf_counter()
    n_threads = cfg["wall_submitters"]

    def submitter(lane):
        for (t_rel, name, lq, prio, rt) in events[lane::n_threads]:
            lag = t_start + t_rel - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            svc.submit(name=name, queue_name=lq, requests={"cpu": 1500},
                       priority=prio, runtime_s=rt)

    subs = [threading.Thread(target=submitter, args=(i,), daemon=True)
            for i in range(n_threads)]
    for s in subs:
        s.start()
    for s in subs:
        s.join()
    time.sleep(4 * cfg["wall_dt_s"])   # let the tail admit
    stop.set()
    server.join(timeout=svc.cfg.drain_timeout_s + 10.0)
    duration = cfg["wall_duration_s"]
    w_len = duration / cfg["wall_windows"]
    windows = []
    for w in range(cfg["wall_windows"]):
        lo, hi = w * w_len, (w + 1) * w_len
        lats = [lat for (t, lat) in svc.latency_log if lo <= t < hi]
        ks = [s["k"] for s in svc.telemetry if lo <= s["t_wall"] < hi]
        rates = [s["ewma_rate"] for s in svc.telemetry
                 if lo <= s["t_wall"] < hi]
        windows.append({"t0_s": lo, "samples": len(lats),
                        "p99_s": _pctile(lats, 0.99),
                        "rate_per_s": (sum(rates) / len(rates)
                                       if rates else 0.0),
                        "k_max": max(ks) if ks else 0})
    active = [w for w in windows if w["samples"] > 0]
    stats = svc.stats()
    return {
        "duration_s": duration, "events": len(events),
        "submitted": stats["accepted"], "admitted": stats["admitted"],
        "admissions_per_s": stats["admitted"] / duration,
        "drained_clean": stats["drained_clean"],
        "stopped": not server.is_alive(),
        "held": bool(active) and all(w["p99_s"] <= cfg["slo_p99_s"]
                                     for w in active),
        "windows": windows,
        "k_values": sorted({s["k"] for s in svc.telemetry}),
        "rejected": stats["rejected"], "shed": stats["shed"],
        "service_thread": server.ident, "driver": d,
    }


@measured
def fed_arm(cfg: dict, seed: int, wal_dir: str, arm=None, m=None,
            **spec_kw):
    """federation_soak.py ``run_arm``: one FederationSim arm on
    ``cfg``'s federation (``m``: the modules, ``serving_modules`` on
    "cuda" by default) over ``make_traffic``'s stream, chaos armed by
    ``arm(injector)`` after the traffic is loaded → (sim, settled).
    Collection is off while it runs, as in the drains above."""
    m = m if m is not None else serving_modules()
    fed = m.fed
    m.chaos.clear()
    spec = m.fed_spec(n_workers=cfg["workers"], n_cqs=cfg["cqs"],
                      remote_cqs=cfg["remote_cqs"], seed=seed, **spec_kw)
    sim = fed.FederationSim(spec, wal_dir=wal_dir)
    tspec = m.traffic.TrafficSpec(
        n_cqs=cfg["cqs"], remote_fraction=0.5, cancel_fraction=0.0,
        churn_fraction=0.0, runtime_choices_s=(2.0,))
    events = m.traffic.ArrivalStream(
        m.traffic.PoissonProcess(cfg["rate"], seed=seed), tspec,
        seed=seed).take(cfg["events"])
    by_step, _ = fed.schedule_traffic(events, n_cqs=cfg["cqs"],
                                      remote_cqs=cfg["remote_cqs"])
    sim.load_traffic(by_step)
    try:
        if arm is not None:
            arm(m.chaos.install(m.chaos.ChaosInjector(seed=seed)))
        settled = sim.run(cfg["steps"], drain_max=cfg["drain_max"])
    finally:
        m.chaos.clear()
    return sim, settled


def fed_double_admissions(sim) -> int:
    return sum(1 for v in sim.violations
               if v.get("kind") == "double_admission")


# -- supervised processes (scripts/dist_soak.py) ------------------------

def _shard_argv(tmp: str, shard_id: int, n_cqs: int, device: str,
                recover=False, resume_cycle=0, port=0, crash_site="",
                crash_at=0):
    from .dist.supervisor import child_argv
    pf = f"{tmp}/shard{shard_id}.port"
    kw = dict(shard_id=shard_id, n_cqs=n_cqs, state_dir=str(tmp),
              port_file=pf, recover=recover, resume_cycle=resume_cycle,
              port=port, device=device,
              stats_file=f"{tmp}/shard{shard_id}.stats")
    if crash_site:
        kw.update(crash_site=crash_site, crash_at=crash_at)
    return child_argv("shard", **kw), pf


def _cmd(mp, line: str) -> str:
    mp.proc.stdin.write(line + "\n")
    mp.proc.stdin.flush()
    return mp.proc.stdout.readline().strip()


def _cmd_all(subs, line: str) -> list:
    for mp in subs:
        mp.proc.stdin.write(line + "\n")
        mp.proc.stdin.flush()
    return [mp.proc.stdout.readline().strip() for mp in subs]


def _dist_control(tmp: str, n_cqs: int, device: str):
    import os

    from .dist.serving import build_shard_service
    os.makedirs(f"{tmp}/ctl", exist_ok=True)
    return build_shard_service(0, n_cqs, f"{tmp}/ctl", device=device)[0]


def _ctl_submit(svc, step, n_sub, per_step, n_cqs):
    from .dist.serving import step_payloads
    for j in range(n_sub):
        for b in step_payloads(step, j, n_sub, per_step, n_cqs):
            svc.submit(name=b["name"], queue_name=b["queue_name"],
                       requests=b["requests"], priority=b["priority"],
                       namespace=b["namespace"], runtime_s=b["runtime_s"],
                       count=b["count"], token=b["token"])


def _loss_dup(dist_keys: list, ctl_keys: list) -> tuple:
    """dist_soak.py ``_loss_dup``: multiset compare of every admission
    key of an arm → (keys the control admitted and the processes lost,
    keys the processes admitted more often than the control)."""
    d, c = Counter(dist_keys), Counter(ctl_keys)
    return sum((c - d).values()), sum((d - c).values())


def _merge_reports(reports: dict) -> dict:
    """dist_soak.py ``_merge_reports``: the per-arm supervisor reports
    summed into the tail's ``dist`` block (spawns / kills / restarts by
    role, the kill log tagged by arm)."""
    by_role: dict = {}
    kill_log = []
    for arm, rep in reports.items():
        for role, st in rep["by_role"].items():
            per = by_role.setdefault(
                role, {"spawns": 0, "kills": 0, "restarts": 0})
            for k, v in st.items():
                per[k] += v
        kill_log.extend(f"{arm}:{name}" for name in rep["kill_log"])
    return {"by_role": by_role, "kill_log": kill_log, "per_arm": reports}


def child_stats(path: str):
    """What a child wrote to its ``--stats-file`` after its last step
    (None before the first)."""
    import os
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


class DistRun:
    """The children of one dist_soak.py arm under one seeded
    ``ProcessSupervisor``: every child started through ``child_argv``
    (shards and workers with ``device`` and a ``--stats-file``), its
    argv kept in ``argvs`` and its start (spawn to ready, s) in
    ``starts``."""

    def __init__(self, cfg: dict, seed: int, tmp: str, device: str):
        import os

        from .dist.supervisor import ProcessSupervisor
        os.makedirs(tmp, exist_ok=True)
        self.cfg, self.tmp, self.device = cfg, tmp, device
        self.sup = ProcessSupervisor(seed=seed)
        self.argvs: list = []
        self.starts: dict = {}

    def shards(self, n: int, **kw) -> list:
        """Spawn ``n`` shard processes (``kw``: ``crash_site`` /
        ``crash_at``) and wait until each answers ``/readyz``."""
        out = []
        t0 = time.perf_counter()
        for s in range(n):
            argv, pf = _shard_argv(self.tmp, s, self.cfg["cqs"],
                                   self.device, **kw)
            self.argvs.append(argv)
            out.append(self.sup.spawn(f"shard{s}", "shard", argv,
                                      port_file=pf))
        for mp in out:
            self.sup.wait_ready(mp, timeout=self.cfg["ready_timeout_s"])
            self.starts[mp.name] = time.perf_counter() - t0
        return out

    def submitter(self, j: int, ports: list):
        """Spawn submitter ``j`` of ``cfg['submitters']`` over the shard
        ``ports`` and wait for its ready line."""
        from .dist.supervisor import child_argv
        cfg = self.cfg
        argv = child_argv(
            "submitter", submitter_id=j, n_submitters=cfg["submitters"],
            per_step=cfg["per_step"], n_cqs=cfg["cqs"],
            shard_ports=",".join(map(str, ports)))
        self.argvs.append(argv)
        mp = self.sup.spawn(f"sub{j}", "submitter", argv, pipe_stdio=True)
        if mp.proc.stdout.readline().strip() != "ready":
            raise RuntimeError(f"sub{j}: no ready line")
        return mp

    def front_end(self):
        """``cfg['shards']`` shard processes and ``cfg['submitters']``
        submitter processes → (shards, clients, submitters)."""
        from .dist.serving import ShardClient
        shards = self.shards(self.cfg["shards"])
        ports = [mp.port for mp in shards]
        subs = [self.submitter(j, ports)
                for j in range(self.cfg["submitters"])]
        return shards, [ShardClient(p) for p in ports], subs

    def restart_shard(self, shard_id: int, **kw):
        """Rebuild shard ``shard_id`` from its journals (``kw``:
        ``resume_cycle``, ``port``) and wait until it is ready."""
        argv, _ = _shard_argv(self.tmp, shard_id, self.cfg["cqs"],
                              self.device, recover=True, **kw)
        self.argvs.append(argv)
        t0 = time.perf_counter()
        self.sup.restart(f"shard{shard_id}", argv=argv,
                         timeout=self.cfg["ready_timeout_s"])
        self.starts[f"shard{shard_id} restart"] = time.perf_counter() - t0

    def extras(self, names) -> dict:
        """What every arm returns beside the script's keys: each child's
        start, the last ``--stats-file`` report of each of ``names``,
        every argv and the supervisor's report."""
        return {"starts_s": self.starts,
                "child_stats": {n: child_stats(f"{self.tmp}/{n}.stats")
                                for n in names},
                "argvs": self.argvs, "report": self.sup.report()}


class Lockstep:
    """dist_soak.py ``_lockstep`` with its key lists: one barrier sends
    ``step S`` to every submitter, replays the step into the in-process
    control, steps every shard and keeps both sides' admission keys
    (``keep``, also for a barrier driven another way)."""

    def __init__(self, run: DistRun, subs: list, clients: list):
        self.run, self.subs, self.clients = run, subs, clients
        self.ctl = _dist_control(run.tmp, run.cfg["cqs"], run.device)
        self.dist_keys: list = []
        self.ctl_keys: list = []
        self.per_step_ok: list = []

    def __call__(self, step: int) -> None:
        cfg = self.run.cfg
        _cmd_all(self.subs, f"step {step}")
        _ctl_submit(self.ctl, step, len(self.subs), cfg["per_step"],
                    cfg["cqs"])
        got = []
        for c in self.clients:
            for dec in c.step(retry_deadline_s=15.0)["decisions"]:
                got.extend(dec)
        self.keep(got, [k for dec in self.ctl.step()["decisions"]
                        for k in dec])

    def keep(self, got: list, want: list) -> None:
        self.dist_keys.extend(got)
        self.ctl_keys.extend(want)
        self.per_step_ok.append(sorted(got) == sorted(want))

    def verdict(self) -> dict:
        lost, duplicated = _loss_dup(self.dist_keys, self.ctl_keys)
        identical = all(self.per_step_ok)
        return {"steps": len(self.per_step_ok),
                "admissions": len(self.ctl_keys),
                "decisions_identical": identical, "parity": identical,
                "lost": lost, "duplicated": duplicated}


def dist_saturation(cfg: dict, seed: int, td: str,
                    device: str = "cuda") -> dict:
    """dist_soak.py ``arm_saturation``: every submitter process blasts
    rounds of uniquely named submissions, the shards on ``device`` drain
    each round through real ``/admin/step`` cycles, and the round
    doubles until the wall-clock admissions/s stops rising by 5%."""
    run = DistRun(cfg, seed, f"{td}/sat", device)
    rounds = []
    try:
        shards, clients, subs = run.front_end()
        n = cfg["sat_base"]
        best = 0.0
        for r in range(cfg["sat_max_rounds"]):
            t0 = time.monotonic()
            replies = _cmd_all(subs, f"blast {n}")
            accepted = sum(int(rep.split()[2]) for rep in replies)
            steps = 0
            while steps < cfg["sat_drain_cap"]:
                stats = [c.svc_stats() for c in clients]
                if (sum(s["admitted"] for s in stats)
                        >= sum(s["accepted"] for s in stats)):
                    break
                for c in clients:
                    c.step(retry_deadline_s=15.0)
                steps += 1
            elapsed = time.monotonic() - t0
            stats = [c.svc_stats() for c in clients]
            drained = (sum(s["admitted"] for s in stats)
                       == sum(s["accepted"] for s in stats))
            rate = accepted / elapsed if elapsed > 0 else 0.0
            rounds.append({"n_per_submitter": n, "accepted": accepted,
                           "drain_steps": steps, "elapsed_s": elapsed,
                           "admissions_per_s": rate, "drained": drained})
            log(f"  saturation round {r}: n={n} adm/s={rate:.1f} "
                f"drain_steps={steps}")
            if not drained or (best > 0 and rate < best * 1.05):
                break
            best = max(best, rate)
            n *= 2
        depths = {str(i): c.svc_stats()["ingest_depth"]
                  for i, c in enumerate(clients)}
        extras = run.extras(mp.name for mp in shards)
    finally:
        run.sup.terminate_all()
    ceiling = max((r["admissions_per_s"] for r in rounds), default=0.0)
    return {
        "wall_clock": True, "rounds": rounds,
        "ceiling_admissions_per_s": ceiling,
        "submitter_procs": cfg["submitters"], "shard_procs": cfg["shards"],
        "shard_depths": depths,
        "ok": ceiling > 0 and all(r["drained"] for r in rounds),
        **extras,
    }


def dist_kill_front_end_shard(cfg: dict, seed: int, td: str,
                              device: str = "cuda",
                              while_running=None) -> dict:
    """dist_soak.py ``arm_kill_front_end_shard``: ``cfg['shards']`` shard
    processes and ``cfg['submitters']`` submitter processes, every one
    started through ``child_argv`` with ``device``; lockstep barriers
    against an in-process control on ``device``; shard0 SIGKILLed at the
    half (the armed ``dist.kill`` site), rebuilt from its journals on
    its port, the submitters resynced.  ``while_running(supervisor)``
    is called after the first barrier, while every child runs.  Also
    returns each shard's start (spawn to ready, s), its last
    ``--stats-file`` report and every child's argv."""
    from .chaos import injector as chaos
    run = DistRun(cfg, seed, f"{td}/kshard", device)
    seen = None
    try:
        shards, clients, subs = run.front_end()
        ports = [mp.port for mp in shards]
        lockstep = Lockstep(run, subs, clients)
        half = cfg["kill_steps"] // 2
        for s in range(half):
            lockstep(s)
            if s == 0 and while_running is not None:
                seen = while_running(run.sup)
        inj = chaos.ChaosInjector(seed=seed)
        inj.arm("dist.kill", at=1, payload="shard0")
        chaos.install(inj)
        killed = run.sup.maybe_kill("shard0")
        chaos.clear()
        run.restart_shard(0, resume_cycle=half, port=ports[0])
        same_port = shards[0].port == ports[0]
        # the whole delivered schedule again; every replay dedupes
        replies = _cmd_all(subs, f"resync {half}")
        deduped = sum(int(r.split()[2]) for r in replies)
        expected = len(subs) * half * cfg["per_step"]
        for s in range(half, cfg["kill_steps"]):
            lockstep(s)
        extras = run.extras(mp.name for mp in shards)
    finally:
        chaos.clear()
        run.sup.terminate_all()
    v = lockstep.verdict()
    return {
        "killed": bool(killed), "same_port": same_port, **v,
        "dedupe": {"replayed": deduped, "expected": expected},
        "restarts": extras["report"]["by_role"]["shard"]["restarts"],
        "while_running": seen, **extras,
        "ok": (bool(killed) and same_port and v["decisions_identical"]
               and v["lost"] == 0 and v["duplicated"] == 0
               and deduped == expected),
    }


def dist_kill_submitter(cfg: dict, seed: int, td: str,
                        device: str = "cuda") -> dict:
    """dist_soak.py ``arm_kill_submitter``: the processes of
    ``dist_kill_front_end_shard``; sub0 SIGKILLed at the half and
    respawned with the same identity, whose replay of its schedule from
    zero dedupes at the shards."""
    from .chaos import injector as chaos
    run = DistRun(cfg, seed, f"{td}/ksub", device)
    try:
        shards, clients, subs = run.front_end()
        ports = [mp.port for mp in shards]
        lockstep = Lockstep(run, subs, clients)
        half = cfg["kill_steps"] // 2
        for s in range(half):
            lockstep(s)
        inj = chaos.ChaosInjector(seed=seed)
        inj.arm("dist.kill", at=1, payload="sub0")
        chaos.install(inj)
        killed = run.sup.maybe_kill("sub0")
        chaos.clear()
        # the SAME identity (submitter 0 of N): the schedule it replays
        # must be the one it owned
        subs[0] = run.submitter(0, ports)
        deduped = int(_cmd(subs[0], f"resync {half}").split()[2])
        expected = half * cfg["per_step"]
        for s in range(half, cfg["kill_steps"]):
            lockstep(s)
        extras = run.extras(mp.name for mp in shards)
    finally:
        chaos.clear()
        run.sup.terminate_all()
    v = lockstep.verdict()
    return {
        "killed": bool(killed), **v,
        "dedupe": {"replayed": deduped, "expected": expected},
        "restarts": extras["report"]["by_role"]["submitter"]["kills"],
        **extras,
        "ok": (bool(killed) and v["decisions_identical"] and v["lost"] == 0
               and v["duplicated"] == 0 and deduped == expected),
    }


def dist_kill_service_mid_cycle(cfg: dict, seed: int, td: str,
                                device: str = "cuda") -> dict:
    """dist_soak.py ``arm_kill_service_mid_cycle``: one shard process on
    ``device`` with ``--crash-site svc.cycle --crash-at 2`` dies inside
    ``/admin/step`` (``os._exit(17)``, no cleanup); it is rebuilt from
    its journals on its port and the step re-issued.  The death is
    awaited up to ``cfg['ready_timeout_s']``: a child that hangs instead
    of exiting leaves ``crash_exit`` None and fails the arm."""
    import subprocess

    from .dist.serving import ShardClient, step_payloads
    run = DistRun(cfg, seed, f"{td}/ksvc", device)
    crashes, crash_exit = 0, None
    try:
        mp, = run.shards(1, crash_site="svc.cycle", crash_at=2)
        port = mp.port
        client = ShardClient(port)
        lockstep = Lockstep(run, [], [client])
        for s in range(cfg["kill_steps"]):
            for b in step_payloads(s, 0, 1, cfg["per_step"], cfg["cqs"]):
                client.submit(b, retry_deadline_s=5.0)
            _ctl_submit(lockstep.ctl, s, 1, cfg["per_step"], cfg["cqs"])
            try:
                st = client.step()
            except Exception:
                try:
                    mp.proc.wait(timeout=cfg["ready_timeout_s"])
                    crash_exit = mp.proc.returncode
                except subprocess.TimeoutExpired:
                    crash_exit = None
                crashes += 1
                run.restart_shard(0, resume_cycle=s, port=port)
                st = client.step(retry_deadline_s=10.0)
            lockstep.keep([k for dec in st["decisions"] for k in dec],
                          [k for dec in lockstep.ctl.step()["decisions"]
                           for k in dec])
        extras = run.extras(["shard0"])
    finally:
        run.sup.terminate_all()
    v = lockstep.verdict()
    return {
        "crashes": crashes, "crash_exit": crash_exit, **v,
        "restarts": extras["report"]["by_role"]["shard"]["restarts"],
        **extras,
        "ok": (crashes == 1 and crash_exit == 17
               and v["decisions_identical"] and v["lost"] == 0
               and v["duplicated"] == 0),
    }


def _fed_worker_argv(tmp: str, cfg: dict, device: str, name: str,
                     recover=False, resume_t=None, port=0, remote_cqs=None):
    from .dist.supervisor import child_argv
    pf = f"{tmp}/{name}.port"
    return child_argv(
        "worker", name=name,
        remote_cqs=cfg["fed_remote_cqs"] if remote_cqs is None
        else remote_cqs, state_dir=tmp, port_file=pf, recover=recover,
        resume_t=resume_t, port=port, device=device,
        stats_file=f"{tmp}/{name}.stats"), pf


def start_fed_workers(cfg: dict, seed: int, td: str,
                      device: str = "cuda") -> dict:
    """Spawn the worker processes of ``dist_kill_federation_worker``
    without waiting for them, so that they start while other work runs;
    pass the result to it as ``started``."""
    import os

    from .dist.supervisor import ProcessSupervisor
    tmp = f"{td}/kfed"
    os.makedirs(tmp, exist_ok=True)
    sup = ProcessSupervisor(seed=seed)
    workers, argvs = {}, []
    t0 = time.perf_counter()
    for i in range(cfg["workers"]):
        name = f"w{i}"
        argv, pf = _fed_worker_argv(tmp, cfg, device, name)
        argvs.append(argv)
        workers[name] = sup.spawn(name, "worker", argv, port_file=pf)
    return dict(sup=sup, workers=workers, argvs=argvs, t0=t0, tmp=tmp,
                starts={})


def wait_fed_workers(started: dict, timeout: float) -> dict:
    """Wait until every worker of ``start_fed_workers`` answers
    ``/readyz``; the first wait records each one's start (spawn to
    ready, s) in ``started['starts']``."""
    for name, mp in started["workers"].items():
        started["sup"].wait_ready(mp, timeout=timeout)
        started["starts"].setdefault(name,
                                     time.perf_counter() - started["t0"])
    return started["starts"]


def dist_kill_federation_worker(cfg: dict, seed: int, td: str,
                                device: str = "cuda",
                                started: dict | None = None) -> dict:
    """dist_soak.py ``arm_kill_federation_worker``: ``cfg['workers']``
    worker processes started through ``child_argv`` with ``device``
    (by ``start_fed_workers``, here or earlier: ``started``) behind
    fault-injecting socket proxies, a ``ProcFederation`` manager on
    ``device`` against an in-process ``FederationSim`` control on
    ``device``; w0 SIGKILLed after ``fed_pre_kill_steps`` and rebuilt
    from its journals on its port.  Every digest must equal the
    control's.  The manager's ``stats`` read the clients' RPC counters
    and the supervisor's, as the script feeds them."""
    from .chaos import injector as chaos
    from .dist.proxy import FaultPlan, SocketFaultProxy
    from .federation.procs import ProcFederation, fed_traffic
    from .federation.sim import FederationSim, FedSpec
    from .remote import state_digest
    started = started or start_fed_workers(cfg, seed, td, device)
    sup, workers, tmp = started["sup"], started["workers"], started["tmp"]
    n_cqs, remote_cqs = cfg["fed_cqs"], cfg["fed_remote_cqs"]
    proxies, argvs = [], list(started["argvs"])
    try:
        starts = dict(wait_fed_workers(started, cfg["ready_timeout_s"]))
        inj = chaos.ChaosInjector(seed=seed)
        inj.arm("dist.proxy_fault", at=3, action="truncate", payload=16)
        inj.arm("dist.proxy_fault", at=9, action="reset")
        chaos.install(inj)
        plan = FaultPlan.resolved(reset=cfg["proxy_reset"],
                                  latency=cfg["proxy_latency"],
                                  latency_s=0.02)
        urls = {}
        for name, mp in workers.items():
            px = SocketFaultProxy(mp.port, seed=seed, plan=plan)
            px.start()
            proxies.append(px)
            urls[name] = px.base_url
        traffic = fed_traffic(steps=cfg["fed_traffic_steps"], per_step=2,
                              n_cqs=n_cqs)
        fed = ProcFederation(urls, n_cqs=n_cqs, remote_cqs=remote_cqs,
                             client_timeout=2.0, client_retries=4,
                             device=device)
        fed.load_traffic(traffic)
        spec = FedSpec(n_workers=cfg["workers"], n_cqs=n_cqs,
                       remote_cqs=remote_cqs, manager_quota_m=8000,
                       worker_quota_m=4000, runtime_steps=2,
                       worker_lost_timeout=3.0, reconnect_budget=0,
                       device=device)
        ctl = FederationSim(spec, wal_dir=f"{tmp}/ctl")
        ctl.load_traffic(dict(traffic))
        pre = cfg["fed_pre_kill_steps"]
        for _ in range(pre):
            fed.step()
            ctl.step()
        port0 = workers["w0"].port
        inj.arm("dist.kill", at=1, payload="w0")
        killed = sup.maybe_kill("w0")
        argv, _ = _fed_worker_argv(tmp, cfg, device, "w0", recover=True,
                                   resume_t=fed.clock.t, port=port0)
        argvs.append(argv)
        t0 = time.perf_counter()
        sup.restart("w0", argv=argv, timeout=cfg["ready_timeout_s"])
        starts["w0 restart"] = time.perf_counter() - t0
        for _ in range(cfg["fed_post_kill_steps"]):
            fed.step()
            ctl.step()
        dg = fed.digests()
        worker_parity = all(dg["workers"][n] == state_digest(ctl.workers[n])
                            for n in urls)
        manager_parity = dg["manager"] == state_digest(ctl.manager)
        settled = fed.settled() and ctl.settled()
        cl_stats = fed.client_stats()
        resyncs = cl_stats["w0"]["epoch_resyncs"]
        proxy = Counter()
        for px in proxies:
            proxy.update(px.stats)
        # the distributed counters through Driver.stats, as the script
        # samples its kueue_dist_* / kueue_rpc_* series
        fed.manager.rpc_clients = list(fed.clients.values())
        fed.manager.dist_stats = {"by_role": sup.stats,
                                  "proxy": dict(proxy), "shard_depths": {}}
        mstats = fed.manager.stats
        unfinished = sum(1 for wl in fed.manager.workloads.values()
                         if not wl.is_finished)
        duplicated = len(fed.violations) + len(ctl.violations)
        stats = {n: child_stats(f"{tmp}/{n}.stats") for n in workers}
        rep = sup.report()
    finally:
        chaos.clear()
        for px in proxies:
            px.stop()
        sup.terminate_all()
    parity = manager_parity and worker_parity
    return {
        "killed": bool(killed), "steps": pre + cfg["fed_post_kill_steps"],
        "manager_parity": manager_parity, "worker_parity": worker_parity,
        "decisions_identical": parity, "parity": parity,
        "settled": settled, "lost": 0 if settled else unfinished,
        "duplicated": duplicated, "epoch_resyncs": resyncs,
        "client_stats": cl_stats, "proxy": dict(proxy),
        "restarts": rep["by_role"]["worker"]["restarts"],
        "metrics": {"rpc": mstats.get("rpc"), "dist": mstats.get("dist")},
        "digests": dg, "starts_s": starts, "child_stats": stats,
        "argvs": argvs, "report": rep,
        "manager": fed.manager, "control": ctl,
        "ok": (bool(killed) and parity and settled and duplicated == 0
               and resyncs >= 1),
    }


def dist_socket_faults(cfg: dict, seed: int, td: str,
                       device: str = "cuda") -> dict:
    """dist_soak.py ``arm_socket_faults``: one worker process on
    ``device`` behind a ``SocketFaultProxy`` with a reset, a truncation,
    a latency and a blackhole armed at its 2nd / 4th / 6th / 8th
    connection; ten ``admin_status`` calls must survive them, counted
    apart, and a client of a dead port must see connect-refused."""
    import os
    import socket

    from .chaos import injector as chaos
    from .dist.proxy import SocketFaultProxy
    from .dist.supervisor import ProcessSupervisor
    from .remote import ConnectionLost, HttpWorkerClient
    tmp = f"{td}/sock"
    os.makedirs(tmp, exist_ok=True)
    sup = ProcessSupervisor(seed=seed)
    px = None
    try:
        argv, pf = _fed_worker_argv(tmp, cfg, device, "w0", remote_cqs=2)
        t0 = time.perf_counter()
        mp = sup.spawn("w0", "worker", argv, port_file=pf)
        sup.wait_ready(mp, timeout=cfg["ready_timeout_s"])
        starts = {"w0": time.perf_counter() - t0}
        inj = chaos.ChaosInjector(seed=seed)
        inj.arm("dist.proxy_fault", at=2, action="reset")
        inj.arm("dist.proxy_fault", at=4, action="truncate", payload=16)
        inj.arm("dist.proxy_fault", at=6, action="latency", payload=0.2)
        inj.arm("dist.proxy_fault", at=8, action="blackhole")
        chaos.install(inj)
        px = SocketFaultProxy(mp.port, seed=seed)
        px.start()
        cl = HttpWorkerClient(px.base_url, timeout=1.0, retries=4,
                              backoff_base=0.01, backoff_max=0.05,
                              deadline_s=10.0)
        for _ in range(10):
            cl.admin_status()   # retries absorb every armed fault
        survived = True
        chaos.clear()
        # nothing listening: pure connect-refused classification
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        cl2 = HttpWorkerClient(f"http://127.0.0.1:{dead_port}",
                               timeout=1.0, retries=2, backoff_base=0.01,
                               backoff_max=0.02, deadline_s=5.0)
        refused_kind = None
        try:
            cl2.admin_status()
        except ConnectionLost as e:
            refused_kind = e.kind
        stats = {"w0": child_stats(f"{tmp}/w0.stats")}
        rep = sup.report()
    finally:
        chaos.clear()
        if px is not None:
            px.stop()
        sup.terminate_all()
    ok = (survived and px.stats["resets"] == 1
          and px.stats["truncations"] == 1
          and px.stats["latencies"] == 1
          and px.stats["blackholes"] == 1
          and cl.stats["midbody_retries"] >= 1
          and cl.stats["retries"] >= 3
          and refused_kind == "refused"
          and cl2.stats["refused_retries"] == 2)
    return {
        "proxy": dict(px.stats), "client": dict(cl.stats),
        "refused_kind": refused_kind,
        "refused_retries": cl2.stats["refused_retries"],
        "ok": ok, "starts_s": starts, "child_stats": stats,
        "argvs": [argv], "report": rep,
    }


# -- the kueuectl file store (cli.py) ----------------------------------------

def cli_bench_docs(scale: float = 0.2) -> list:
    """The perf scenario's cluster and workloads at ``scale`` as manifests
    (``api.manifests.to_manifest``; each ClusterQueue's preemption policy,
    which the codec does not encode, added to its spec): the flavor, the
    30 ClusterQueues with their LocalQueues, then every workload in
    creation order."""
    from .api import manifests
    flavor, queues, waves, _ = bench_objects(scale)
    docs = [manifests.to_manifest(flavor)]
    for cq, lq in queues:
        doc = manifests.to_manifest(cq)
        doc["spec"]["preemption"] = {
            "reclaimWithinCohort": cq.preemption.reclaim_within_cohort.value,
            "withinClusterQueue": cq.preemption.within_cluster_queue.value}
        docs += [doc, manifests.to_manifest(lq)]
    wls = sorted((w for ws in waves.values() for w in ws),
                 key=lambda w: w.creation_time)
    return docs + [manifests.to_manifest(w) for w in wls]


def cli_serve_docs(n: int = 100, first: int = 1_000_000) -> list:
    """What the daemon picks up while it serves: a cohort of its own with
    two ClusterQueues of ``n // 2`` units of cpu each, their LocalQueues
    and ``n`` one-unit workloads between them, created after every
    workload of ``cli_bench_docs``.  Each fits, so each is admitted, two
    heads of one cohort a cycle (an admit scan, not the solver's
    one-head shortcut)."""
    from .api import manifests
    docs = []
    for q in range(2):
        docs += [manifests.to_manifest(ClusterQueue(
            name=f"cq-serve-{q}", cohort="cohort-serve",
            resource_groups=[ResourceGroup(
                covered_resources=["cpu"], flavors=[FlavorQuotas(
                    name="default", resources={"cpu": ResourceQuota(
                        nominal=n // 2 * UNIT)})])])),
            manifests.to_manifest(LocalQueue(
                name=f"lq-serve-{q}", cluster_queue=f"cq-serve-{q}"))]
    return docs + [
        manifests.to_manifest(Workload(
            name=f"serve-{i}", queue_name=f"lq-serve-{i % 2}", priority=50,
            creation_time=float(first + i),
            pod_sets=[PodSet(name="main", count=1,
                             requests={"cpu": UNIT})]))
        for i in range(n)]


def write_manifests(path: str, docs: list) -> str:
    """``docs`` as one multi-document file for ``cli apply -f`` (JSON
    documents, which YAML reads, between ``---`` lines)."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n---\n".join(json.dumps(d) for d in docs) + "\n")
    return path


def store_digest(state_dir: str) -> str:
    """A digest of a store's workload manifests without their conditions'
    ``lastTransitionTime`` (the Driver's wall clock sets it): their spec,
    admissions and conditions, in name order."""
    import os
    from .cli import STATE_FILE
    with open(os.path.join(state_dir, STATE_FILE), encoding="utf-8") as fh:
        docs = json.load(fh)
    wls = []
    for doc in docs:
        if doc.get("kind") != "Workload":
            continue
        doc = json.loads(json.dumps(doc))
        for c in (doc.get("status") or {}).get("conditions", []):
            c.pop("lastTransitionTime", None)
        wls.append(doc)
    wls.sort(key=lambda d: (d["metadata"].get("namespace", "default"),
                            d["metadata"]["name"]))
    blob = json.dumps(wls, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def cli_argv(state_dir: str, device: str, *args) -> list:
    """``python -m kueue_tpu_torch.cli --state-dir ... --device ...``."""
    import sys
    return [sys.executable, "-m", "kueue_tpu_torch.cli", "--state-dir",
            str(state_dir), "--device", device, *args]


def cli_env() -> tuple:
    """(cwd, environment) for a CLI child: the checkout that holds this
    package, first on the child's path."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH", "")
    return root, dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in path.split(os.pathsep) if p]))


class _Child:
    """A CLI child whose stdout and stderr lines are read as they come."""

    def __init__(self, argv, cwd, env):
        import subprocess
        import threading
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        self.out: list = []
        self.err: list = []
        self.out_closed = False
        self._cv = threading.Condition()
        for pipe, lines in ((self.proc.stdout, self.out),
                            (self.proc.stderr, self.err)):
            threading.Thread(target=self._read, args=(pipe, lines),
                             daemon=True).start()

    def _read(self, pipe, lines) -> None:
        for line in pipe:
            with self._cv:
                lines.append((time.perf_counter() - self.t0,
                              line.rstrip("\n")))
                self._cv.notify_all()
        with self._cv:
            if lines is self.out:
                self.out_closed = True
            self._cv.notify_all()

    def wait_line(self, prefix: str, timeout: float) -> float:
        """Seconds from spawn to the first stdout line that starts with
        ``prefix``; raises when stdout closes or the time is up first."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for t, line in self.out:
                    if line.startswith(prefix):
                        return t
                left = deadline - time.monotonic()
                if self.out_closed or left <= 0:
                    raise RuntimeError(f"no {prefix!r} from the child "
                                       f"(exit {self.proc.poll()}): "
                                       f"{self.tail()}")
                self._cv.wait(min(left, 0.2))

    def tail(self, n: int = 8) -> str:
        return " | ".join(line for _, line in (self.out + self.err)[-n:])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _last_dump(lines: list):
    """(text, admitted keys) of the last complete ``dump_state`` in a
    child's stderr lines, or None before one is complete."""
    text = [line for _, line in lines]
    starts = [i for i, line in enumerate(text)
              if line == "=== kueue-tpu state dump ==="]
    for i in reversed(starts):
        body = text[i:]
        if "-- events --" in body and body.index("-- events --") + 1 < \
                len(body):
            a = body.index("-- admitted workloads --")
            b = body.index("-- in-flight cycle --")
            return "\n".join(body[:body.index("-- events --") + 2]), \
                {line.strip() for line in body[a + 1:b]}
    return None


def cli_serve_sequence(state_dir: str, extra: str, device: str,
                       new_keys, timeout: float = 180.0) -> dict:
    """The file-store daemon handing over, each step a CLI child on
    ``device``: a leader ``serve --poll-interval 0.1`` on the store, a
    second ``serve --exit-when-drained --poll-interval 0.1`` that waits
    for the lease; ``apply -f extra`` while the leader serves, SIGUSR2
    until the leader's dump lists ``new_keys`` admitted (its store
    watcher picked them up), SIGTERM (the leader writes back and
    releases the lease); the waiter takes over, drains and exits.  The
    leader runs without ``--exit-when-drained``, which would end it
    before the apply.  Returns the seconds of each step (``ready_s``:
    the leader and the waiter from spawn to ready, the apply child's run,
    the wait for the dump after it, and from the SIGTERM the leader's
    exit, the waiter's takeover and its exit), the exit codes, the
    leader's dump and ``store_digest`` of the result."""
    import signal
    import subprocess
    from .leaderelection import FileLease
    cwd, env = cli_env()
    lock = FileLease(state_dir).path
    t0 = time.perf_counter()
    kids = []
    try:
        leader = _Child(cli_argv(state_dir, device, "serve",
                                 "--poll-interval", "0.1"), cwd, env)
        kids.append(leader)
        # the waiter starts once the leader holds the lease
        deadline = time.monotonic() + timeout
        while True:
            try:
                with open(lock, encoding="utf-8") as fh:
                    if fh.read().strip() == str(leader.proc.pid):
                        break
            except OSError:
                pass
            if leader.proc.poll() is not None or \
                    time.monotonic() > deadline:
                raise RuntimeError(f"leader took no lease: {leader.tail()}")
            time.sleep(0.05)
        waiter = _Child(cli_argv(state_dir, device, "serve",
                                 "--exit-when-drained", "--poll-interval",
                                 "0.1"), cwd, env)
        kids.append(waiter)
        ready = {"leader": leader.wait_line("serving from", timeout),
                 "waiter": waiter.wait_line("waiting for leadership",
                                            timeout)}
        t1 = time.perf_counter()
        r = subprocess.run(cli_argv(state_dir, device, "apply", "-f", extra),
                           cwd=cwd, env=env, capture_output=True, text=True,
                           timeout=timeout)
        ready["apply"] = time.perf_counter() - t1
        if r.returncode != 0:
            raise RuntimeError(f"apply exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        t1 = time.perf_counter()
        want = set(new_keys)
        dump = None
        while dump is None or not want <= dump[1]:
            if time.monotonic() > deadline or leader.proc.poll() is not None:
                raise RuntimeError(f"the leader's dump never listed the "
                                   f"applied workloads: {leader.tail()}")
            leader.proc.send_signal(signal.SIGUSR2)
            time.sleep(0.25)
            with leader._cv:
                dump = _last_dump(leader.err)
        ready["admitted_in_dump"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        leader.proc.send_signal(signal.SIGTERM)
        rc_leader = leader.proc.wait(timeout)
        ready["leader_exit"] = time.perf_counter() - t1
        ready["takeover"] = waiter.wait_line("serving from", timeout) - (
            t1 - waiter.t0)
        rc_waiter = waiter.proc.wait(timeout)
        ready["waiter_exit"] = time.perf_counter() - t1
    finally:
        for k in kids:
            k.stop()
    return {"ready_s": {k: round(v, 3) for k, v in ready.items()},
            "rc": {"leader": rc_leader, "waiter": rc_waiter},
            "dump": dump[0], "admitted_in_dump": len(want & dump[1]),
            "leader_out": [line for _, line in leader.out],
            "waiter_out": [line for _, line in waiter.out],
            "wall": time.perf_counter() - t0,
            "digest": store_digest(state_dir),
            "ok": rc_leader == 0 and rc_waiter == 0 and want <= dump[1]}


def cli_serve_in_process(state_dir: str, extra: str, device: str,
                         new_keys, timeout: float = 120.0) -> dict:
    """``cli serve --poll-interval 0.05`` on the calling thread, and from
    another thread, once it serves, ``cli apply -f extra``; when the
    daemon's Driver holds ``new_keys`` admitted (its store watcher
    restored them, its cycles admitted them) that thread sets the
    daemon's stop event, as its SIGTERM handler would, and the daemon
    writes back and returns.  Every call of the daemon's
    ``solver.dispatch`` counts to the thread that made it.  Returns the
    daemon's Driver, its thread, those counts and the apply thread's
    error (None when it saw every key admitted)."""
    import signal
    import threading
    from . import cli
    serve_thread = threading.get_ident()
    built: dict = {}
    dispatches: Counter = Counter()
    orig_build = cli.build_driver

    def build(store, device: str = "cuda"):
        d = orig_build(store, device=device)
        if threading.get_ident() == serve_thread and "driver" not in built:
            built["driver"] = d
            run, dispatch = d.run, d.scheduler.solver.dispatch

            def run_recorded(stop, **kw):
                built["stop"] = stop
                return run(stop, **kw)

            def dispatch_recorded(*a, **kw):
                dispatches[threading.get_ident()] += 1
                return dispatch(*a, **kw)

            d.run = run_recorded
            d.scheduler.solver.dispatch = dispatch_recorded
        return d

    err: list = []

    def apply_then_stop():
        deadline = time.monotonic() + timeout
        try:
            while "stop" not in built:
                if time.monotonic() > deadline:
                    raise TimeoutError("the daemon never started serving")
                time.sleep(0.02)
            rc = cli.main(["--state-dir", state_dir, "--device", device,
                           "apply", "-f", extra])
            if rc != 0:
                raise RuntimeError(f"apply exited {rc}")
            d = built["driver"]
            while not set(new_keys) <= set(d.admitted_keys()):
                if time.monotonic() > deadline:
                    raise TimeoutError("the applied workloads were never "
                                       "admitted")
                time.sleep(0.02)
        except BaseException as e:
            err.append(e)
        finally:
            if "stop" in built:
                built["stop"].set()

    saved = {s: signal.getsignal(s)
             for s in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR2)}
    cli.build_driver = build
    helper = threading.Thread(target=apply_then_stop, daemon=True)
    helper.start()
    try:
        rc = cli.main(["--state-dir", state_dir, "--device", device,
                       "serve", "--poll-interval", "0.05"])
    finally:
        cli.build_driver = orig_build
        if threading.current_thread() is threading.main_thread():
            for s, h in saved.items():     # cmd_serve installed its own
                signal.signal(s, h)
        built.setdefault("stop", threading.Event()).set()
        helper.join(timeout)
    return {"rc": rc, "driver": built.get("driver"),
            "serve_thread": serve_thread, "dispatches": dict(dispatches),
            "error": err[0] if err else None}
