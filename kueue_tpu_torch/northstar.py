"""North-star end-to-end run of the port: the real Driver at 100k pending
workloads across 1k ClusterQueues, the device solver on — pack, admit
scans, unpack and store updates per cycle, nothing synthetic (the JAX
package's ``scripts/northstar_e2e.py``, every flag and JSON key kept).

    python -m kueue_tpu_torch.northstar [--cqs 1000] [--wl 100000]
        [--cycles 30] [--host] [--device] [--burst] [--ab-hetero]
        [--flavors F] [--resources R] [--ab-shards N] [--crossover 1,2,4]
        [--ab-pack] [--ab-pipeline] [--fair-sharing] [--trickle N]
        [--quick] [--out PATH] [--torch-device cuda|cpu]

``--host`` / ``--device`` run only the host / only the device path;
the torch device is ``--torch-device`` (default ``cuda``: the CUDA
kernels; ``cpu``: their plain PyTorch versions).  Without a GPU and
without ``--torch-device cpu`` the run raises.  ``--burst-backend``:
``accel`` runs the fused burst on a Driver on the torch device, ``cpu``
on a Driver on "cpu", ``both`` the two in that order.  Shard counts
(``--shards``, ``--ab-shards``, ``--crossover``) above the CUDA device
count, or on the CPU, run on a virtual mesh of the torch device
(``parallel.sharded.virtual_mesh``); the ``mesh`` block then says
``"virtual": true``.

Prints per-cycle latencies on stderr and the JSON tail as the last line
of stdout (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from . import scenarios
from .api import types as api_types
from .api.types import (
    ClusterQueue,
    FlavorFungibility,
    FlavorFungibilityPolicy,
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
from .ops.solver import resolve_device
from .perf.harness import (ab_block, burst_boundary_report,
                           require_accel_or_die, shard_imbalance_report)
from .scenarios import VirtualClock, release

# heterogeneous runs cycle the whenCanBorrow x whenCanPreempt matrix
# across CQs so the flavor walk sees every policy shape
FF_MIX = [
    FlavorFungibility(),                                  # Borrow/TryNext
    FlavorFungibility(
        when_can_borrow=FlavorFungibilityPolicy.TRY_NEXT_FLAVOR),
    FlavorFungibility(
        when_can_preempt=FlavorFungibilityPolicy.PREEMPT),
    FlavorFungibility(
        when_can_borrow=FlavorFungibilityPolicy.TRY_NEXT_FLAVOR,
        when_can_preempt=FlavorFungibilityPolicy.PREEMPT),
]


def resource_names(n_resources: int) -> list:
    return (["cpu"] + [f"res-{r}" for r in range(1, n_resources)]
            if n_resources > 1 else ["cpu"])


def build(n_cqs: int, n_wl: int, use_device: bool, cqs_per_cohort: int = 5,
          n_flavors: int = 1, n_resources: int = 1, device: str = "cuda"):
    """The cluster and backlog on a Driver on ``device`` → (driver, clock,
    total, preemptor_wave): ``n_flavors`` flavors (all but the last with
    a tight 500 nominal, so the flavor walk visits most of the list),
    ``n_resources`` resources, ``FF_MIX[i % 4]`` on CQ i when there are
    several flavors, and the ragged low / medium priority mix."""
    clock = VirtualClock()
    d = Driver(clock=clock, use_device_solver=use_device, device=device)
    flavors = ([f"flavor-{f}" for f in range(n_flavors)]
               if n_flavors > 1 else ["default"])
    for f in flavors:
        d.apply_resource_flavor(ResourceFlavor(name=f))
    resources = resource_names(n_resources)
    per_cq = max(1, n_wl // n_cqs)
    t_build = time.perf_counter()
    for i in range(n_cqs):
        cohort = f"cohort-{i // cqs_per_cohort}"
        d.apply_cluster_queue(ClusterQueue(
            name=f"cq-{i}", cohort=cohort,
            flavor_fungibility=(FF_MIX[i % len(FF_MIX)]
                                if n_flavors > 1 else FlavorFungibility()),
            preemption=PreemptionPolicy(
                reclaim_within_cohort=ReclaimWithinCohort.ANY,
                within_cluster_queue=WithinClusterQueue.LOWER_PRIORITY),
            resource_groups=[ResourceGroup(
                covered_resources=list(resources),
                flavors=[FlavorQuotas(name=f, resources={
                    r: ResourceQuota(
                        nominal=(500 if fi < len(flavors) - 1 else 20_000),
                        borrowing_limit=100_000)
                    for r in resources})
                    for fi, f in enumerate(flavors)])]))
        d.apply_local_queue(LocalQueue(name=f"lq-{i}",
                                       cluster_queue=f"cq-{i}"))
    # the high-priority preemptor wave is injected mid-run by the drains
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
                                 requests={r: per_pod
                                           for r in resources})]))

    def preemptor_wave(start_time: float) -> int:
        """One large high-priority gang per CQ: 5000/pod x 4 pods fills
        the whole nominal quota, forcing preemption of the running
        low-priority wave (reclaimWithinCohort + lowerPriority)."""
        n = 0
        for i in range(n_cqs):
            n += 1
            d.create_workload(Workload(
                name=f"pre-{i}", queue_name=f"lq-{i}", priority=200,
                creation_time=start_time + n,
                pod_sets=[PodSet(name="main", count=4,
                                 requests={r: 5000 for r in resources})]))
        return n

    print(f"built {n_cqs} CQs x {len(flavors)} flavors x "
          f"{len(resources)} resources / {total} workloads in "
          f"{time.perf_counter() - t_build:.1f}s", file=sys.stderr)
    scenarios.freeze_heap()
    return d, clock, total, preemptor_wave


def summarize_trials(runs) -> dict:
    """Median trial (by p99) with min/max spread."""
    cold_warmup_s = runs[0].get("warmup_s", 0.0)
    runs = sorted(runs, key=lambda r: r["p99_ms"])
    out = dict(runs[len(runs) // 2])
    out["trials"] = len(runs)
    out["p50_ms_range"] = [min(r["p50_ms"] for r in runs),
                           max(r["p50_ms"] for r in runs)]
    out["p99_ms_range"] = [min(r["p99_ms"] for r in runs),
                           max(r["p99_ms"] for r in runs)]
    out["warmup_s"] = cold_warmup_s   # chronologically-first (cold) trial
    out["decisions_stable"] = all(
        (r["admitted"], r["preempted"], r["skipped"]) ==
        (runs[0]["admitted"], runs[0]["preempted"], runs[0]["skipped"])
        for r in runs)
    return out


def with_trials(trial_fn, args) -> dict:
    runs = []
    for _ in range(max(1, args.trials)):
        runs.append(trial_fn())
        # the finished trial's driver graph is freed before the next
        # build freezes its own
        release()
    return summarize_trials(runs)


def _keep(record, path: str, decisions: list) -> None:
    """An arm's per-cycle decisions (``scenarios.cycle_record``) and
    their digest, appended to ``record`` when the caller keeps them."""
    if record is not None:
        record.append(dict(path=path, decisions=decisions,
                           digest=scenarios.records_digest(decisions)))


def _percentiles(cycle_times) -> tuple:
    cycle_times = sorted(cycle_times)
    p50 = cycle_times[len(cycle_times) // 2] if cycle_times else 0.0
    p99 = (cycle_times[min(len(cycle_times) - 1,
                           int(len(cycle_times) * 0.99))]
           if cycle_times else 0.0)
    return p50, p99


def run_burst_path(args, backend: str, record: list | None = None) -> dict:
    """The fused-burst path (``ops.burst``): runs of clean cycles are
    decided in single launches on the Driver's device (``backend``
    "accel": the torch device; "cpu": the CPU); preemption waves fall
    back to the per-cycle path automatically.  Per-cycle wall times are
    measured between applied-cycle boundaries, so pack + dispatch costs
    land in the first cycle of each burst."""
    os.environ["KUEUE_BURST_DELTA_PACK"] = (
        "0" if getattr(args, "no_delta_pack", False) else "1")
    device = args.torch_device if backend == "accel" else "cpu"
    d, clock, total, preemptor_wave = build(
        args.cqs, args.wl, use_device=True,
        n_flavors=args.flavors, n_resources=args.resources, device=device)
    t_w = time.perf_counter()
    d.scheduler.solver.warmup(d.cache.snapshot(), args.cqs)
    # launch every K rung this run can hit once, and chain one
    # speculative window (the pipeline's carry rebase), before the
    # measured window
    from .ops.burst import K_BURST_LADDER, BurstSolver, pack_burst
    st = d.scheduler.solver._structure_for(d.cache.snapshot(), [])
    plan = pack_burst(st, d.queues, d.cache, d.scheduler, clock)
    bs = BurstSolver(device=device)
    shards = getattr(args, "shards", 0)
    if shards > 1:
        bs.set_shards(shards)
    if plan is not None:
        F = max(1, len(st.fr_index))
        for K in K_BURST_LADDER:
            extr = np.zeros((K, plan.C, F), np.int32)
            extu = np.zeros((K, plan.G), bool)
            h = bs.dispatch(plan, K, args.runtime, extr, extu)
            bs.fetch_flags(h)
            h2 = bs.dispatch_next(h, extr, extu)
            bs.fetch(h)
            if h2 is not None:
                bs.fetch(h2)
        bs.stats = {k: ([0.0] * len(v) if isinstance(v, list)
                        else 0 if isinstance(v, int) else 0.0)
                    for k, v in bs.stats.items()}
        bs._resident = None
        d._burst_m = plan.M
    d._burst_solver = bs
    warmup_s = time.perf_counter() - t_w
    print(f"solver+burst warmup {warmup_s:.1f}s", file=sys.stderr)

    # collection paused for the measured phase on every arm equally
    gc.disable()
    try:
        out = _burst_drain(args, backend, d, clock, total, preemptor_wave,
                           warmup_s, record)
    finally:
        gc.enable()
    print(f"burst[{backend}] stats: {d._burst_solver.stats}",
          file=sys.stderr)
    return out


def _burst_drain(args, backend, d, clock, total, preemptor_wave,
                 warmup_s: float, record) -> dict:
    """``run_burst_path``'s measured part: the main cycles with the wave,
    then with ``--trickle`` the fill and the sparse-boundary rounds."""
    from .scheduler.scheduler import CycleStats
    inject_at = args.inject_at if args.inject_at >= 0 else args.cycles // 3
    budget_s = float(getattr(args, "budget_s", 0.0) or 0.0)
    pipeline = not args.no_pipeline
    completed = True
    t_run0 = time.perf_counter()
    all_stats = []
    cycle_times = []
    decisions = []
    last_t = time.perf_counter()

    def on_cycle_start(_k):
        clock.t += 1.0

    def on_cycle(_k, stats):
        nonlocal last_t
        now = time.perf_counter()
        # finish application is workload-controller work, excluded from
        # scheduler-cycle latency as the per-cycle loop excludes it
        cycle_times.append(max(0.0, now - last_t - stats.finish_s))
        last_t = now
        if record is not None:
            decisions.append(scenarios.cycle_record(d, stats))
        print(f"cycle {len(cycle_times) - 1}: "
              f"{cycle_times[-1]*1e3:.1f}ms "
              f"admitted={len(stats.admitted)} "
              f"preempted={len(stats.preempted_targets)} "
              f"skipped={len(stats.skipped)} "
              f"inadmissible={len(stats.inadmissible)}", file=sys.stderr)

    def burst(n, runtime):
        nonlocal last_t
        last_t = time.perf_counter()
        return d.schedule_burst(
            n, runtime=runtime, external_finishes=ext,
            on_cycle=on_cycle, on_cycle_start=on_cycle_start,
            backend="auto", pipeline=pipeline)

    injected = False
    while len(all_stats) < args.cycles:
        if budget_s and time.perf_counter() - t_run0 > budget_s:
            completed = False
            print(f"budget {budget_s:.0f}s exhausted after "
                  f"{len(all_stats)}/{args.cycles} cycles",
                  file=sys.stderr)
            break
        if not injected and len(all_stats) >= inject_at:
            n = preemptor_wave(clock.t)
            total += n
            injected = True
            print(f"cycle {len(all_stats)}: injected {n} preemptors",
                  file=sys.stderr)
        target = args.cycles if injected else inject_at
        if budget_s:
            # budgeted runs chunk the window stream so the wall check
            # fires between dispatches instead of after a whole phase
            target = min(target, len(all_stats) + 8)
        base = len(all_stats)
        ext = scenarios.carry_finishes(d, all_stats, args.runtime)
        stats = burst(target - base, args.runtime)
        all_stats.extend(stats)
        if not stats:
            if not injected:
                # drained before the wave: pad the quiet cycles (the
                # per-cycle path runs them as empty cycles) and inject
                while len(all_stats) < inject_at:
                    clock.t += 1.0
                    all_stats.append(CycleStats())
                    cycle_times.append(0.0)
                    if record is not None:
                        decisions.append(scenarios.cycle_record(
                            d, all_stats[-1]))
                continue
            break

    # sparse-boundary phase: each round dirties a handful of CQs and runs
    # one short window, so the boundary pack is paid at O(dirty rows) —
    # where the delta-vs-full pack claim is measured
    trickle = getattr(args, "trickle", 0)
    n_main_cycles = len(cycle_times)
    if trickle > 0:
        resources = resource_names(args.resources)
        # the steady state the trickle measures against: long-running
        # services (no finish events) fill every CQ and the leftover
        # backlog parks, so trickle boundaries see a full, quiet cluster
        for i in range(args.cqs):
            for s in range(8):
                total += 1
                d.create_workload(Workload(
                    name=f"svc-{i}-{s}", queue_name=f"lq-{i}",
                    priority=300, creation_time=clock.t + i * 8 + s,
                    pod_sets=[PodSet(name="main", count=1,
                                     requests={r: 2500
                                               for r in resources})]))
        ext = {}
        for _ in range(8):   # fill to quiescence
            stats = burst(16, 10_000)
            all_stats.extend(stats)
            if not any(s.admitted or s.preempted_targets for s in stats):
                break
        pre = dict(d._burst_solver.stats)
        n_touch = max(1, min(10, args.cqs))
        t_adm = 0
        rounds_run = 0
        for t in range(trickle):
            if budget_s and time.perf_counter() - t_run0 > budget_s:
                completed = False
                print(f"budget {budget_s:.0f}s exhausted after trickle "
                      f"round {t}/{trickle}", file=sys.stderr)
                break
            rounds_run += 1
            for i in range(n_touch):
                total += 1
                d.create_workload(Workload(
                    name=f"trk-{t}-{i}", queue_name=f"lq-{i}",
                    priority=200, creation_time=clock.t + i + 1,
                    pod_sets=[PodSet(name="main", count=1,
                                     requests={r: 100
                                               for r in resources})]))
            stats = burst(2, args.runtime)
            all_stats.extend(stats)
            t_adm += sum(len(s.admitted) for s in stats)
        bs_now = d._burst_solver.stats
        trickle_stats = {
            k: (round(bs_now.get(k, 0) - pre.get(k, 0), 4)
                if isinstance(bs_now.get(k, 0), float)
                else bs_now.get(k, 0) - pre.get(k, 0))
            for k in ("burst_pack_s", "burst_packs", "burst_full_packs",
                      "burst_delta_packs", "delta_pack_s", "rows_reused",
                      "rows_repacked")}
        trickle_stats["rounds"] = rounds_run
        trickle_stats["rounds_requested"] = trickle
        trickle_stats["cqs_touched_per_round"] = n_touch
        trickle_stats["admitted"] = t_adm

    # headline percentiles cover the backlog-drain phase only; the
    # fill / trickle phases report their boundary costs through the pack
    # counters
    p50, p99 = _percentiles(cycle_times[:n_main_cycles])
    bs = d._burst_solver
    suffix = ("" if not args.no_pipeline else "-serial") + (
        "-fullpack" if getattr(args, "no_delta_pack", False) else "") + (
        f"-shard{bs.n_shards}" if bs.n_shards > 1 else "")
    out = {
        "path": f"burst-{backend}{suffix}",
        "p50_ms": round(p50 * 1e3, 1),
        "p99_ms": round(p99 * 1e3, 1),
        "admitted": sum(len(s.admitted) for s in all_stats),
        "preempted": sum(len(s.preempted_targets) for s in all_stats),
        "skipped": sum(len(s.skipped) for s in all_stats),
        "workloads": total,
        "cycles_run": len(all_stats),
        "completed": completed,
        "warmup_s": round(warmup_s, 1),
        "burst_stats": dict(bs.stats),
        "boundary_pipeline": burst_boundary_report(bs.stats),
        "solver_stats": dict(d.scheduler.solver.stats),
        "obs": d.obs.report(),
    }
    if budget_s:
        out["budget_s"] = budget_s
        out["elapsed_s"] = round(time.perf_counter() - t_run0, 1)
    if trickle > 0:
        out["trickle"] = trickle_stats
    _keep(record, out["path"], decisions)
    return out


def run_fs_path(args, use_device: bool, record: list | None = None) -> dict:
    """Fair sharing at north-star scale: cohorts with uneven weights and
    heavy borrowing contention (``scenarios.northstar_fs_spec``), so the
    fair-sharing tournament runs hot; FS preemption stays host-side."""
    clock = VirtualClock()
    d = Driver(clock=clock, fair_sharing=True, use_device_solver=use_device,
               device=args.torch_device)
    total = scenarios.northstar_fs_spec(api_types, d, args.cqs, args.wl)
    scenarios.freeze_heap()
    if d.scheduler.solver is not None:
        t_w = time.perf_counter()
        d.scheduler.solver.warmup(d.cache.snapshot(), args.cqs)
        print(f"solver warmup {time.perf_counter() - t_w:.1f}s",
              file=sys.stderr)

    cycle_times = []
    decisions = []
    admitted_total = skipped_total = 0
    running = []
    for cycle in range(args.cycles):
        clock.t += 1.0
        c0 = time.perf_counter()
        stats = d.schedule_once()
        dt = time.perf_counter() - c0
        cycle_times.append(dt)
        admitted_total += len(stats.admitted)
        skipped_total += len(stats.skipped)
        if record is not None:
            decisions.append(scenarios.cycle_record(d, stats))
        for key in stats.admitted:
            running.append((cycle + args.runtime, key))
        running, _ = scenarios.finish_due(d, running, cycle)
        print(f"cycle {cycle}: {dt*1e3:.1f}ms "
              f"admitted={len(stats.admitted)} "
              f"skipped={len(stats.skipped)}", file=sys.stderr)

    p50, p99 = _percentiles(cycle_times)
    solver = d.scheduler.solver
    out = {
        "path": "fs-device" if use_device else "fs-host",
        "p50_ms": round(p50 * 1e3, 1),
        "p99_ms": round(p99 * 1e3, 1),
        "admitted": admitted_total,
        "preempted": 0,
        "skipped": skipped_total,
        "workloads": total,
        "fs_stats": dict(d.scheduler.fs_stats),
        "obs": d.obs.report(),
    }
    if solver is not None:
        out["solver_stats"] = dict(solver.stats)
        out["fs_full_cycles"] = solver.stats.get("fs_full_cycles", 0)
        print(f"fs stats: {solver.stats} {d.scheduler.fs_stats}",
              file=sys.stderr)
    _keep(record, out["path"], decisions)
    return out


def run_path(args, use_device: bool, record: list | None = None) -> dict:
    """One ``schedule_once`` per cycle on a Driver on the torch device:
    the device solver (``use_device``) or the host walk."""
    d, clock, total, preemptor_wave = build(
        args.cqs, args.wl, use_device=use_device,
        n_flavors=args.flavors, n_resources=args.resources,
        device=args.torch_device)
    if d.scheduler.solver is not None:
        t_w = time.perf_counter()
        d.scheduler.solver.warmup(d.cache.snapshot(), args.cqs)
        print(f"solver warmup {time.perf_counter() - t_w:.1f}s",
              file=sys.stderr)

    inject_at = args.inject_at if args.inject_at >= 0 else args.cycles // 3
    budget_s = float(getattr(args, "budget_s", 0.0) or 0.0)
    completed = True
    # the same collection discipline as run_burst_path
    gc.disable()
    try:
        t_run0 = time.perf_counter()
        cycle_times = []
        decisions = []
        admitted_total = preempted_total = skipped_total = 0
        running = []
        for cycle in range(args.cycles):
            if budget_s and time.perf_counter() - t_run0 > budget_s:
                completed = False
                print(f"budget {budget_s:.0f}s exhausted after "
                      f"{cycle}/{args.cycles} cycles", file=sys.stderr)
                break
            if cycle == inject_at:
                n = preemptor_wave(clock.t)
                total += n
                print(f"cycle {cycle}: injected {n} high-priority "
                      f"preemptors", file=sys.stderr)
            clock.t += 1.0
            c0 = time.perf_counter()
            stats = d.schedule_once()
            dt = time.perf_counter() - c0
            cycle_times.append(dt)
            admitted_total += len(stats.admitted)
            preempted_total += len(stats.preempted_targets)
            skipped_total += len(stats.skipped)
            if record is not None:
                decisions.append(scenarios.cycle_record(d, stats))
            for key in stats.admitted:
                running.append((cycle + args.runtime, key))
            running, _ = scenarios.finish_due(d, running, cycle)
            print(f"cycle {cycle}: {dt*1e3:.1f}ms "
                  f"admitted={len(stats.admitted)} "
                  f"preempting={len(stats.preempting)} "
                  f"preempted={len(stats.preempted_targets)} "
                  f"skipped={len(stats.skipped)} "
                  f"inadmissible={len(stats.inadmissible)}",
                  file=sys.stderr)
    finally:
        gc.enable()
    p50, p99 = _percentiles(cycle_times)
    solver = d.scheduler.solver
    out = {
        "path": "device" if use_device else "host",
        "p50_ms": round(p50 * 1e3, 1),
        "p99_ms": round(p99 * 1e3, 1),
        "admitted": admitted_total,
        "preempted": preempted_total,
        "skipped": skipped_total,
        "workloads": total,
        "cycles_run": len(cycle_times),
        "completed": completed,
        "obs": d.obs.report(),
    }
    if budget_s:
        out["budget_s"] = budget_s
        out["elapsed_s"] = round(time.perf_counter() - t_run0, 1)
    if solver is not None:
        out["solver_stats"] = dict(solver.stats)
        # the warm-up's kq_add_one round trip; on the CPU there is none
        if solver.rtt_s is not None:
            out["accel_rtt_ms"] = round(solver.rtt_s * 1e3, 1)
        print(f"stats: {solver.stats}", file=sys.stderr)
    _keep(record, out["path"], decisions)
    return out


def mesh_info(shards: int, device="cuda", virtual: bool = False) -> dict:
    """The self-describing mesh / shard block of every artifact: the
    CUDA device count (1 on the CPU), and the meshes ``shards`` builds
    (on a virtual mesh when ``virtual``)."""
    from .parallel.sharded import make_burst_mesh, make_mesh
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    info = {
        "n_devices": torch.cuda.device_count() if on_card else 1,
        "platform": "gpu" if on_card else "cpu",
        "shards": max(1, shards),
    }
    if virtual:
        info["virtual"] = True
    if shards > 1:
        m = make_mesh(shards, device=dev)
        if m is not None:
            info["cycle_mesh_axes"] = {k: int(v) for k, v in m.shape.items()}
        bm = make_burst_mesh(shards, dev)
        if bm is not None:
            info["burst_mesh_axes"] = {bm.axis_names[0]: bm.size}
    return info


def _identical(runs) -> bool:
    """(admitted, preempted, skipped) equal over every run that completed
    its cycles (a budget-cut run stops elsewhere)."""
    done = [r for r in runs if r.get("completed", True)]
    return bool(done) and all(
        (r["admitted"], r["preempted"], r["skipped"]) ==
        (done[0]["admitted"], done[0]["preempted"], done[0]["skipped"])
        for r in done)


def hetero_block(args, runs: dict) -> tuple:
    """The ``--ab-hetero`` summary of interleaved runs ({"in_kernel",
    "burst", "sharded" (optional), "host"} → [trial outs]) → (the arms'
    trial summaries in result order, the ``hetero`` block): fallback
    counters merged over every device-resident arm, cross-arm decision
    identity, and the drift block against the host oracle."""
    sums = {k: summarize_trials(v) for k, v in runs.items()}
    shard_n = args.ab_shards if "sharded" in sums else 0
    results = [sums["in_kernel"], sums["burst"]] + (
        [sums["sharded"]] if shard_n else []) + [sums["host"]]
    ik, bu, ho = sums["in_kernel"], sums["burst"], sums["host"]
    device_arms = [ik, bu] + ([sums["sharded"]] if shard_n else [])
    sstats = [a.get("solver_stats", {}) for a in device_arms]
    bs_ = bu.get("burst_stats", {})
    reasons = {}
    for ss in sstats:
        for k, v in ss.get("scalar_reasons", {}).items():
            reasons[k] = reasons.get(k, 0) + v
    identical = _identical([r for arm in runs.values() for r in arm])
    fallbacks = {
        "host_cycles": sum(s.get("host_cycles", 0) for s in sstats),
        "scalar_heads": sum(s.get("scalar_heads", 0) for s in sstats),
        "scalar_reasons": reasons,
        "native_ff_fallbacks": sum(s.get("native_ff_fallbacks", 0)
                                   for s in sstats),
        "burst_dirty_cycles": bs_.get("burst_dirty_cycles", 0),
        "burst_dirty_preempt": bs_.get("burst_dirty_preempt", 0),
        "burst_dirty_scalar": bs_.get("burst_dirty_scalar", 0),
        "burst_dirty_resume": bs_.get("burst_dirty_resume", 0),
    }
    ss = ik.get("solver_stats", {})
    hetero = {
        "flavors": args.flavors,
        "resources": args.resources,
        "fungibility_mix": "whenCanBorrow x whenCanPreempt matrix "
                           "cycled across CQs (4 combos)",
        "fallbacks": fallbacks,
        "zero_host_fallbacks": (fallbacks["host_cycles"] == 0
                                and fallbacks["scalar_heads"] == 0),
        "resume_heads": sum(s.get("resume_heads", 0) for s in sstats),
        "walk_stop_heads": sum(s.get("walk_stop_heads", 0)
                               for s in sstats),
        "p50_ms_in_kernel": ik["p50_ms"],
        "p50_ms_host": ho["p50_ms"],
        "p99_ms_in_kernel": ik["p99_ms"],
        "p99_ms_host": ho["p99_ms"],
        "in_kernel_beats_host_p99": ik["p99_ms"] < ho["p99_ms"],
        "decisions_identical_across_arms": identical,
        "burst_arm": {
            "p50_ms": bu["p50_ms"], "p99_ms": bu["p99_ms"],
            "completed": bu.get("completed", True),
            "burst_dirty_cycles": bs_.get("burst_dirty_cycles", 0),
            "burst_suppressed_cycles": bs_.get(
                "burst_suppressed_cycles", 0)},
        "drift": ab_block(
            treatment={"arm": ik["path"], "p99_ms": ik["p99_ms"],
                       "solver_stats": {
                           k: v for k, v in ss.items()
                           if not isinstance(v, dict)},
                       "burst_stats": {
                           k: bs_.get(k, 0)
                           for k in ("burst_dirty_cycles",
                                     "burst_dirty_preempt",
                                     "burst_dirty_scalar",
                                     "burst_dirty_resume",
                                     "burst_suppressed_cycles")}},
            control={"arm": "host", "interleaved": True,
                     "p99_ms": ho["p99_ms"],
                     "cycles_run": ho.get("cycles_run", 0)},
            treatment_label="in_kernel",
            control_label="host_fallback"),
    }
    if shard_n:
        sh = sums["sharded"]
        hetero["shard_arm"] = {
            "shards": shard_n, "p99_ms": sh["p99_ms"],
            "completed": sh.get("completed", True)}
    return results, hetero


def _crossover(args, backend, record) -> tuple:
    """``--crossover``: every arm (the single-device serial control
    included) back to back inside each trial block → (summaries, the
    ``crossover`` block)."""
    arms = sorted({max(1, int(x))
                   for x in args.crossover.split(",") if x.strip()})
    runs = {n: [] for n in arms}
    for _ in range(max(1, args.trials)):
        for n_sh in arms:
            args.shards = 0 if n_sh == 1 else n_sh
            runs[n_sh].append(run_burst_path(args, backend, record))
            release()
    args.shards = 0
    sums = {n: summarize_trials(runs[n]) for n in arms}
    curve = []
    for n in arms:
        s = sums[n]
        entry = {
            "shards": n,
            "p50_ms": s["p50_ms"],
            "p99_ms": s["p99_ms"],
            "p99_ms_range": s["p99_ms_range"],
            "decisions_stable": s["decisions_stable"],
            "completed": s.get("completed", True),
            "cycles_run": s.get("cycles_run", 0),
        }
        if "elapsed_s" in s:
            entry["elapsed_s"] = s["elapsed_s"]
        if "trickle" in s:
            entry["trickle_rounds"] = s["trickle"]["rounds"]
            entry["trickle_rounds_requested"] = \
                s["trickle"]["rounds_requested"]
        bsh = s.get("burst_stats", {})
        if n > 1:
            entry["imbalance"] = shard_imbalance_report(bsh)
            entry["boundary_bytes_h2d"] = bsh.get(
                "burst_boundary_bytes_h2d", 0)
            entry["boundary_bytes_equiv"] = bsh.get(
                "burst_boundary_bytes_equiv", 0)
        curve.append(entry)
    # budget-cut runs stop at different cycles and are excluded from the
    # identity check, not from the curve
    crossover = {
        "arms": arms,
        "trials_per_arm": len(runs[arms[0]]),
        "curve": curve,
        "decisions_identical_across_arms": _identical(
            [r for n in arms for r in runs[n]]),
    }
    if args.budget_s:
        crossover["budget_s"] = args.budget_s
    sharded_sums = [sums[n] for n in arms if n > 1]
    if sharded_sums:
        crossover["sharded_completed_within_budget"] = all(
            s.get("completed", True) for s in sharded_sums)
    ctrl = sums.get(1)
    if ctrl is not None:
        crossover["control_p99_ms"] = ctrl["p99_ms"]
        crossover["control_completed"] = ctrl.get("completed", True)
        done_sharded = [s for s in sharded_sums if s.get("completed", True)]
        if done_sharded:
            best = min(done_sharded, key=lambda s: s["p99_ms"])
            crossover["best_sharded_shards"] = next(
                n for n in arms if n > 1 and sums[n] is best)
            crossover["best_sharded_p99_ms"] = best["p99_ms"]
            crossover["sharded_beats_serial_p99"] = (
                ctrl.get("completed", True)
                and best["p99_ms"] < ctrl["p99_ms"])
    return [sums[n] for n in arms], crossover


def _ab_shards(args, backend, record) -> tuple:
    """``--ab-shards``: N-shard and serial burst trials alternated →
    (summaries, the ``shard_compare`` block)."""
    runs = {0: [], args.ab_shards: []}
    for _ in range(max(1, args.trials)):
        for n_sh in (args.ab_shards, 0):
            args.shards = n_sh
            runs[n_sh].append(run_burst_path(args, backend, record))
            release()
    args.shards = 0
    sh_sum = summarize_trials(runs[args.ab_shards])
    se_sum = summarize_trials(runs[0])
    ref = runs[0][0]
    stable = all(
        (r["admitted"], r["preempted"], r["skipped"]) ==
        (ref["admitted"], ref["preempted"], ref["skipped"])
        for arm in runs.values() for r in arm)
    bsh = sh_sum["burst_stats"]
    shard_compare = {
        "shards": args.ab_shards,
        "decisions_stable": stable,   # across BOTH arms, all trials
        "trials_per_arm": len(runs[0]),
        "sharded_dispatches": bsh.get("burst_sharded_dispatches", 0),
        "shard_pack_s": [round(t, 4) for t in
                         bsh.get("burst_shard_pack_s", [])],
        "shard_fetch_s": [round(t, 4) for t in
                          bsh.get("burst_shard_fetch_s", [])],
        "p50_ms_sharded": sh_sum["p50_ms"],
        "p50_ms_serial": se_sum["p50_ms"],
        "p99_ms_sharded": sh_sum["p99_ms"],
        "p99_ms_serial": se_sum["p99_ms"],
    }
    return [sh_sum, se_sum], shard_compare


def _ab_pack(args, backend, record) -> list:
    """``--ab-pack``: delta-pack and full-repack serial trials alternated,
    with the pipelined delta-pack arm riding along → summaries
    (pipelined, delta serial, full-pack serial)."""
    args.no_pipeline = True
    if args.trickle == 0:
        args.trickle = 6
    runs = {False: [], True: []}
    piped = []
    for _ in range(max(1, args.trials)):
        for no_delta in (False, True):
            args.no_delta_pack = no_delta
            runs[no_delta].append(run_burst_path(args, backend, record))
            release()
        args.no_delta_pack = False
        args.no_pipeline = False
        piped.append(run_burst_path(args, backend, record))
        args.no_pipeline = True
        release()
    args.no_delta_pack = False
    args.no_pipeline = False
    return [summarize_trials(piped), summarize_trials(runs[False]),
            summarize_trials(runs[True])]


def _ab_pipeline(args, backend, record) -> list:
    """``--ab-pipeline``: pipelined and serial burst trials alternated."""
    runs = {False: [], True: []}
    for _ in range(max(1, args.trials)):
        for no_pipe in (False, True):
            args.no_pipeline = no_pipe
            runs[no_pipe].append(run_burst_path(args, backend, record))
            release()
    args.no_pipeline = False
    return [summarize_trials(runs[False]), summarize_trials(runs[True])]


def _boundary_compare(piped_r, serial_r) -> dict:
    """A serially packed window pays pack + blocking fetch at its
    boundary; an overlapped one only the residual speculative-fetch wait
    not hidden behind the previous window's apply loop."""
    bs_on, bs_off = piped_r["burst_stats"], serial_r["burst_stats"]

    def per_w(bs):
        return ((bs["burst_pack_s"] + bs["burst_dispatch_s"])
                / max(1, bs["burst_serial_windows"]))

    overlapped = max(1, bs_on["burst_overlapped_packs"])
    return {
        "serial_boundary_s_per_window": round(per_w(bs_off), 4),
        "pipelined_serial_boundary_s_per_window": round(per_w(bs_on), 4),
        "overlapped_windows": bs_on["burst_overlapped_packs"],
        "overlapped_boundary_s_per_window": round(
            bs_on["burst_spec_fetch_wait_s"] / overlapped, 4),
        "spec_cancelled": bs_on["burst_spec_cancelled"],
        "p50_ms_pipelined": piped_r["p50_ms"],
        "p50_ms_serial": serial_r["p50_ms"],
        "p99_ms_pipelined": piped_r["p99_ms"],
        "p99_ms_serial": serial_r["p99_ms"],
    }


def _pack_compare(delta_r, fullpack_r) -> dict:
    """A full-repack boundary re-walks every queue (burst_pack_s /
    packs); a delta boundary only the journal-dirty CQs (delta_pack_s
    per delta window) — decisions identical either way."""
    bs_on = delta_r["burst_stats"]
    bs_off = fullpack_r["burst_stats"]
    # the sparse-boundary (trickle) windows when both arms ran them:
    # uniform-churn boundaries are full-repack territory on both arms
    tr_on = delta_r.get("trickle")
    tr_off = fullpack_r.get("trickle")
    if (tr_on and tr_off and tr_on.get("burst_delta_packs")
            and tr_off.get("burst_packs")):
        full_per = tr_off["burst_pack_s"] / max(1, tr_off["burst_packs"])
        delta_per = (tr_on["delta_pack_s"]
                     / max(1, tr_on["burst_delta_packs"]))
        scope = "trickle-windows"
    else:
        full_per = bs_off["burst_pack_s"] / max(1, bs_off["burst_packs"])
        delta_per = (bs_on["delta_pack_s"]
                     / max(1, bs_on["burst_delta_packs"]))
        scope = "whole-run"
    return {
        "windows_scope": scope,
        "full_pack_s_per_window": round(full_per, 4),
        "delta_pack_s_per_window": round(delta_per, 4),
        "pack_cost_reduction_x": round(full_per / max(delta_per, 1e-9), 1),
        "delta_windows": bs_on["burst_delta_packs"],
        "full_fallbacks": bs_on["burst_full_packs"],
        "rows_reused": bs_on["rows_reused"],
        "rows_repacked": bs_on["rows_repacked"],
        "decisions_identical": (
            (delta_r["admitted"], delta_r["preempted"],
             delta_r["skipped"]) ==
            (fullpack_r["admitted"], fullpack_r["preempted"],
             fullpack_r["skipped"])),
        "p99_ms_delta": delta_r["p99_ms"],
        "p99_ms_fullpack": fullpack_r["p99_ms"],
    }


def tail_of(args, results, mesh: dict, *, shard_compare=None, hetero=None,
            crossover=None) -> dict:
    """The run's JSON tail from its arms' summaries: the blocks, one
    entry per arm (its obs aside), the comparisons, the headline value
    and the hard-path proof."""
    tail = {
        "metric": "northstar_e2e_cycle_p99",
        "unit": "ms",
        "cqs": args.cqs,
        "flavors": args.flavors, "resources": args.resources,
        "mesh": mesh,
    }
    if args.quick:
        tail["quick"] = True
    if shard_compare is not None:
        tail["shard_compare"] = shard_compare
    if hetero is not None:
        tail["hetero"] = hetero
    if crossover is not None:
        tail["crossover"] = crossover
        # the mesh block carries the widest sharded arm's imbalance
        for e in reversed(crossover["curve"]):
            if e.get("imbalance"):
                tail["mesh"]["shard_imbalance"] = e["imbalance"]
                break
    for r in results:
        tail[r["path"]] = {k: v for k, v in r.items()
                           if k not in ("path", "obs")}
    piped_r = next((r for r in results
                    if r["path"].startswith("burst-")
                    and "-serial" not in r["path"]
                    and "-fullpack" not in r["path"]), None)
    serial_r = next((r for r in results
                     if r["path"].endswith("-serial")), None)
    if piped_r is not None and serial_r is not None:
        tail["boundary_compare"] = _boundary_compare(piped_r, serial_r)
    # the pack A/B pairs the two serial arms; the pipelined arm, when
    # present, is the shipping configuration's headline
    delta_r = (next((r for r in results
                     if r["path"].endswith("-serial")), None)
               or next((r for r in results
                        if r["path"].startswith("burst-")
                        and not r["path"].endswith("-fullpack")), None))
    fullpack_r = next((r for r in results
                       if r["path"].endswith("-fullpack")), None)
    if delta_r is not None and fullpack_r is not None:
        tail["pack_compare"] = _pack_compare(delta_r, fullpack_r)
    host_r = next((r for r in results
                   if r["path"] in ("host", "fs-host")), None)
    solver_rs = [r for r in results
                 if r["path"] not in ("host", "fs-host")]
    if solver_rs:
        # a budget-cut run's partial p99 is the headline only when
        # nothing finished
        done_rs = [r for r in solver_rs if r.get("completed", True)]
        best = min(done_rs or solver_rs, key=lambda r: r["p99_ms"])
        tail["value"] = best["p99_ms"]
        tail["best_solver_path"] = best["path"]
        if host_r is not None:
            for r in solver_rs:
                tail[f"{r['path']}_beats_host_p50"] = (
                    r["p50_ms"] < host_r["p50_ms"])
                tail[f"{r['path']}_beats_host_p99"] = (
                    r["p99_ms"] < host_r["p99_ms"])
    else:
        tail["value"] = results[0]["p99_ms"]
    # the hard paths ran at scale (the FS variant's is the tournament)
    if args.fair_sharing:
        tail["hard_paths_exercised"] = all(
            r.get("fs_full_cycles", 1) > 0 or r["path"] == "fs-host"
            for r in results)
    else:
        # a budget-cut run may stop before the wave; only completed
        # runs owe the proof
        tail["hard_paths_exercised"] = all(
            r["preempted"] > 0 and r["skipped"] > 0 for r in results
            if r.get("completed", True))
    obs_by_path = {r["path"]: r["obs"] for r in results if r.get("obs")}
    if obs_by_path:
        tail["obs"] = obs_by_path.get(tail.get("best_solver_path"),
                                      next(iter(obs_by_path.values())))
    return tail


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cqs", type=int, default=1000)
    ap.add_argument("--wl", type=int, default=100_000)
    ap.add_argument("--cycles", type=int, default=30)
    ap.add_argument("--host", action="store_true",
                    help="run ONLY the host path")
    ap.add_argument("--device", action="store_true",
                    help="run ONLY the device path")
    ap.add_argument("--runtime", type=int, default=4)
    ap.add_argument("--flavors", type=int, default=1)
    ap.add_argument("--resources", type=int, default=1)
    ap.add_argument("--inject-at", type=int, default=-1,
                    help="cycle at which the preemptor wave arrives "
                         "(default cycles//3)")
    ap.add_argument("--burst", action="store_true",
                    help="run the fused multi-cycle burst path in place "
                         "of the per-cycle device path")
    ap.add_argument("--burst-backend", default="both",
                    choices=["both", "cpu", "accel"],
                    help="accel: the burst on a Driver on --torch-device; "
                         "cpu: on a Driver on the CPU; both: the two")
    ap.add_argument("--trials", type=int, default=3,
                    help="trials per path; the median (by p99) is "
                         "reported with min/max spread")
    ap.add_argument("--fair-sharing", action="store_true",
                    help="run the fair-sharing tournament variant "
                         "(uneven weights, borrowing contention) in "
                         "place of the preemption scenario")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the burst boundary pipeline (serial "
                         "pack+dispatch+apply) for A/B comparison")
    ap.add_argument("--ab-pipeline", action="store_true",
                    help="run pipelined and serial burst trials "
                         "INTERLEAVED in one process and report both "
                         "paths plus a boundary-cost comparison")
    ap.add_argument("--no-delta-pack", action="store_true",
                    help="disable the incremental delta pack "
                         "(KUEUE_BURST_DELTA_PACK=0): every window "
                         "boundary re-walks all queues")
    ap.add_argument("--ab-pack", action="store_true",
                    help="run delta-pack and full-repack burst trials "
                         "INTERLEAVED in one process and report both "
                         "paths plus a pack-cost comparison; forces "
                         "--no-pipeline on both arms so every window "
                         "boundary pays a host pack")
    ap.add_argument("--trickle", type=int, default=0,
                    help="after the main cycles, run N sparse-boundary "
                         "rounds (arrivals to ~10 CQs, one short window "
                         "each); --ab-pack defaults this to 6")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the burst window + FS/admit scans across "
                         "N devices (same as KUEUE_TPU_SHARDS=N; a "
                         "virtual mesh of the torch device past its "
                         "device count)")
    ap.add_argument("--ab-hetero", action="store_true",
                    help="heterogeneous A/B: the per-cycle device arm, "
                         "the fused burst arm (plus an --ab-shards arm "
                         "when set) INTERLEAVED with the host-walk "
                         "oracle; emits a 'hetero' block with fallback "
                         "counters and cross-arm decision identity")
    ap.add_argument("--ab-shards", type=int, default=0,
                    help="run serial and N-shard burst trials "
                         "INTERLEAVED in one process and report both "
                         "arms plus a shard_compare block with cross-arm "
                         "decision identity")
    ap.add_argument("--crossover", default=None,
                    help="comma list of shard counts (e.g. 1,2,4,8; 1 = "
                         "the single-device serial control) run "
                         "INTERLEAVED per trial block with a per-arm "
                         "crossover curve in the JSON tail")
    ap.add_argument("--budget-s", type=float, default=0.0,
                    help="per-trial wall budget in seconds; a run that "
                         "exhausts it stops at the next window boundary "
                         "and is recorded completed=false")
    ap.add_argument("--require-accel", action="store_true",
                    help="abort (exit 1) if no CUDA device is reachable")
    ap.add_argument("--quick", action="store_true",
                    help="seconds-level smoke sizing (wiring check, not "
                         "a perf number): caps cqs/wl/cycles and runs one "
                         "trial per arm")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def parse_args(argv=None):
    """The flags, with ``--quick``'s caps applied."""
    args = parser().parse_args(argv)
    if args.quick:
        args.cqs = min(args.cqs, 12)
        args.wl = min(args.wl, 240)
        args.cycles = min(args.cycles, 12)
        args.trials = 1
    return args


def mesh_width(args) -> int:
    """The most shards any flag names."""
    xover = max((int(p) for p in (args.crossover or "").split(",")
                 if p.strip()), default=0)
    return max(args.shards, args.ab_shards, xover)


def run(args, record: list | None = None) -> dict:
    """Every arm the flags ask for → the JSON tail.  ``record``, when
    given, receives each arm run's per-cycle decisions and their digest
    (``path``, ``decisions``, ``digest``)."""
    if args.require_accel:
        require_accel_or_die()
    dev = resolve_device(args.torch_device)
    args.torch_device = str(dev)
    n_dev = mesh_width(args)
    virtual = n_dev > 1 and (dev.type == "cpu"
                             or n_dev > torch.cuda.device_count())
    with contextlib.ExitStack() as stack:
        if virtual:
            from .parallel.sharded import virtual_mesh
            stack.enter_context(virtual_mesh(dev, n_dev))
        if args.shards > 1 and "KUEUE_TPU_SHARDS" not in os.environ:
            # production's route; restored when the run ends
            stack.enter_context(scenarios.shards_env(args.shards))
        return _run_arms(args, record, dev, virtual)


def _run_arms(args, record, dev, virtual: bool) -> dict:
    results = []
    shard_compare = crossover = hetero = None
    backend = "cpu" if args.burst_backend == "both" else args.burst_backend
    if args.burst and args.ab_hetero:
        # the per-cycle device arm, the fused burst and an optional
        # --ab-shards arm interleaved with the host-walk oracle;
        # decisions must agree across every completed arm
        shard_n = args.ab_shards if args.ab_shards > 1 else 0
        runs = {"in_kernel": [], "burst": [], "host": []}
        if shard_n:
            runs["sharded"] = []
        for _ in range(max(1, args.trials)):
            args.shards = 0
            runs["in_kernel"].append(run_path(args, True, record))
            release()
            runs["burst"].append(run_burst_path(args, backend, record))
            release()
            if shard_n:
                args.shards = shard_n
                runs["sharded"].append(run_burst_path(args, backend,
                                                      record))
                args.shards = 0
                release()
            runs["host"].append(run_path(args, False, record))
            release()
        part, hetero = hetero_block(args, runs)
        results.extend(part)
    elif args.burst and args.crossover:
        part, crossover = _crossover(args, backend, record)
        results.extend(part)
    elif args.burst and args.ab_shards > 1:
        part, shard_compare = _ab_shards(args, backend, record)
        results.extend(part)
    elif args.fair_sharing:
        results.append(with_trials(
            lambda: run_fs_path(args, True, record), args))
        if not args.device:
            results.append(with_trials(
                lambda: run_fs_path(args, False, record), args))
    elif args.burst and args.ab_pack:
        results.extend(_ab_pack(args, backend, record))
    elif args.burst and args.ab_pipeline:
        results.extend(_ab_pipeline(args, backend, record))
    elif args.burst:
        backends = (["cpu", "accel"] if args.burst_backend == "both"
                    else [args.burst_backend])
        for b in backends:
            results.append(with_trials(
                lambda b=b: run_burst_path(args, b, record), args))
    if not args.host and not args.burst and not args.fair_sharing:
        results.append(with_trials(
            lambda: run_path(args, True, record), args))
    if not args.device and not args.fair_sharing and not args.ab_hetero:
        results.append(with_trials(
            lambda: run_path(args, False, record), args))
    mesh_shards = max(args.shards, args.ab_shards,
                      (crossover or {}).get("arms", [0])[-1])
    return tail_of(args, results, mesh_info(mesh_shards, dev, virtual),
                   shard_compare=shard_compare, hetero=hetero,
                   crossover=crossover)


def main(argv=None) -> int:
    args = parse_args(argv)
    tail = run(args)
    print(json.dumps(tail))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tail, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
