"""Generator-config replay + rangespec checker.

Reads the reference's generator-config YAML shape
(test/performance/scheduler/default_generator_config.yaml: cohort classes
→ queue sets → workload sets with creationIntervalMs/runtimeMs/priority/
request) and replays it against a Driver in an event-driven virtual
timeline: arrivals at their creation intervals, fake execution finishing
each admitted workload runtimeMs after admission (the reference runner
flips conditions the same way — runner/controller/controller.go:113).

Collected stats mirror the reference rangespec
(default_rangespec.yaml): wall time, process CPU (mCPU), max RSS,
per-workload-class average time to admission (virtual ms), and per-CQ
class minimum time-averaged usage.  ``check_rangespec`` asserts them.

Run: ``python -m kueue_tpu_torch.perf.harness <generator.yaml> [rangespec.yaml]``
(on the CUDA card; ``run_scenario(..., device="cpu")`` replays on the
CPU with the kernels' plain versions)
"""

from __future__ import annotations

import heapq
import sys
import time
from dataclasses import dataclass, field

from ..api.types import (
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
from ..controller.driver import Driver

UNIT = 1000  # 1 generator "request" unit = 1 CPU


def load_generator_config(path: str) -> list[dict]:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


@dataclass
class PerfStats:
    wall_ms: float = 0.0
    virtual_ms: float = 0.0
    cpu_mcpu: float = 0.0         # cpu_s per arrival-schedule second
    cpu_mcpu_replay: float = 0.0  # cpu_s per compressed replay second
    maxrss_kb: float = 0.0
    total_workloads: int = 0
    admitted: int = 0
    finished: int = 0
    # workload class → average time-to-admission (virtual ms)
    avg_time_to_admission_ms: dict[str, float] = field(default_factory=dict)
    # cq class → minimum (across CQs) time-averaged usage percent
    min_avg_usage_pct: dict[str, float] = field(default_factory=dict)


class _Clock:
    def __init__(self):
        self.t = 0.0  # seconds

    def __call__(self):
        return self.t


def run_scenario(config: list[dict], driver: Driver | None = None, *,
                 device: str = "cuda") -> PerfStats:
    import resource

    clock = _Clock()
    d = driver or Driver(clock=clock, device=device)
    d.apply_resource_flavor(ResourceFlavor(name="default"))

    # --- build cohorts/CQs and the arrival schedule -------------------
    arrivals: list[tuple[float, int, Workload, str]] = []  # (ms, seq, wl, class)
    cq_class_members: dict[str, list[tuple[str, int]]] = {}  # class → [(cq, nominal)]
    runtime_ms: dict[str, float] = {}
    wl_class: dict[str, str] = {}
    seq = 0
    for ci, cohort_cls in enumerate(config):
        for cn in range(cohort_cls.get("count", 1)):
            cohort = f"{cohort_cls.get('className', 'cohort')}-{ci}-{cn}"
            for qi, qs in enumerate(cohort_cls.get("queuesSets", [])):
                for qn in range(qs.get("count", 1)):
                    cq_name = f"{cohort}-{qs.get('className', 'cq')}-{qi}-{qn}"
                    nominal = qs.get("nominalQuota", 0) * UNIT
                    blimit = qs.get("borrowingLimit")
                    d.apply_cluster_queue(ClusterQueue(
                        name=cq_name, cohort=cohort,
                        preemption=PreemptionPolicy(
                            reclaim_within_cohort=ReclaimWithinCohort(
                                qs.get("reclaimWithinCohort", "Never")),
                            within_cluster_queue=WithinClusterQueue(
                                qs.get("withinClusterQueue", "Never"))),
                        resource_groups=[ResourceGroup(
                            covered_resources=["cpu"],
                            flavors=[FlavorQuotas(name="default", resources={
                                "cpu": ResourceQuota(
                                    nominal=nominal,
                                    borrowing_limit=(blimit * UNIT
                                                     if blimit else None))})])]))
                    lq_name = f"lq-{cq_name}"
                    d.apply_local_queue(LocalQueue(name=lq_name,
                                                   cluster_queue=cq_name))
                    cq_class_members.setdefault(
                        qs.get("className", "cq"), []).append(
                            (cq_name, nominal))
                    for wsi, ws in enumerate(qs.get("workloadsSets", [])):
                        interval = ws.get("creationIntervalMs", 100)
                        for k in range(ws.get("count", 0)):
                            t_ms = (k + 1) * interval
                            for wli, wcfg in enumerate(ws.get("workloads", [])):
                                cls = wcfg.get("className", f"class-{wli}")
                                name = (f"{cls}-{cq_name}-{wsi}-{k}")
                                wl = Workload(
                                    name=name, queue_name=lq_name,
                                    priority=wcfg.get("priority", 0),
                                    creation_time=t_ms / 1000.0,
                                    pod_sets=[PodSet(
                                        name="main", count=1,
                                        requests={"cpu": wcfg.get(
                                            "request", 1) * UNIT})])
                                runtime_ms[wl.key] = wcfg.get("runtimeMs", 0)
                                wl_class[wl.key] = cls
                                seq += 1
                                arrivals.append((t_ms, seq, wl, cls))
    heapq.heapify(arrivals)

    # --- event loop ---------------------------------------------------
    stats = PerfStats(total_workloads=len(arrivals))
    finishes: list[tuple[float, str]] = []   # (ms, key)
    admission_time: dict[str, float] = {}
    adm_sum: dict[str, float] = {}
    adm_count: dict[str, int] = {}
    usage_integral: dict[str, float] = {}    # cq → ∫ usage/nominal dt
    last_t = 0.0

    cpu0 = time.process_time()
    wall0 = time.perf_counter()

    def integrate_usage(now_ms: float) -> None:
        nonlocal last_t
        dt = now_ms - last_t
        if dt <= 0:
            return
        for members in cq_class_members.values():
            for cq_name, nominal in members:
                if nominal <= 0:
                    continue
                used = sum(v for fr, v in d.cache.usage(cq_name).items()
                           if fr.resource == "cpu")
                usage_integral[cq_name] = (
                    usage_integral.get(cq_name, 0.0)
                    + min(1.0, used / nominal) * dt)
        last_t = now_ms

    def pump(now_ms: float) -> None:
        clock.t = now_ms / 1000.0
        while True:
            cycle_stats = d.schedule_once()
            if not cycle_stats.admitted and not cycle_stats.preempted_targets:
                break
            for key in cycle_stats.admitted:
                if key not in admission_time:
                    admission_time[key] = now_ms
                    cls = wl_class[key]
                    created = d.workloads[key].creation_time * 1000.0
                    adm_sum[cls] = adm_sum.get(cls, 0.0) + now_ms - created
                    adm_count[cls] = adm_count.get(cls, 0) + 1
                    stats.admitted += 1
                heapq.heappush(finishes,
                               (now_ms + runtime_ms.get(key, 0), key))

    while arrivals or finishes:
        next_arr = arrivals[0][0] if arrivals else float("inf")
        next_fin = finishes[0][0] if finishes else float("inf")
        now_ms = min(next_arr, next_fin)
        integrate_usage(now_ms)
        while arrivals and arrivals[0][0] <= now_ms:
            _, _, wl, cls = heapq.heappop(arrivals)
            d.create_workload(wl)
        while finishes and finishes[0][0] <= now_ms:
            _, key = heapq.heappop(finishes)
            wl = d.workloads.get(key)
            if wl is None or not wl.has_quota_reservation:
                # evicted meanwhile; it will be re-admitted and re-queued
                admission_time.pop(key, None)
                continue
            d.finish_workload(key)
            stats.finished += 1
        pump(now_ms)

    stats.virtual_ms = last_t
    stats.wall_ms = (time.perf_counter() - wall0) * 1000.0
    cpu_s = time.process_time() - cpu0
    # Two CPU figures, because the reference's 396-535 mCPU is measured
    # over an ARRIVAL-PACED run (wall ~= the generator schedule, the
    # process mostly idle between events).  The comparable number for a
    # virtual-time replay is cpu seconds per SCHEDULE second — what the
    # process would consume if arrivals were paced in real time (the
    # work is identical; only the idle gaps are compressed).  The replay
    # figure divides by compressed wall time and is ~1000 mCPU for any
    # CPU-bound replay by construction.  Degenerate all-at-t0 schedules
    # (virtual_ms ~ 0) fall back to the wall denominator.
    denom_s = max(stats.virtual_ms, stats.wall_ms) / 1000.0
    stats.cpu_mcpu = cpu_s / max(denom_s, 1e-9) * 1000.0
    stats.cpu_mcpu_replay = (
        cpu_s / max(stats.wall_ms / 1000.0, 1e-9)) * 1000.0
    stats.maxrss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for cls, total in adm_sum.items():
        stats.avg_time_to_admission_ms[cls] = total / adm_count[cls]
    for cls, members in cq_class_members.items():
        pcts = [100.0 * usage_integral.get(cq, 0.0) / max(last_t, 1e-9)
                for cq, _ in members]
        stats.min_avg_usage_pct[cls] = min(pcts) if pcts else 0.0
    return stats


def require_accel_or_die() -> None:
    """Required-mode chip check for the bench entrypoints: with
    ``--require-accel`` (or ``KUEUE_TPU_REQUIRE_ACCEL=1``) an
    unreachable accelerator aborts the run instead of silently
    producing CPU-only numbers.  Also exports the env var so
    subprocess-based checks (tests/test_accel_route.py) FAIL rather
    than skip for the rest of the run."""
    import os
    os.environ["KUEUE_TPU_REQUIRE_ACCEL"] = "1"
    import torch
    accel = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not accel:
        raise SystemExit(
            "--require-accel: no accelerator platform reachable "
            "(devices: ['cpu'])")
    print(f"require-accel: {accel} cuda device(s)",
          file=sys.stderr)


def burst_boundary_report(bstats: dict) -> dict:
    """Summarize the burst-boundary pipeline from BurstSolver.stats:
    how many window boundaries overlapped pack+dispatch with the
    previous apply (the cost the two-slot pipeline removes from the
    first cycle of each window), how many speculations were discarded,
    and how many windows fell back to the serial pack."""
    spec = bstats.get("burst_spec_dispatches", 0)
    overlapped = bstats.get("burst_overlapped_packs", 0)
    cancelled = bstats.get("burst_spec_cancelled", 0)
    serial = bstats.get("burst_serial_windows", 0)
    packs = bstats.get("burst_packs", 0)
    return {
        "overlapped_packs": overlapped,
        "spec_dispatches": spec,
        "spec_cancelled": cancelled,
        "serial_windows": serial,
        # pack cost paid serially (per serial window) vs absorbed into
        # the previous window's apply phase (per overlapped window)
        "serial_pack_s": round(bstats.get("burst_pack_s", 0.0), 4),
        "boundary_overlap_share": round(
            overlapped / max(1, overlapped + packs), 3),
        "spec_fetch_wait_s": round(
            bstats.get("burst_spec_fetch_wait_s", 0.0), 4),
        "target_divergences": bstats.get("burst_target_divergences", 0),
        # incremental delta-pack (ops/burst.pack_burst_cached): windows
        # whose boundary re-walked only journal-dirty CQs vs counted
        # full-repack fallbacks, and the row-level reuse they bought
        "delta_packs": bstats.get("burst_delta_packs", 0),
        "full_packs": bstats.get("burst_full_packs", 0),
        "rows_reused": bstats.get("rows_reused", 0),
        "rows_repacked": bstats.get("rows_repacked", 0),
        "delta_pack_s": round(bstats.get("delta_pack_s", 0.0), 4),
        # shard-resident boundary: fresh packs that reused the on-mesh
        # row planes (scattering only dirty rows, coalesced into
        # ranges) vs full re-uploads, and the host→device bytes the
        # residency actually paid vs the upload-everything equivalent
        "resident_hits": bstats.get("burst_resident_hits", 0),
        "resident_misses": bstats.get("burst_resident_misses", 0),
        "resident_scatter_rows": bstats.get(
            "burst_resident_scatter_rows", 0),
        "resident_scatter_ranges": bstats.get(
            "burst_resident_scatter_ranges", 0),
        "journal_dirty_ranges": bstats.get(
            "burst_journal_dirty_ranges", 0),
        "boundary_bytes_h2d": bstats.get("burst_boundary_bytes_h2d", 0),
        "boundary_bytes_equiv": bstats.get(
            "burst_boundary_bytes_equiv", 0),
    }


def shard_imbalance_report(bstats: dict) -> dict:
    """The artifact mesh block's shard-imbalance counters: how the
    cost-balanced forest partition spread measured cycle cost across
    shards (max/mean ratio; 1.0 = perfectly even), the per-shard fetch
    waits the boundary pays, and the shard-resident reuse counters."""
    cost = bstats.get("burst_shard_cost")
    return {
        "layout_rebuilds": bstats.get("burst_layout_rebuilds", 0),
        "layouts_cost_balanced": bstats.get(
            "burst_layout_cost_balanced", 0),
        "forest_cost_max_mean_ratio": bstats.get(
            "burst_shard_cost_ratio", 0.0),
        "shard_cost": list(cost) if cost else [],
        "shard_fetch_wait_s": [
            round(x, 4) for x in bstats.get("burst_shard_fetch_s", [])],
        "shard_pack_s": [
            round(x, 4) for x in bstats.get("burst_shard_pack_s", [])],
        "resident_hits": bstats.get("burst_resident_hits", 0),
        "resident_misses": bstats.get("burst_resident_misses", 0),
    }


def chaos_report(injector=None, bstats: dict | None = None,
                 wal=None) -> dict:
    """The ``chaos`` block stamped into artifacts: which faults were
    armed and fired (seed included, so the scenario replays), what the
    solver's degradation counters recorded, and how much of the WAL a
    recovery had to roll forward."""
    out: dict = {}
    if injector is not None:
        out.update(injector.report())
    if bstats is not None:
        out["degradations"] = {
            "shard_degradations": bstats.get("burst_shard_degradations", 0),
            "shard_serial_fallbacks": bstats.get(
                "burst_shard_serial_fallbacks", 0),
            "chaos_divergences": bstats.get("burst_chaos_divergences", 0),
            "spec_cancelled": bstats.get("burst_spec_cancelled", 0),
        }
    if wal is not None:
        out["wal"] = {"batches": len(wal.batches),
                      "tail_ops": len(wal.tail),
                      "path": wal.path}
    return out


class MissingControlArm(ValueError):
    """An A/B block was requested without an interleaved control arm."""


# Host-fallback visibility for published A/B arms: any of these present
# in an arm's solver/burst stat blocks is copied into the block's
# environment_drift record, so a "device wins" artifact also proves how
# much of the arm actually ran on the device.
_FALLBACK_KEYS = ("host_cycles", "scalar_heads", "resume_heads",
                  "walk_stop_heads", "native_ff_fallbacks",
                  "burst_dirty_cycles", "burst_dirty_preempt",
                  "burst_dirty_scalar", "burst_dirty_resume",
                  "burst_suppressed_cycles",
                  # streaming-pack visibility: an arm claiming
                  # O(arrivals + dirty) host cost must show how many
                  # windows actually streamed vs fell back to full walks
                  "stream_packs", "stream_full_packs",
                  "stream_pack_bails", "pack_row_patches",
                  "pack_rank_patches", "pack_tighten_bytes_saved")


def _fallback_counters(arm: dict) -> dict:
    out: dict = {}
    for src_key in ("solver_stats", "flavor_walk", "burst_stats", "pack"):
        src = arm.get(src_key)
        if isinstance(src, dict):
            for k in _FALLBACK_KEYS:
                if k in src:
                    out[k] = src[k]
    for k in _FALLBACK_KEYS:       # counters may also sit at top level
        if k in arm:
            out[k] = arm[k]
    return out


def ab_block(treatment: dict, control: dict | None, *,
             treatment_label: str = "treatment",
             control_label: str = "control") -> dict:
    """Environment-drift bookkeeping for published artifacts: every A/B
    comparison must carry its own same-box control, measured
    *interleaved* with the treatment (control, treatment, control, …)
    so thermal/noisy-neighbor drift shows up as control variance
    instead of silently biasing the delta.  Refuses to build the block
    otherwise — a treatment-only number is not publishable."""
    if not control:
        raise MissingControlArm(
            "refusing to emit an A/B block without a control arm — "
            "measure an interleaved same-box control alongside the "
            "treatment")
    if not control.get("interleaved"):
        raise MissingControlArm(
            "control arm is not marked interleaved=True — a control "
            "measured before/after the treatment (not interleaved with "
            "it) does not bound environment drift")
    return {treatment_label: dict(treatment),
            control_label: dict(control),
            "environment_drift": {
                "interleaved": True,
                "fallback_counters": {
                    treatment_label: _fallback_counters(treatment),
                    control_label: _fallback_counters(control)}}}


def check_rangespec(stats: PerfStats, rangespec: dict) -> list[str]:
    """reference test/performance/scheduler checker semantics."""
    failures = []
    cmd = rangespec.get("cmd", {})
    if "maxWallMs" in cmd and stats.wall_ms > cmd["maxWallMs"]:
        failures.append(f"wall {stats.wall_ms:.0f}ms > {cmd['maxWallMs']}ms")
    if "mCPU" in cmd and stats.cpu_mcpu > cmd["mCPU"]:
        # vs the arrival schedule (see run()): directly comparable to
        # the reference's paced-run measurement, no headroom needed
        failures.append(f"cpu {stats.cpu_mcpu:.0f}mCPU > {cmd['mCPU']}")
    if "maxrss" in cmd and stats.maxrss_kb > cmd["maxrss"]:
        failures.append(f"rss {stats.maxrss_kb:.0f}KB > {cmd['maxrss']}KB")
    for cls, floor in (rangespec.get("clusterQueueClassesMinUsage")
                       or {}).items():
        got = stats.min_avg_usage_pct.get(cls, 0.0)
        if got < floor:
            failures.append(f"usage[{cls}] {got:.1f}% < {floor}%")
    for cls, cap in (rangespec.get("wlClassesMaxAvgTimeToAdmissionMs")
                     or {}).items():
        got = stats.avg_time_to_admission_ms.get(cls)
        if got is None:
            failures.append(f"timeToAdmission[{cls}]: no admissions")
        elif got > cap:
            failures.append(f"timeToAdmission[{cls}] {got:.0f}ms > {cap}ms")
    return failures


def main(argv: list[str]) -> int:
    import json
    import yaml
    config = load_generator_config(argv[0])
    stats = run_scenario(config)
    print(json.dumps({
        "wall_ms": round(stats.wall_ms, 1),
        "virtual_ms": round(stats.virtual_ms, 1),
        "cpu_mcpu": round(stats.cpu_mcpu, 1),
        "cpu_mcpu_replay": round(stats.cpu_mcpu_replay, 1),
        "maxrss_kb": stats.maxrss_kb,
        "workloads": stats.total_workloads,
        "finished": stats.finished,
        "avg_time_to_admission_ms": {
            k: round(v, 1)
            for k, v in sorted(stats.avg_time_to_admission_ms.items())},
        "min_avg_usage_pct": {
            k: round(v, 1)
            for k, v in sorted(stats.min_avg_usage_pct.items())},
    }, indent=1))
    if len(argv) > 1:
        with open(argv[1]) as f:
            rangespec = yaml.safe_load(f)
        failures = check_rangespec(stats, rangespec)
        for f_ in failures:
            print(f"RANGESPEC FAIL: {f_}", file=sys.stderr)
        return 1 if failures else 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
