"""Open-loop runner: arrival-driven load against ``Driver.schedule_once``.

Timeline semantics — the key to replayability: events carry *virtual*
timestamps from the arrival process, and cycle ``k`` runs at virtual
time ``(k+1)·dt`` after injecting every event with ``t <= (k+1)·dt``.
The driver's clock is a virtual clock stepped by the runner, and
workload ``creation_time`` is the event's virtual time, so every
scheduling decision is a pure function of the event stream — a
recorded stream replayed through ``ReplayStream`` reproduces the
per-cycle decisions bit for bit.  Wall-clock is measured *around* each
cycle and reported separately: virtual latency answers "does the
schedule keep up with the offered rate", wall cost answers "how fast
does the host run".

Saturation search: ``find_sustainable_rate`` binary-searches the
highest arrival rate whose p99 submit→admit latency (censored —
workloads still waiting at the horizon count at their current age)
meets the SLO.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.types import PodSet, Workload
from ..metrics import LATENCY_BUCKETS


@dataclass
class OpenLoopConfig:
    duration_s: float = 60.0        # virtual horizon (arrivals stop here)
    dt_s: float = 1.0               # virtual seconds per scheduling cycle
    slo_p99_s: float = 8.0          # p99 submit→admit SLO, virtual seconds
    wall_budget_s: Optional[float] = None  # stop early past this wall time
    sample_every: int = 8           # gauge-sampling cadence, cycles


@dataclass
class OpenLoopResult:
    rate_per_s: float = 0.0         # annotated by the caller
    cycles: int = 0
    submitted: int = 0
    admitted: int = 0
    cancelled: int = 0
    churned: int = 0
    remote_submitted: int = 0
    p50_latency_s: float = 0.0      # censored-inclusive, virtual seconds
    p99_latency_s: float = 0.0
    mean_latency_s: float = 0.0
    end_depth: int = 0              # pending (submitted − admitted − cancelled)
    max_depth: int = 0
    latency_hist: list = field(default_factory=list)  # [bucket_le, count]
    wall_s: float = 0.0
    cycle_wall_p50_ms: float = 0.0
    cycle_wall_p99_ms: float = 0.0
    admissions_per_wall_s: float = 0.0
    requeue_unparked: int = 0
    requeue_storm_peak: int = 0
    snap_cqs_recloned_per_cycle: float = 0.0
    snap_trees_reused_per_cycle: float = 0.0
    snap_full_rebuilds: int = 0
    truncated: bool = False         # wall budget hit before the horizon
    meets_slo: bool = False
    events: list = field(default_factory=list)        # consumed stream
    decisions: list = field(default_factory=list)     # per-cycle admits


def _pctile(xs: list, q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


class RateEWMA:
    """Exponentially-weighted arrival-rate estimator (events/s).

    The admission service (serving/service.py) updates it once per
    service step with the count of arrivals observed over that step's
    ``dt`` and reads ``rate_per_s`` when choosing the burst-window K
    online; ``halflife_s`` sets how fast the estimate tracks a
    diurnal/MMPP swing (after one halflife of steady traffic the old
    estimate contributes half the weight).  The first update primes the
    estimate directly so a cold start doesn't spend a halflife climbing
    from zero."""

    def __init__(self, halflife_s: float = 5.0):
        if halflife_s <= 0:
            raise ValueError("halflife_s must be positive")
        self.halflife_s = float(halflife_s)
        self.rate_per_s = 0.0
        self._primed = False

    def update(self, n_events: int, dt_s: float) -> float:
        if dt_s <= 0:
            return self.rate_per_s
        inst = n_events / dt_s
        if not self._primed:
            self.rate_per_s = inst
            self._primed = True
        else:
            a = 0.5 ** (dt_s / self.halflife_s)
            self.rate_per_s = a * self.rate_per_s + (1.0 - a) * inst
        return self.rate_per_s


def _next_or_none(it):
    try:
        return next(it)
    except StopIteration:
        return None


def run_open_loop(driver, clock, stream, cfg: OpenLoopConfig,
                  remote_client=None) -> OpenLoopResult:
    """Drive ``driver`` with ``stream``'s events for the virtual
    horizon.  ``clock`` is the driver's virtual clock (an object with a
    mutable ``t``); ``remote_client`` (remote.py WorkerClient) receives
    remote-flagged submissions — the MultiKueue path."""
    epoch = clock.t
    res = OpenLoopResult()
    waiting: dict[str, float] = {}       # key → virtual submit time
    runtime_of: dict[str, float] = {}
    finish_at: dict[int, list[str]] = {}
    latencies: list[float] = []
    hist = [0] * (len(LATENCY_BUCKETS) + 1)
    cycle_walls: list[float] = []
    n_cycles = max(1, int(round(cfg.duration_s / cfg.dt_s)))
    snap0 = dict(driver.cache.snapshot_stats)
    unparked0 = driver.queues.requeue_unparked_total
    prev_unparked = unparked0
    it = iter(stream)
    buf = _next_or_none(it)
    wall0 = time.perf_counter()

    def observe_latency(lat: float) -> None:
        latencies.append(lat)
        driver.metrics.open_loop_latency(lat)
        for i, b in enumerate(LATENCY_BUCKETS):
            if lat <= b:
                hist[i] += 1
                return
        hist[-1] += 1

    for k in range(n_cycles):
        t_k = (k + 1) * cfg.dt_s
        clock.t = epoch + t_k
        # service completions scheduled for this cycle
        for key in finish_at.pop(k, ()):
            wl = driver.workloads.get(key)
            if wl is not None and wl.has_quota_reservation \
                    and not wl.is_finished:
                driver.finish_workload(key)
        # inject every event due by this cycle's virtual time
        while buf is not None and buf.t <= t_k:
            ev = buf
            res.events.append(ev)
            if ev.kind == "submit":
                ns, name = ev.key.split("/", 1)
                wl = Workload(name=name, namespace=ns,
                              queue_name=f"lq-{ev.cq}",
                              priority=ev.priority,
                              creation_time=epoch + ev.t,
                              pod_sets=[PodSet(name="main", count=1,
                                               requests={"cpu": ev.cpu_m})])
                if ev.remote and remote_client is not None:
                    remote_client.create_workload(wl)
                    res.remote_submitted += 1
                else:
                    driver.create_workload(wl)
                waiting[ev.key] = ev.t
                runtime_of[ev.key] = ev.runtime_s
                res.submitted += 1
            elif ev.kind == "cancel":
                if waiting.pop(ev.key, None) is not None:
                    driver.delete_workload(ev.key)
                    res.cancelled += 1
            elif ev.kind == "priority":
                if ev.key in waiting:
                    wl = driver.workloads.get(ev.key)
                    if wl is not None and wl.admission is None:
                        wl.priority = ev.priority
                        driver.queues.add_or_update_workload(wl)
                        res.churned += 1
            buf = _next_or_none(it)
        w0 = time.perf_counter()
        stats = driver.schedule_once()
        cycle_walls.append(time.perf_counter() - w0)
        res.cycles = k + 1
        admitted_now = sorted(stats.admitted)
        res.decisions.append(admitted_now)
        for key in admitted_now:
            t_sub = waiting.pop(key, None)
            if t_sub is None:
                continue   # re-admission of an evicted workload
            res.admitted += 1
            observe_latency(t_k - t_sub)
            runtime = runtime_of.pop(key, cfg.dt_s)
            finish_at.setdefault(
                k + max(1, int(round(runtime / cfg.dt_s))), []).append(key)
        res.max_depth = max(res.max_depth, len(waiting))
        unparked = driver.queues.requeue_unparked_total
        if unparked > prev_unparked:
            driver.metrics.open_loop_requeue_storm(unparked - prev_unparked)
            prev_unparked = unparked
        if (k + 1) % cfg.sample_every == 0 or k + 1 == n_cycles:
            ages = [t_k - ts for ts in waiting.values()]
            wall = time.perf_counter() - wall0
            driver.metrics.open_loop_sample(
                depth_active=len(waiting),
                depth_parked=sum(
                    q.pending_inadmissible()
                    for n in list(driver.queues._timers)
                    if (q := driver.queues.queue_for(n)) is not None),
                age_p50_s=_pctile(ages, 0.50),
                age_p99_s=_pctile(ages, 0.99),
                admissions_per_s=res.admitted / wall if wall > 0 else 0.0)
        if cfg.wall_budget_s is not None \
                and time.perf_counter() - wall0 > cfg.wall_budget_s:
            res.truncated = True
            break

    res.wall_s = time.perf_counter() - wall0
    t_end = res.cycles * cfg.dt_s
    # censored tail: a workload still waiting at the horizon has latency
    # of AT LEAST its current age — excluding it would make a saturated
    # run look healthy
    censored = [t_end - ts for ts in waiting.values()]
    all_lat = latencies + censored
    res.p50_latency_s = _pctile(all_lat, 0.50)
    res.p99_latency_s = _pctile(all_lat, 0.99)
    res.mean_latency_s = (sum(all_lat) / len(all_lat)) if all_lat else 0.0
    res.end_depth = len(waiting)
    res.latency_hist = [[LATENCY_BUCKETS[i] if i < len(LATENCY_BUCKETS)
                         else None, c]
                        for i, c in enumerate(hist) if c]
    res.cycle_wall_p50_ms = _pctile(cycle_walls, 0.50) * 1000.0
    res.cycle_wall_p99_ms = _pctile(cycle_walls, 0.99) * 1000.0
    res.admissions_per_wall_s = (res.admitted / res.wall_s
                                 if res.wall_s > 0 else 0.0)
    res.requeue_unparked = driver.queues.requeue_unparked_total - unparked0
    res.requeue_storm_peak = driver.queues.requeue_storm_peak
    snap1 = driver.cache.snapshot_stats
    cyc = max(1, res.cycles)
    res.snap_cqs_recloned_per_cycle = (
        (snap1["snap_cqs_recloned"] - snap0["snap_cqs_recloned"]) / cyc)
    res.snap_trees_reused_per_cycle = (
        (snap1["snap_trees_reused"] - snap0["snap_trees_reused"]) / cyc)
    res.snap_full_rebuilds = snap1["snap_full"] - snap0["snap_full"]
    res.meets_slo = (not res.truncated
                     and res.p99_latency_s <= cfg.slo_p99_s)
    return res


def find_sustainable_rate(run_at_rate: Callable[[float], OpenLoopResult],
                          lo: float, hi: float, iters: int = 5
                          ) -> tuple[float, list[OpenLoopResult]]:
    """Binary-search the highest sustainable arrival rate in [lo, hi].

    ``run_at_rate(rate)`` must build a fresh driver + stream and return
    its OpenLoopResult (with ``meets_slo`` set).  ``lo`` is assumed
    sustainable (probe it first and pass a lower lo if not); returns
    ``(best_rate, probes)`` where best_rate is the largest probed rate
    that met the SLO (lo if none did)."""
    probes: list[OpenLoopResult] = []
    best = lo
    r_lo, r_hi = lo, hi
    for _ in range(iters):
        mid = 0.5 * (r_lo + r_hi)
        r = run_at_rate(mid)
        r.rate_per_s = mid
        probes.append(r)
        if r.meets_slo:
            best = mid
            r_lo = mid
        else:
            r_hi = mid
    return best, probes
