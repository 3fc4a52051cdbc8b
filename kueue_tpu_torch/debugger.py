"""State dump on signal (reference pkg/debugger: SIGUSR2 → dump queue
heads + cache usage to logs; queue/dumper.go).

Extended with the observability plane: when the driver carries an
``obs`` ObsPlane (it always does), the dump appends the in-flight
cycle, the flight-recorder tail (decision digests + span names), the
event-stream counts, and — when attached — WAL, arena, and federation
circuit state.  The same information is served as JSON from
``/debug/flightrecorder`` (visibility.VisibilityServer)."""

from __future__ import annotations

import signal
import sys
from typing import Optional, TextIO


def dump_state(driver, out: Optional[TextIO] = None,
               flight_tail: int = 8) -> str:
    """Render the queues + cache state (debugger.go:33 + dumper.go),
    plus the obs plane's flight recorder and subsystem state."""
    lines = []
    lines.append("=== kueue-tpu state dump ===")
    lines.append("-- pending queues --")
    for name in sorted(driver.cache.cluster_queue_names()):
        infos = driver.queues.pending_workloads_info(name)
        heads = ", ".join(i.obj.name for i in infos[:5])
        lines.append(f"  {name}: {len(infos)} pending"
                     + (f" (head: {heads})" if heads else ""))
    lines.append("-- cache usage --")
    for name in sorted(driver.cache.cluster_queue_names()):
        usage = driver.cache.usage(name)
        used = {f"{fr.flavor}/{fr.resource}": v
                for fr, v in sorted(usage.items()) if v}
        lines.append(f"  {name}: {used if used else '{}'}")
    lines.append("-- admitted workloads --")
    for key in sorted(driver.admitted_keys()):
        lines.append(f"  {key}")
    obs = getattr(driver, "obs", None)
    if obs is not None:
        lines.extend(_dump_obs(driver, obs, flight_tail))
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


def _dump_obs(driver, obs, flight_tail: int) -> list:
    """The obs-plane section: in-flight cycle, flight tail, events,
    tracer, and (when attached) WAL / arena / circuit state."""
    lines = []
    lines.append("-- in-flight cycle --")
    lines.append(f"  scheduling_cycle: {driver.scheduler.scheduling_cycle}")
    t = obs._tracer_view()
    if t is not None:
        open_now = t.open_spans()
        lines.append(f"  open spans: {open_now if open_now else '[]'}")
        lines.append(f"  spans finished: {t.finished_total}")
    lines.append(f"-- flight recorder (last {flight_tail} of "
                 f"{obs.flight.recorded_total}) --")
    for rec in list(obs.flight.ring)[-flight_tail:]:
        span_names = sorted({s.name for s in rec.spans})
        chaos = (f" chaos={rec.chaos_hits}" if rec.chaos_hits else "")
        lines.append(
            f"  cycle {rec.cycle}: digest={rec.digest}"
            f" admitted={len(rec.admitted)}"
            f" preempting={len(rec.preempting)}"
            f" evicted={len(rec.evicted)}"
            + (f" spans={span_names}" if span_names else "") + chaos)
    lines.append("-- events --")
    rep = obs.events.report()
    lines.append(f"  {rep['counts']} total={rep['total']}"
                 f" dropped={rep['dropped']}")
    wal = getattr(driver, "_wal", None)
    if wal is not None and hasattr(wal, "stats"):
        lines.append("-- wal --")
        lines.append(f"  {dict(wal.stats)}")
    solver = getattr(driver, "_burst_solver", None)
    if solver is not None:
        bs = solver.stats
        arena = {k: bs[k] for k in ("pack_arena_planes", "pack_arena_bytes",
                                    "pack_arena_used_bytes") if k in bs}
        if arena:
            lines.append("-- arena --")
            lines.append(f"  {arena}")
    # federation circuit state, when this driver manages workers
    ctl = getattr(driver, "multikueue", None)
    if ctl is not None and hasattr(ctl, "clusters"):
        lines.append("-- federation circuits --")
        for cname, cluster in sorted(ctl.clusters.items()):
            state = "active" if cluster.active else "lost"
            lines.append(f"  {cname}: {state}")
    return lines


class Dumper:
    """reference debugger.NewDumper(...).ListenForSignal."""

    def __init__(self, driver, out: Optional[TextIO] = None):
        self.driver = driver
        self.out = out or sys.stderr

    def listen_for_signal(self, signum: int = signal.SIGUSR2) -> None:
        signal.signal(signum, lambda s, f: dump_state(self.driver, self.out))
