"""OBS soak of the port: the telemetry plane is free, honest and dumpable
on the torch device (the JAX package's ``scripts/obs_soak.py``, every
flag and JSON key kept).

Runs the drain scenario (oversubscribed cohorts, WAL attached) through
two arms on identically-built Drivers, interleaved at *cycle*
granularity — cycle k runs on the untraced Driver and the traced Driver
back to back (order alternating per cycle), so every traced sample has a
time-adjacent untraced partner and machine drift cancels out of the A/B
— and publishes:

  decisions  — per-cycle decision digests and the final admitted set
               must be bit-identical between the arms and across every
               rep (tracing may not change a single decision);
  overhead   — traced vs untraced per-cycle wall p50 over the
               min-across-reps per cycle index; the ratio must hold the
               <= 5% guarantee;
  spans      — the traced arm's per-phase roster must cover every host
               hot-path phase (cycle, cycle.snapshot, cycle.nominate,
               cycle.admit, wal.append, wal.commit);
  dumps      — a programmatic flight-recorder dump whose digests match
               the recorded cycles, a SIGUSR2 state dump carrying the obs
               sections, and a non-empty Chrome trace.

    python -m kueue_tpu_torch.obs_soak [--cycles 16] [--reps 12] [--quick]
        [--out PATH] [--torch-device cuda|cpu]

The script's Drivers take the host path; these run the device solver on
``--torch-device`` (default ``cuda``: the admit kernels; ``cpu``: their
plain versions), so ``cycle.nominate`` holds the device solve and
``cycle.order`` (the host path's sort) is never entered — the roster is
held to the six host phases above.  Without a GPU and without
``--torch-device cpu`` the run raises.  Prints progress on stderr and the
JSON tail as the last line of stdout (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import os
import signal
import statistics
import sys
import time

from .api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    PreemptionPolicy,
    QueueingStrategy,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
)
from .controller.driver import Driver
from .debugger import Dumper
from .obs import trace as obs_trace
from .obs.flight import decision_digest
from .ops.solver import resolve_device
from .perf.validate import _OBS_HOST_PHASES as HOST_PHASES
from .scenarios import VirtualClock, log, soak_workload
from .utils.journal import CycleWAL


def build(n_cohorts: int, cqs: int, per_lq: int,
          device="cuda") -> tuple[Driver, VirtualClock]:
    """Fresh Driver per arm on ``device``, the device solver on:
    oversubscribed drain (quota-bound admissions against a deep
    backlog), runtime-driven finishes, BEST_EFFORT_FIFO — the chaos-soak
    shape."""
    clock = VirtualClock()
    d = Driver(clock=clock, use_device_solver=True, device=device)
    d.attach_wal(CycleWAL())
    d.apply_resource_flavor(ResourceFlavor(name="default"))
    n = 0
    for c in range(n_cohorts):
        for q in range(cqs):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(ClusterQueue(
                name=name, cohort=f"co-{c}",
                queueing_strategy=QueueingStrategy.BEST_EFFORT_FIFO,
                preemption=PreemptionPolicy(),
                resource_groups=[ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[FlavorQuotas(name="default", resources={
                        "cpu": ResourceQuota(nominal=4000)})])]))
            d.apply_local_queue(LocalQueue(name=f"lq-{c}-{q}",
                                           cluster_queue=name))
            for i in range(per_lq):
                n += 1
                d.create_workload(soak_workload(
                    f"w-{c}-{q}-{i}", f"lq-{c}-{q}", 1500,
                    prio=(i % 3) * 10, t=float(n)))
    return d, clock


def _drive(d, clock, out, c: int, runtime: int) -> float:
    """One harness cycle on one Driver: tick, schedule (timed), finish
    admissions whose modeled runtime elapsed (untimed)."""
    clock.t += 1.0
    t0 = time.perf_counter()
    stats = d.schedule_once()
    wall = time.perf_counter() - t0
    out.append(stats)
    if runtime > 0 and c - runtime >= 0:
        for key in out[c - runtime].admitted:
            wl = d.workloads.get(key)
            if wl is not None and wl.has_quota_reservation:
                d.finish_workload(key)
    return wall


def run_pair(cycles: int, runtime: int, shape: tuple[int, int, int],
             device="cuda"):
    """One rep: an untraced and a traced Driver advanced in lockstep,
    cycle k on both back to back (order alternating per cycle).  The
    process-global tracer is installed around the traced Driver's cycle
    only — its finishes included — and cleared for the untraced one, so
    the untraced arm never pays a single span."""
    obs_trace.clear()
    du, cu = build(*shape, device=device)
    dt, ct = build(*shape, device=device)
    tracer = dt.obs.enable_tracing()
    obs_trace.clear()
    outs = {"untraced": [], "traced": []}
    walls = {"untraced": [], "traced": []}
    arms = {"untraced": (du, cu, None), "traced": (dt, ct, tracer)}
    order = ("untraced", "traced")
    gc.collect()
    gc.disable()   # collector pauses land on whichever arm is running
    try:
        for c in range(cycles):
            for name in (order if c % 2 == 0 else order[::-1]):
                d, clock, tr = arms[name]
                obs_trace.install(tr)   # None = off for the untraced arm
                walls[name].append(_drive(d, clock, outs[name], c,
                                          runtime))
            obs_trace.clear()
    finally:
        gc.enable()
    return {
        "digests": {n: [decision_digest(s) for s in outs[n]]
                    for n in outs},
        "walls": walls,
        "admitted": {n: sorted(arms[n][0].admitted_keys()) for n in outs},
        "traced_driver": dt,
        "tracer": tracer,
    }


def sigusr2_dump(d) -> bool:
    """Fire a real SIGUSR2 at ourselves through debugger.Dumper and
    check the dump carries the obs sections."""
    buf = io.StringIO()
    old = signal.getsignal(signal.SIGUSR2)
    try:
        Dumper(d, out=buf).listen_for_signal()
        os.kill(os.getpid(), signal.SIGUSR2)
    finally:
        signal.signal(signal.SIGUSR2, old)
    text = buf.getvalue()
    return bool(text) and "flight" in text


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=16)
    ap.add_argument("--runtime", type=int, default=2,
                    help="modeled runtime (cycles) before finish")
    ap.add_argument("--reps", type=int, default=12,
                    help="lockstep untraced+traced rep pairs")
    ap.add_argument("--cohorts", type=int, default=4)
    ap.add_argument("--cqs-per-cohort", type=int, default=4)
    ap.add_argument("--per-lq", type=int, default=24)
    ap.add_argument("--quick", action="store_true",
                    help="fewer reps for a seconds-level pass")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def run(args) -> tuple[dict, bool]:
    """The warm-up rep, the measured reps, the roster and the dumps → (the
    JSON tail, whether every gate held)."""
    dev = resolve_device(args.torch_device)
    reps = 8 if args.quick else args.reps
    shape = (args.cohorts, args.cqs_per_cohort, args.per_lq)
    t_start = time.perf_counter()
    log(f"obs soak: cycles={args.cycles} reps={reps} shape={shape} "
        f"device={dev} (cycle-interleaved untraced/traced)")

    # warmup rep, discarded: first-touch costs (imports, caches,
    # allocator, the kernels' first launches) must not land on either
    # side of the A/B
    run_pair(args.cycles, args.runtime, shape, dev)
    gc.collect()

    pairs = []
    for rep in range(reps):
        p = run_pair(args.cycles, args.runtime, shape, dev)
        pairs.append(p)
        log(f"  rep {rep} admitted={len(p['admitted']['traced'])} "
            f"untraced_p50="
            f"{statistics.median(p['walls']['untraced']) * 1e3:.3f}ms "
            f"traced_p50="
            f"{statistics.median(p['walls']['traced']) * 1e3:.3f}ms")
        gc.collect()

    # --- bit-identity between arms and across every rep --------------
    ref_digests = pairs[0]["digests"]["untraced"]
    ref_admitted = pairs[0]["admitted"]["untraced"]
    decisions_identical = all(
        p["digests"][arm] == ref_digests
        and p["admitted"][arm] == ref_admitted
        for p in pairs for arm in ("untraced", "traced"))
    log(f"decisions {'bit-identical' if decisions_identical else 'DIVERGED'}"
        f" across {2 * reps} runs")

    # --- overhead: per-cycle wall p50 over min-across-reps -----------
    pool = {arm: [min(p["walls"][arm][k] for p in pairs)
                  for k in range(args.cycles)]
            for arm in ("untraced", "traced")}
    traced_p50_ms = statistics.median(pool["traced"]) * 1e3
    untraced_p50_ms = statistics.median(pool["untraced"]) * 1e3
    ratio = traced_p50_ms / untraced_p50_ms
    log(f"overhead: traced_p50={traced_p50_ms:.4f}ms "
        f"untraced_p50={untraced_p50_ms:.4f}ms ratio={ratio:.4f}")

    # --- roster + dumps from the last rep's traced driver ------------
    last = pairs[-1]
    d = last["traced_driver"]
    obs_trace.install(last["tracer"])   # dumps read the live tracer
    roster = last["tracer"].roster()
    missing = [p for p in obs_trace.HOT_PATH_PHASES
               if p in HOST_PHASES and p not in roster]

    dump = d.obs.flight.dump()
    traced_digests = last["digests"]["traced"]
    flight_ok = (dump["buffered"] == len(dump["cycles"])
                 and [c["digest"] for c in dump["cycles"]]
                 == traced_digests[-dump["buffered"]:]
                 # empty-head cycles open no spans; every deciding
                 # cycle must carry its span trail
                 and all(c["spans"] for c in dump["cycles"]
                         if c["admitted"] or c["preempting"]))
    sig_ok = sigusr2_dump(d)
    chrome = d.obs.spans_chrome_trace()
    obs_block = d.obs.report()
    spans_out = {p: {"count": row["count"],
                     "p50_ms": round(row["p50_ms"], 4),
                     "p99_ms": round(row["p99_ms"], 4),
                     "total_s": round(row["total_s"], 6)}
                 for p, row in roster.items()}
    obs_trace.clear()
    log(f"roster: {sorted(roster)}; flight_ok={flight_ok} "
        f"sigusr2_ok={sig_ok} chrome_events={len(chrome['traceEvents'])}")

    tail = {
        "metric": "obs_tracing_overhead_ratio",
        "unit": "traced / untraced per-cycle wall p50 (drift-fair A/B)",
        "cqs": args.cohorts * args.cqs_per_cohort,
        "cycles": args.cycles,
        "reps": reps,
        "quick": bool(args.quick),
        "control": {"arm": "untraced", "interleaved": True,
                    "reps": reps,
                    "cycle_wall_p50_ms": untraced_p50_ms},
        "decisions_identical": decisions_identical,
        "admitted_total": len(ref_admitted),
        "overhead": {"traced_p50_ms": traced_p50_ms,
                     "untraced_p50_ms": untraced_p50_ms,
                     "ratio": ratio},
        "spans": spans_out,
        "spans_missing_host_phases": missing,
        "dumps": {"flightrecorder_ok": flight_ok,
                  "sigusr2_ok": sig_ok,
                  "chrome_trace_events": len(chrome["traceEvents"])},
        "obs": obs_block,
        "value": ratio,
        "elapsed_s": round(time.perf_counter() - t_start, 2),
    }
    ok = (decisions_identical and ratio <= 1.05 and not missing
          and flight_ok and sig_ok and bool(chrome["traceEvents"]))
    return tail, ok


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    tail, ok = run(args)
    print(json.dumps(tail))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tail, f, indent=1)
            f.write("\n")
        log(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
