"""Chaos soak of the port: seeded crash / recover / degrade scenarios at
1,000 CQs on the torch device (the JAX package's
``scripts/chaos_soak.py``, every flag, scenario and JSON key kept).

Every scenario runs two arms from identically-built Drivers:

  control — fault-free, per-cycle path (schedule_once + the harness
            finish contract);
  chaos   — the same cluster with a seeded ChaosInjector armed, a
            write-ahead cycle journal attached, and (for the crash
            scenarios) a full kill + ``Driver.recover_from`` rebuild.

A scenario passes only if the recovered / degraded arm's per-cycle
decisions AND its final workload state (admissions, conditions, check
states, requeue backoffs, timestamps included) are bit-identical to the
control arm (``decisions_stable``): a crash between cycles, a crash with
the admit op journaled but unapplied, a crash inside a fused burst
window, a forced speculation divergence, an 8→4→1 shard-loss cascade,
pack-journal corruption, and a partitioned MultiKueue transport.

    python -m kueue_tpu_torch.chaos_soak [--cqs 1000] [--devices 8]
        [--seed N] [--quick] [--only a,b] [--out PATH]
        [--torch-device cuda|cpu]

The Drivers run on ``--torch-device`` (default ``cuda``: the CUDA
kernels; ``cpu``: their plain versions); without a GPU and without
``--torch-device cpu`` the run raises.  The cascade runs on
``--devices`` cards when that many are present, else on a virtual mesh
of ``--devices`` copies of the torch device
(``parallel.sharded.virtual_mesh``; the ``mesh`` block then says
``"virtual": true``), and on the Driver's device where the script pins
a CPU burst.  The base seed comes from ``--seed`` or
KUEUE_TPU_CHAOS_SEED (default 1009); scenario i uses seed+i.  Prints
per-scenario progress on stderr and the JSON tail as the last line of
stdout (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time

import torch

from . import scenarios
from .api import types as api_types
from .chaos import injector as chaos
from .chaos.injector import ChaosInjector, InjectedCrash
from .controller.driver import Driver
from .features import env_value
from .federation.sim import full_state
from .northstar import mesh_info
from .ops.burst import BurstSolver
from .ops.solver import resolve_device
from .parallel import sharded
from .perf.harness import chaos_report
from .remote import ChaosWorkerClient, LocalWorkerClient, state_digest
from .scenarios import VirtualClock, log
from .scenarios import soak_workload as mk
from .utils.journal import CycleWAL


# ---------------------------------------------------------------------------
# Cluster builders (deterministic: same args -> same driver, always)
# ---------------------------------------------------------------------------

def cluster_spec(n_cqs):
    """n_cqs ClusterQueues in cohorts of 4, 4000m cpu nominal each,
    BEST_EFFORT_FIFO (a skip parks instead of blocking, so a crash that
    re-wakes parked workloads cannot change the admission order)."""
    def fn(d):
        scenarios.soak_cluster(api_types, d, n_cqs)
    return fn


def workload_spec(n_cqs, per_cq):
    """per_cq pending 1500m workloads per CQ (2 concurrent slots each):
    more pending than quota, runtime-driven finishes feed re-admission."""
    def fn(d):
        cluster_spec(n_cqs)(d)
        n = 0
        for q in range(n_cqs):
            for i in range(per_cq):
                n += 1
                d.create_workload(mk(f"w-{q}-{i}", f"lq-{q}", 1500,
                                     prio=(i % 3) * 10, t=float(n)))
    return fn


def build(spec_fn, device):
    clock = VirtualClock()
    d = Driver(clock=clock, use_device_solver=True, device=device)
    spec_fn(d)
    return d, clock


# ---------------------------------------------------------------------------
# Run / resume / recover plumbing
# ---------------------------------------------------------------------------

def resume_host(d, clock, cycles, runtime, out, tick_first=True):
    """Continue the per-cycle harness loop from ``len(out)`` completed
    cycles.  ``tick_first=False`` re-runs a cycle whose clock tick was
    already consumed before the crash."""
    while len(out) < cycles:
        c = len(out)
        if tick_first:
            clock.t += 1.0
        tick_first = True
        stats = d.schedule_once()
        out.append(stats)
        if runtime > 0 and c - runtime >= 0:
            for key in out[c - runtime].admitted:
                w = d.workloads.get(key)
                if w is not None and w.has_quota_reservation:
                    d.finish_workload(key)
    return out


def run_host(d, clock, cycles, runtime):
    return resume_host(d, clock, cycles, runtime, [])


def run_host_until_crash(d, clock, cycles, runtime):
    out = []
    try:
        resume_host(d, clock, cycles, runtime, out)
    except InjectedCrash as e:
        return out, str(e)
    return out, None


def run_burst_until_crash(d, clock, cycles, runtime, pipeline=None):
    """schedule_burst that surfaces an injected crash, collecting each
    applied cycle's record through on_cycle (the burst's own return
    value is lost when the exception unwinds)."""
    recs = []

    def on_cycle_start(_k):
        clock.t += 1.0

    def on_cycle(_k, stats):
        recs.append(stats)

    try:
        d.schedule_burst(cycles, runtime=runtime,
                         on_cycle_start=on_cycle_start, on_cycle=on_cycle,
                         pipeline=pipeline)
    except InjectedCrash as e:
        return recs, str(e)
    return recs, None


def run_burst(d, clock, cycles, runtime, pipeline=None):
    def on_cycle_start(_k):
        clock.t += 1.0
    return d.schedule_burst(cycles, runtime=runtime,
                            on_cycle_start=on_cycle_start,
                            pipeline=pipeline)


def recover(n_cqs, crashed, wal):
    """Discard the crashed driver, rebuild from its durable store + WAL
    tail on the same device — same clock object so time stays aligned
    with the control; nothing of the dead Driver's device state (its
    solver, burst pipeline, resident planes) is handed over."""
    d2 = Driver(clock=crashed.clock, use_device_solver=True,
                device=crashed.device)
    cluster_spec(n_cqs)(d2)
    replayed = d2.recover_from(crashed.workloads.values(), wal)
    return d2, replayed


class Checker:
    """Collects parity failures instead of raising, so one divergent
    scenario still yields a complete artifact."""

    def __init__(self):
        self.failures: list[str] = []

    def check(self, ok, msg):
        if not ok:
            self.failures.append(msg)
        return bool(ok)

    def prefix(self, got, want, label):
        for k, (x, y) in enumerate(zip(got, want)):
            if sorted(x.admitted) != sorted(y.admitted):
                self.failures.append(
                    f"{label} cycle {k}: admitted diverged "
                    f"({len(x.admitted)} vs {len(y.admitted)})")
                return
        for k, s in enumerate(want[len(got):]):
            if s.admitted or s.skipped or s.inadmissible or s.preempting:
                self.failures.append(
                    f"{label}: ended at cycle {len(got)} while control "
                    f"still active at {len(got) + k}")
                return

    def final(self, da, db, label):
        self.check(da.admitted_keys() == db.admitted_keys(),
                   f"{label}: final admitted sets differ")
        self.check(full_state(da) == full_state(db),
                   f"{label}: final workload state not bit-identical")


# ---------------------------------------------------------------------------
# Scenarios.  Each returns the artifact block for its name; every one
# compares a faulted arm against the fault-free control built above.
# ---------------------------------------------------------------------------

def _drain(cfg):
    return cfg["cqs"], cfg["drain_per_cq"], cfg["drain_cycles"], \
        cfg["runtime"]


def _sustained(cfg):
    return cfg["cqs"], cfg["sustained_per_cq"], cfg["sustained_cycles"], \
        cfg["runtime"]


def scenario_boundary_crash(cfg, seed, wal_path, device="cuda"):
    """Driver dies entering a cycle: tick consumed, nothing decided,
    WAL tail empty.  Recovery re-runs the cycle."""
    n, per, cycles, runtime = _drain(cfg)
    spec = workload_spec(n, per)
    dc, cc = build(spec, device)
    control = run_host(dc, cc, cycles, runtime)

    d1, c1 = build(spec, device)
    wal = CycleWAL(wal_path)
    d1.attach_wal(wal)
    chaos.install(ChaosInjector(seed=seed)).arm(
        "cycle.start", at=cycles // 2 + 1)
    out, crash = run_host_until_crash(d1, c1, cycles, runtime)
    chaos.clear()
    ck = Checker()
    ck.check(crash is not None, "fault never fired")
    ck.check(wal.tail == [], "boundary crash left uncommitted ops")
    crashed_after = len(out)

    d2, replayed = recover(n, d1, wal)
    resume_host(d2, c1, cycles, runtime, out, tick_first=False)
    ck.prefix(out, control, "boundary")
    ck.final(d2, dc, "boundary")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "crashed_after_cycles": crashed_after,
        "cycles": cycles,
        "wal_tail_replayed": replayed,
        "total_admissions": sum(len(s.admitted) for s in control),
        "state_digest": {"control": state_digest(dc),
                         "recovered": state_digest(d2)},
        "chaos": chaos_report(injector=None, wal=wal),
    }


def scenario_mid_admit_crash(cfg, seed, wal_path, device="cuda"):
    """The hard case: the admit op is journaled, the store write never
    lands.  Recovery rolls the tail forward with the journaled
    timestamps, the resume mask holds the replayed CQs out of the
    re-run cycle, and the replayed admits fold back into that cycle's
    record so the modeled-runtime finisher sees the same obligations."""
    n, per, cycles, runtime = _drain(cfg)
    spec = workload_spec(n, per)
    dc, cc = build(spec, device)
    control = run_host(dc, cc, cycles, runtime)

    d1, c1 = build(spec, device)
    wal = CycleWAL(wal_path)
    d1.attach_wal(wal)
    # cycle 0 admits one head per CQ, so hit n+7 dies 7 admits into
    # cycle 1 — journaled decisions and undecided heads in one cycle
    chaos.install(ChaosInjector(seed=seed)).arm("wal.admit", at=n + 7)
    out, crash = run_host_until_crash(d1, c1, cycles, runtime)
    chaos.clear()
    ck = Checker()
    ck.check(crash is not None, "fault never fired")
    tail_admits = {op["key"] for op in wal.tail if op["op"] == "admit"}
    ck.check(bool(tail_admits), "crash left no journaled-but-unapplied ops")
    crashed_after, n_tail = len(out), len(tail_admits)

    d2, replayed = recover(n, d1, wal)
    k = len(out)   # the interrupted cycle being completed
    resume_host(d2, c1, k + 1, runtime, out, tick_first=False)
    if k < len(control):
        ck.check(tail_admits <= set(control[k].admitted),
                 "replayed admits not a subset of control's cycle")
        ck.check(set(out[k].admitted) ==
                 set(control[k].admitted) - tail_admits,
                 "re-run cycle did not complete the interrupted batch")
        # the cycle's decision batch is WAL-recovered + re-run: fold the
        # replayed admits into its record for the finish contract
        out[k].admitted.extend(sorted(tail_admits))
    resume_host(d2, c1, cycles, runtime, out)
    ck.prefix(out, control, "mid-admit")
    ck.final(d2, dc, "mid-admit")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "crashed_after_cycles": crashed_after,
        "cycles": cycles,
        "wal_tail_replayed": replayed,
        "tail_admits": n_tail,
        "total_admissions": sum(len(s.admitted) for s in control),
        "state_digest": {"control": state_digest(dc),
                         "recovered": state_digest(d2)},
        "chaos": chaos_report(injector=None, wal=wal),
    }


def scenario_mid_burst_crash(cfg, seed, wal_path, device="cuda"):
    """Driver dies between applied cycles INSIDE a fused burst window
    (its launch and copies may still be in flight on the device).  The
    WAL commit at each applied cycle bounds the loss to zero full
    cycles; the recovered driver resumes per-cycle."""
    n, per, cycles, runtime = _sustained(cfg)
    spec = workload_spec(n, per)
    dc, cc = build(spec, device)
    control = run_host(dc, cc, cycles, runtime)

    d1, c1 = build(spec, device)
    wal = CycleWAL(wal_path)
    d1.attach_wal(wal)
    chaos.install(ChaosInjector(seed=seed)).arm("burst.mid_window", at=7)
    out, crash = run_burst_until_crash(d1, c1, cycles, runtime)
    bstats = dict(d1._burst_solver.stats) if d1._burst_solver else {}
    chaos.clear()
    ck = Checker()
    ck.check(crash is not None, "fault never fired")
    ck.check(0 < len(out) < cycles, f"crash landed outside the run "
             f"({len(out)}/{cycles})")
    crashed_after = len(out)

    d2, replayed = recover(n, d1, wal)
    resume_host(d2, c1, cycles, runtime, out, tick_first=True)
    ck.prefix(out, control, "mid-burst")
    ck.final(d2, dc, "mid-burst")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "crashed_after_cycles": crashed_after,
        "cycles": cycles,
        "wal_tail_replayed": replayed,
        "burst_dispatches": bstats.get("burst_dispatches", 0),
        "total_admissions": sum(len(s.admitted) for s in control),
        "state_digest": {"control": state_digest(dc),
                         "recovered": state_digest(d2)},
        "chaos": chaos_report(injector=None, bstats=bstats, wal=wal),
    }


def scenario_spec_divergence(cfg, seed, wal_path, device="cuda"):
    """Chaos discards pipelined speculative windows unconsumed; the
    serial fallback must decide identically to the fault-free host."""
    n, per, cycles, runtime = _sustained(cfg)
    spec = workload_spec(n, per)
    dc, cc = build(spec, device)
    control = run_host(dc, cc, cycles, runtime)

    d1, c1 = build(spec, device)
    wal = CycleWAL(wal_path)
    d1.attach_wal(wal)
    inj = chaos.install(ChaosInjector(seed=seed))
    inj.arm("burst.force_spec_divergence", at=1, times=3, action="cancel")
    out = run_burst(d1, c1, cycles, runtime, pipeline=True)
    bstats = dict(d1._burst_solver.stats)
    report = chaos_report(injector=inj, bstats=bstats, wal=wal)
    chaos.clear()
    ck = Checker()
    ck.check(bstats.get("burst_chaos_divergences", 0) >= 1,
             "no speculative window was ever forced divergent")
    ck.prefix(out, control, "spec-divergence")
    ck.final(d1, dc, "spec-divergence")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "cycles": cycles,
        "divergences_forced": bstats.get("burst_chaos_divergences", 0),
        "spec_cancelled": bstats.get("burst_spec_cancelled", 0),
        "total_admissions": sum(len(s.admitted) for s in control),
        "state_digest": {"control": state_digest(dc),
                         "chaos": state_digest(d1)},
        "chaos": report,
    }


def scenario_shard_cascade(cfg, seed, wal_path, device="cuda"):
    """The 8→4→1 cascade: chaos kills 4 devices at the first fresh
    window launch and 3 more at the second; the solver re-partitions
    over the survivors, then falls back to the serial path — decisions
    stay identical to an undegraded control arm throughout."""
    have = len(sharded._mesh_devices(device))
    if have < 8:
        return {"skipped": True,
                "reason": f"needs 8 devices, have {have} "
                          "(run with --devices 8)"}
    n, per, cycles, runtime = _sustained(cfg)
    spec = workload_spec(n, per)
    dc, cc = build(spec, device)
    control = run_host(dc, cc, cycles, runtime)

    d1, c1 = build(spec, device)
    bs = BurstSolver(device=d1.device)
    bs.set_shards(8)
    d1._burst_solver = bs
    wal = CycleWAL(wal_path)
    d1.attach_wal(wal)
    inj = chaos.install(ChaosInjector(seed=seed))
    inj.arm("shard.device_loss", at=1, action="degrade", payload=4)
    inj.arm("shard.device_loss", at=2, action="degrade", payload=3)
    out = run_burst(d1, c1, cycles, runtime, pipeline=False)
    report = chaos_report(injector=inj, bstats=bs.stats, wal=wal)
    chaos.clear()
    ck = Checker()
    ck.check(bs.stats["burst_shard_degradations"] == 2,
             f"expected 2 degradations, got "
             f"{bs.stats['burst_shard_degradations']}")
    ck.check(bs.stats["burst_shard_serial_fallbacks"] == 1,
             "cascade never fell back to the serial path")
    ck.check(bs.n_shards == 1, f"cascade ended at {bs.n_shards} shards")
    ck.prefix(out, control, "shard-cascade")
    ck.final(d1, dc, "shard-cascade")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "cycles": cycles,
        "shard_path": [8, 4, 1],
        "degradations": bs.stats["burst_shard_degradations"],
        "serial_fallbacks": bs.stats["burst_shard_serial_fallbacks"],
        "final_shards": bs.n_shards,
        "total_admissions": sum(len(s.admitted) for s in control),
        "state_digest": {"control": state_digest(dc),
                         "degraded": state_digest(d1)},
        "chaos": report,
    }


def scenario_journal_corruption(cfg, seed, wal_path, device="cuda"):
    """A dropped pack-journal touch (lost update) and a spurious
    dirty-all: both must degrade the incremental pack to a full walk,
    never to a wrong decision."""
    n, per, cycles, runtime = _drain(cfg)
    spec = workload_spec(n, per)
    dc, cc = build(spec, device)
    control = run_host(dc, cc, cycles, runtime)

    d1, c1 = build(spec, device)
    wal = CycleWAL(wal_path)
    d1.attach_wal(wal)
    inj = chaos.install(ChaosInjector(seed=seed))
    inj.arm("journal.drop_touch", at=1)
    inj.arm("journal.spurious_dirty_all", at=n // 2 + 3)
    out = run_burst(d1, c1, cycles, runtime)
    bstats = dict(d1._burst_solver.stats) if d1._burst_solver else {}
    report = chaos_report(injector=inj, bstats=bstats, wal=wal)
    hits = {s["site"]: s["fired"] for s in report.get("armed", [])}
    chaos.clear()
    ck = Checker()
    ck.prefix(out, control, "journal-corruption")
    ck.final(d1, dc, "journal-corruption")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "cycles": cycles,
        "fired": hits,
        "total_admissions": sum(len(s.admitted) for s in control),
        "state_digest": {"control": state_digest(dc),
                         "corrupted": state_digest(d1)},
        "chaos": report,
    }


def scenario_multikueue_partition(cfg, seed, wal_path, device="cuda"):
    """Mirror one workload per CQ to a MultiKueue worker through a
    transport with seeded partitions, duplicated deliveries, and
    delays; the worker's admissions must match a fault-free mirror."""
    n = cfg["cqs"]

    def worker():
        d = Driver(clock=VirtualClock(), device=device)
        cluster_spec(n)(d)
        return d

    wc, wx = worker(), worker()
    direct = LocalWorkerClient(wc)
    inj = ChaosInjector(seed=seed)
    inj.arm("remote.partition", prob=0.01, times=40, action="partition")
    inj.arm("remote.duplicate", prob=0.02, times=40, action="duplicate")
    inj.arm("remote.delay", prob=0.02, times=40, action="delay",
            payload=0.0)
    faulty = ChaosWorkerClient(LocalWorkerClient(wx), injector=inj,
                               backoff_base=0.0, backoff_max=0.0)
    for q in range(n):
        wl = mk(f"w-{q}", f"lq-{q}", 1500, prio=q % 3, t=float(q + 1))
        direct.create_workload(wl)
        faulty.create_workload(mk(f"w-{q}", f"lq-{q}", 1500,
                                  prio=q % 3, t=float(q + 1)))
    wc.run_until_settled()
    wx.run_until_settled()
    ck = Checker()
    ck.check(faulty.stats["retries"] >= 1 or faulty.stats["partitioned"]
             == 0, "partitions fired but nothing retried")
    ck.check(sorted(direct.list_workload_keys()) ==
             sorted(faulty.list_workload_keys()),
             "worker stores diverged")
    ck.final(wc, wx, "multikueue")
    return {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "mirrored_workloads": n,
        "transport": dict(faulty.stats),
        "admitted_per_arm": len(wc.admitted_keys()),
        "state_digest": {"control": state_digest(wc),
                         "faulted": state_digest(wx)},
        "chaos": chaos_report(injector=inj),
    }


SCENARIOS = [
    ("boundary_crash", scenario_boundary_crash),
    ("mid_admit_crash", scenario_mid_admit_crash),
    ("mid_burst_crash", scenario_mid_burst_crash),
    ("spec_divergence", scenario_spec_divergence),
    ("shard_cascade_8_4_1", scenario_shard_cascade),
    ("journal_corruption", scenario_journal_corruption),
    ("multikueue_partition", scenario_multikueue_partition),
]

HARD_PATHS = [
    "cycle.start crash + recover_from",
    "wal.admit crash + tail replay + resume mask",
    "burst.mid_window crash inside a fused window",
    "burst.force_spec_divergence (pipeline fallback)",
    "shard.device_loss 8->4->1 cascade",
    "journal.drop_touch + journal.spurious_dirty_all",
    "remote.partition/duplicate/delay transport",
]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cqs", type=int, default=1000)
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh width of the shard cascade (the cards when "
                         "that many are present, else a virtual mesh of "
                         "the torch device)")
    ap.add_argument("--seed", type=int,
                    default=int(env_value("KUEUE_TPU_CHAOS_SEED",
                                          "1009")))
    ap.add_argument("--quick", action="store_true",
                    help="tiny cluster for a fast functional pass")
    ap.add_argument("--only", default=None,
                    help="comma-separated scenario names")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def config(cqs: int) -> dict:
    return {
        "cqs": cqs,
        "runtime": 2,
        # drain config: short, for the host-path crash scenarios
        "drain_per_cq": 4,
        "drain_cycles": 12,
        # sustained config: >1 full K=32 burst window busy, so the
        # pipeline speculates and fresh window launches repeat
        "sustained_per_cq": 40,
        "sustained_cycles": 72,
    }


def run(args) -> dict:
    """Every scenario the flags ask for → the JSON tail."""
    dev = resolve_device(args.torch_device)
    cqs = 16 if args.quick else args.cqs
    if cqs < 16:
        raise ValueError("--cqs must be >= 16 (mid-admit arming assumes it)")
    cfg = config(cqs)
    only = set(args.only.split(",")) if args.only else None
    virtual = args.devices > 1 and (
        dev.type == "cpu" or args.devices > torch.cuda.device_count())

    gc.collect()
    scenarios_out: dict[str, dict] = {}
    walls: dict[str, float] = {}
    with contextlib.ExitStack() as stack:
        if virtual:
            stack.enter_context(sharded.virtual_mesh(dev, args.devices))
        td = stack.enter_context(
            tempfile.TemporaryDirectory(prefix="chaos_soak_"))
        for i, (name, fn) in enumerate(SCENARIOS):
            if only and name not in only:
                continue
            chaos.clear()
            log(f"[{i + 1}/{len(SCENARIOS)}] {name} "
                f"(cqs={cqs}, seed={args.seed + i}) ...")
            t0 = time.perf_counter()
            try:
                res = fn(cfg, args.seed + i, f"{td}/{name}.wal.jsonl",
                         device=dev)
            except Exception as e:   # a scenario bug is a failed scenario
                res = {"decisions_stable": False,
                       "failures": [f"{type(e).__name__}: {e}"]}
            finally:
                chaos.clear()
            walls[name] = round(time.perf_counter() - t0, 2)
            res["wall_s"] = walls[name]
            res["seed"] = args.seed + i
            scenarios_out[name] = res
            if res.get("skipped"):
                log(f"    SKIPPED: {res['reason']}")
            else:
                ok = res["decisions_stable"]
                log(f"    {'bit-identical' if ok else 'DIVERGED'} "
                    f"({walls[name]}s)"
                    + ("" if ok else f" — {res['failures'][:3]}"))
            gc.collect()
        mesh = mesh_info(args.devices, dev, virtual)

    ran = {k: v for k, v in scenarios_out.items() if not v.get("skipped")}
    stable = sum(1 for v in ran.values() if v["decisions_stable"])
    return {
        "metric": "chaos_soak_decision_parity",
        "unit": "scenarios bit-identical to fault-free control",
        "cqs": cqs,
        "seed": args.seed,
        "mesh": mesh,
        "config": cfg,
        "scenarios": scenarios_out,
        "scenarios_total": len(ran),
        "scenarios_stable": stable,
        "all_stable": stable == len(ran) and len(ran) > 0,
        "value": stable,
        "hard_paths_exercised": list(HARD_PATHS),
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    tail = run(args)
    print(json.dumps(tail))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tail, f, indent=1)
            f.write("\n")
        log(f"wrote {args.out}")
    return 0 if tail["all_stable"] else 1


if __name__ == "__main__":
    sys.exit(main())
