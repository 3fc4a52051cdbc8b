"""Traffic soak of the port: the open-loop saturation search at 1,000 CQs
on the torch device (the JAX package's ``scripts/traffic_soak.py``, every
flag, phase and JSON key kept).

Feeds seeded arrival streams (Poisson for the curve, MMPP for the storm
probe) into ``Driver.schedule_once`` through the open-loop runner
(``traffic/``) and publishes:

  curve      — per-arm latency-vs-offered-rate ladder, serial and
               ``--shards 8``, probes interleaved (serial, sharded,
               serial, …) so the serial arm doubles as the same-box
               environment-drift control;
  saturation — per-arm binary-searched sustainable admissions/s at the
               fixed p99 submit→admit SLO (virtual seconds, so the
               number is deterministic and replayable);
  replay     — the sustainable-rate run's recorded event stream re-run
               through a ReplayStream on an identically-built driver
               must reproduce the per-cycle decisions bit-for-bit, and
               serial vs sharded decisions at that rate must match;
  host cost  — measured incremental-snapshot counters at a low and a
               high rate plus a full-rebuild control arm
               (KUEUE_TPU_SNAP_INCREMENTAL=0);
  storms     — an MMPP burst probe's requeue-storm counters, plus a
               MultiKueue probe routing a slice of submissions through
               the ``remote`` worker client.

    python -m kueue_tpu_torch.traffic_soak [--cqs 1000] [--shards 8]
        [--seed N] [--duration 30] [--slo 8] [--iters 4] [--quick]
        [--out PATH] [--torch-device cuda|cpu]

Every Driver runs the device solver on ``--torch-device`` (default
``cuda``: the CUDA kernels; ``cpu``: their plain versions); without a
GPU and without ``--torch-device cpu`` the run raises.  The sharded arm
sets ``KUEUE_TPU_SHARDS`` around its Drivers' builds, as production
does; with fewer than ``--shards`` cards it runs on a virtual mesh of
``--shards`` copies of the torch device
(``parallel.sharded.virtual_mesh``; the ``mesh`` block then says
``"virtual": true``).  Prints progress on stderr and the JSON tail as
the last line of stdout (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

import torch

from . import scenarios
from .features import env_value
from .northstar import mesh_info
from .ops.solver import resolve_device
from .parallel import sharded
from .perf.harness import ab_block
from .remote import LocalWorkerClient
from .scenarios import log, rate_seed, release
from .traffic import MMPPProcess, find_sustainable_rate


def build(n_cqs: int, shards: int, device):
    """A fresh Driver per probe (``scenarios.build_traffic``: cohorts of
    4, 4000m cpu nominal, BEST_EFFORT_FIFO).  ``shards`` > 1 is applied
    through the KUEUE_TPU_SHARDS env the production path reads; else the
    variable is unset while the Driver is built, as in the script."""
    prev = os.environ.pop("KUEUE_TPU_SHARDS", None)
    try:
        with scenarios.shards_env(shards if shards > 1 else 0):
            return scenarios.build_traffic(n_cqs, device)
    finally:
        if prev is not None:
            os.environ["KUEUE_TPU_SHARDS"] = prev


def probe(cfg: dict, rate: float, shards: int, *, seed: int, device,
          process=None, remote: bool = False, snap_incremental=None,
          events=None, record: dict | None = None, tag=None):
    """One fresh-driver open-loop run at ``rate`` (or over the recorded
    ``events``); returns the OpenLoopResult (events retained for
    replay).  ``record[tag]``, when given, gets the digest of its
    per-cycle decisions."""
    if snap_incremental is not None:
        os.environ["KUEUE_TPU_SNAP_INCREMENTAL"] = \
            "1" if snap_incremental else "0"
    try:
        d, clock = build(cfg["cqs"], shards, device)
    finally:
        os.environ.pop("KUEUE_TPU_SNAP_INCREMENTAL", None)
    stream = scenarios.traffic_stream(
        cfg["cqs"], rate, seed, events=events, process=process,
        remote_fraction=0.25 if remote else 0.0)
    r = scenarios.open_loop(
        d, clock, stream, duration_s=cfg["duration_s"],
        slo_p99_s=cfg["slo_p99_s"], wall_budget_s=cfg["wall_budget_s"],
        remote_client=LocalWorkerClient(d) if remote else None)
    r.rate_per_s = rate
    r.obs = d.obs.report()
    if record is not None:
        record[tag] = decisions_digest(r.decisions)
    del d
    release()
    return r


def decisions_digest(decisions) -> str:
    """The digest of an open-loop run's per-cycle decisions."""
    return hashlib.sha256(repr(decisions).encode()).hexdigest()[:16]


def curve_entry(r) -> dict:
    return {"rate_per_s": round(r.rate_per_s, 1),
            "submitted": r.submitted,
            "admitted": r.admitted,
            "p50_latency_s": round(r.p50_latency_s, 3),
            "p99_latency_s": round(r.p99_latency_s, 3),
            "mean_latency_s": round(r.mean_latency_s, 3),
            "end_depth": r.end_depth,
            "max_depth": r.max_depth,
            "admissions_per_s": round(r.admissions_per_wall_s, 1),
            "cycle_wall_p50_ms": round(r.cycle_wall_p50_ms, 2),
            "cycle_wall_p99_ms": round(r.cycle_wall_p99_ms, 2),
            "latency_hist": r.latency_hist,
            "meets_slo": r.meets_slo,
            "truncated": r.truncated}


_TIMED = ("admissions_per_s", "cycle_wall_p50_ms", "cycle_wall_p99_ms",
          "admissions_per_wall_s_at_rate")


def decided(tail: dict) -> dict:
    """What a tail decided, without its walls: every arm's curve and
    search, the replay and shard verdicts, the snapshot counters and the
    storm and remote probes — equal on every device for one seed."""
    def untimed(e):
        return {k: v for k, v in e.items() if k not in _TIMED}
    snap = tail["snapshot_counters"]
    return {
        "arms": {name: {**untimed(a), "curve": [untimed(e)
                                                for e in a["curve"]]}
                 for name, a in tail["arms"].items()},
        "replay_identical": tail["replay_identical"],
        "serial_shard_decisions_match":
            tail["serial_shard_decisions_match"],
        "snapshot_counters": {**snap, "probes": {
            k: untimed(v) for k, v in snap["probes"].items()}},
        "storm_probe": tail["storm_probe"],
        "remote_probe": tail["remote_probe"],
        "value": tail["value"],
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cqs", type=int, default=1000)
    ap.add_argument("--shards", type=int, default=8,
                    help="sharded-arm mesh size (the cards when that many "
                         "are present, else a virtual mesh of the torch "
                         "device)")
    ap.add_argument("--seed", type=int,
                    default=int(env_value("KUEUE_TPU_TRAFFIC_SEED")))
    ap.add_argument("--duration", type=float, default=30.0,
                    help="virtual seconds per probe")
    ap.add_argument("--slo", type=float, default=8.0,
                    help="p99 submit->admit SLO, virtual seconds")
    ap.add_argument("--iters", type=int, default=4,
                    help="binary-search refinement steps per arm")
    ap.add_argument("--quick", action="store_true",
                    help="tiny cluster for a seconds-level pass")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def run(args, record: dict | None = None) -> dict:
    """Every phase of the soak → the JSON tail.  ``record``, when given,
    gets each probe's decision digest under (arm, rate), ("replay",
    arm), ("snapshot", tag), "storm" and "remote"."""
    dev = resolve_device(args.torch_device)
    virtual = args.shards > 1 and (
        dev.type == "cpu" or args.shards > torch.cuda.device_count())
    with contextlib.ExitStack() as stack:
        if virtual:
            stack.enter_context(sharded.virtual_mesh(dev, args.shards))
        tail = _run(args, dev, record)
        tail["mesh"] = mesh_info(args.shards, dev, virtual)
    return tail


def _run(args, dev, record) -> dict:
    cqs = 16 if args.quick else args.cqs
    cfg = {
        "cqs": cqs,
        "duration_s": 10.0 if args.quick else args.duration,
        "slo_p99_s": args.slo,
        "wall_budget_s": 20.0 if args.quick else 120.0,
    }
    iters = 2 if args.quick else args.iters
    cap = scenarios.traffic_capacity(cqs)
    # offered-rate ladder as fractions of the quota ceiling; the
    # >= 1.0 rungs are the past-saturation measurements
    ladder = ([0.5, 1.0, 1.5] if args.quick
              else [0.25, 0.5, 0.75, 0.9, 1.0, 1.2, 1.5])
    arms = {"serial": 0, f"shards_{args.shards}": args.shards}
    t_start = time.perf_counter()

    def at(rate, shards, tag, **kw):
        return probe(cfg, rate, shards, seed=kw.pop("seed", rate_seed(
            args.seed, rate)), device=dev, record=record, tag=tag, **kw)

    log(f"traffic soak: cqs={cqs} capacity_estimate={cap:.0f}/s "
        f"slo_p99={cfg['slo_p99_s']}s duration={cfg['duration_s']}s "
        f"seed={args.seed} device={dev}")

    # --- saturation curve, probes interleaved across arms ------------
    curves: dict[str, list] = {name: [] for name in arms}
    results: dict[str, dict[float, object]] = {name: {} for name in arms}
    for frac in ladder:
        rate = round(cap * frac, 1)
        for name, shards in arms.items():
            r = at(rate, shards, (name, rate))
            curves[name].append(curve_entry(r))
            results[name][rate] = r
            log(f"  [{name}] rate={rate}/s ({frac:.2f}x cap) "
                f"p99={r.p99_latency_s:.2f}s depth_end={r.end_depth} "
                f"wall={r.wall_s:.1f}s "
                f"{'OK' if r.meets_slo else 'over SLO'}")

    # --- binary search: sustainable admissions/s per arm -------------
    saturation: dict[str, dict] = {}
    for name, shards in arms.items():
        ok_rates = [r for r in sorted(results[name])
                    if results[name][r].meets_slo]
        bad_rates = [r for r in sorted(results[name])
                     if not results[name][r].meets_slo]
        lo = ok_rates[-1] if ok_rates else cap * ladder[0] / 2
        hi = bad_rates[0] if bad_rates else cap * ladder[-1] * 2
        best, probes = find_sustainable_rate(
            lambda rate, name=name, shards=shards:
                at(rate, shards, (name, rate)),
            lo, hi, iters=iters)
        for r in probes:
            curves[name].append(curve_entry(r))
            results[name][r.rate_per_s] = r
            log(f"  [{name}] search rate={r.rate_per_s:.1f}/s "
                f"p99={r.p99_latency_s:.2f}s "
                f"{'OK' if r.meets_slo else 'over SLO'}")
        at_best = results[name].get(best) or max(
            (results[name][r] for r in results[name]
             if results[name][r].meets_slo),
            key=lambda r: r.rate_per_s, default=None)
        saturation[name] = {
            "sustainable_rate_per_s": round(best, 1),
            "bracket": [round(lo, 1), round(hi, 1)],
            "search_iters": iters,
            "p99_latency_s_at_rate": (
                round(at_best.p99_latency_s, 3) if at_best else None),
            "admissions_per_wall_s_at_rate": (
                round(at_best.admissions_per_wall_s, 1)
                if at_best else None),
        }
        log(f"[{name}] sustainable ~= {best:.1f}/s at p99<="
            f"{cfg['slo_p99_s']}s")
        curves[name].sort(key=lambda e: e["rate_per_s"])
    results.clear()

    # --- replay bit-identity at the serial sustainable rate ----------
    replay_rate = saturation["serial"]["sustainable_rate_per_s"]
    log(f"replay check @ {replay_rate}/s ...")
    live = at(replay_rate, 0, ("replay", "live"))
    replayed = at(replay_rate, 0, ("replay", "serial"), events=live.events)
    sharded_run = at(replay_rate, args.shards, ("replay", "sharded"),
                     events=live.events)
    replay_identical = replayed.decisions == live.decisions
    serial_shard_match = sharded_run.decisions == live.decisions
    log(f"  replay {'bit-identical' if replay_identical else 'DIVERGED'}"
        f"; serial-vs-sharded decisions "
        f"{'match' if serial_shard_match else 'DIVERGED'}")

    # --- host-cost scaling: O(arrivals + dirty rows), not O(universe) -
    lo_rate, hi_rate = round(cap * 0.05, 1), round(cap * 0.75, 1)
    snap_probes = {}
    for tag, rate, inc in (("low_rate", lo_rate, True),
                           ("high_rate", hi_rate, True),
                           ("low_rate_full_rebuild", lo_rate, False)):
        r = at(rate, 0, ("snapshot", tag), snap_incremental=inc)
        snap_probes[tag] = {
            "rate_per_s": rate,
            "incremental": inc,
            "snap_cqs_recloned_per_cycle": round(
                r.snap_cqs_recloned_per_cycle, 1),
            "snap_trees_reused_per_cycle": round(
                r.snap_trees_reused_per_cycle, 1),
            "snap_full_rebuilds": r.snap_full_rebuilds,
            "cycle_wall_p50_ms": round(r.cycle_wall_p50_ms, 2),
            "cycle_wall_p99_ms": round(r.cycle_wall_p99_ms, 2),
        }
        log(f"  snapshot[{tag}] rate={rate}/s recloned/cyc="
            f"{snap_probes[tag]['snap_cqs_recloned_per_cycle']} "
            f"cyc_p50={snap_probes[tag]['cycle_wall_p50_ms']}ms")
    snapshot_counters = {
        "cq_universe": cqs,
        "probes": snap_probes,
        "recloned_per_cycle_low_over_universe": round(
            snap_probes["low_rate"]["snap_cqs_recloned_per_cycle"] / cqs,
            3),
        "recloned_per_cycle_full_rebuild_over_universe": round(
            snap_probes["low_rate_full_rebuild"]
            ["snap_cqs_recloned_per_cycle"] / cqs, 3),
    }

    # --- MMPP storm probe + MultiKueue remote-path probe -------------
    burst_rate = round(cap * 0.6, 1)
    mmpp = at(burst_rate, 0, "storm", seed=args.seed + 17,
              process=MMPPProcess(quiet_rate_per_s=burst_rate * 0.2,
                                  burst_rate_per_s=burst_rate * 2.5,
                                  mean_dwell_s=5.0, seed=args.seed + 17))
    storm_block = {
        "process": "mmpp",
        "mean_rate_per_s": burst_rate,
        "p99_latency_s": round(mmpp.p99_latency_s, 3),
        "max_depth": mmpp.max_depth,
        "requeue_unparked": mmpp.requeue_unparked,
        "requeue_storm_peak": mmpp.requeue_storm_peak,
    }
    log(f"  mmpp storm probe: p99={storm_block['p99_latency_s']}s "
        f"max_depth={storm_block['max_depth']} "
        f"storm_peak={storm_block['requeue_storm_peak']}")
    remote_rate = round(cap * 0.4, 1)
    rem = at(remote_rate, 0, "remote", seed=args.seed + 29, remote=True)
    remote_block = {
        "rate_per_s": remote_rate,
        "remote_fraction": 0.25,
        "remote_submitted": rem.remote_submitted,
        "submitted": rem.submitted,
        "p99_latency_s": round(rem.p99_latency_s, 3),
        "meets_slo": rem.meets_slo,
    }
    log(f"  remote probe: {rem.remote_submitted}/{rem.submitted} via "
        f"worker client, p99={remote_block['p99_latency_s']}s")

    # --- environment-drift bookkeeping: the interleaved serial arm is
    # the same-box control for the sharded treatment ------------------
    shard_name = f"shards_{args.shards}"
    drift = ab_block(
        treatment={"arm": shard_name,
                   "sustainable_rate_per_s":
                       saturation[shard_name]["sustainable_rate_per_s"],
                   "cycle_wall_p50_ms_at_cap": next(
                       (e["cycle_wall_p50_ms"] for e in curves[shard_name]
                        if e["rate_per_s"] >= cap), None)},
        control={"arm": "serial", "interleaved": True,
                 "sustainable_rate_per_s":
                     saturation["serial"]["sustainable_rate_per_s"],
                 "cycle_wall_p50_ms_at_cap": next(
                     (e["cycle_wall_p50_ms"] for e in curves["serial"]
                      if e["rate_per_s"] >= cap), None)})

    arrival = {"process": "poisson", "seed": args.seed,
               "cpu_m_choices": [1500],
               "runtime_choices_s": list(scenarios.TRAFFIC_RUNTIMES_S),
               "cancel_fraction": 0.02, "churn_fraction": 0.02,
               "capacity_estimate_per_s": round(cap, 1)}
    return {
        "metric": "open_loop_sustainable_admissions_per_s",
        "unit": "admissions/s at p99 submit->admit <= SLO (virtual s)",
        "cqs": cqs,
        "seed": args.seed,
        "quick": bool(args.quick),
        "slo": {"p99_latency_s": cfg["slo_p99_s"]},
        "arrival": arrival,
        "open_loop": {"duration_s": cfg["duration_s"], "dt_s": 1.0,
                      "wall_budget_s": cfg["wall_budget_s"],
                      "iters": iters},
        "arms": {name: {**saturation[name], "curve": curves[name]}
                 for name in arms},
        "control": drift["control"],
        "environment_drift": drift,
        "replay_identical": replay_identical,
        "serial_shard_decisions_match": serial_shard_match,
        "snapshot_counters": snapshot_counters,
        "storm_probe": storm_block,
        "remote_probe": remote_block,
        # the replay-rate serial probe's obs block stands for the
        # headline arm
        "obs": live.obs,
        "value": saturation["serial"]["sustainable_rate_per_s"],
        "wall_s_total": round(time.perf_counter() - t_start, 1),
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    tail = run(args)
    print(json.dumps(tail))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tail, f, indent=1)
            f.write("\n")
        log(f"wrote {args.out} ({tail['wall_s_total']}s total)")
    return 0 if (tail["replay_identical"]
                 and tail["serial_shard_decisions_match"]) else 1


if __name__ == "__main__":
    sys.exit(main())
