"""Serving soak of the port: the long-lived admission service under fire
on the torch device (the JAX package's ``scripts/serve_soak.py``, every
flag, arm and JSON key kept).

Four arms, one artifact (SERVE):

- **wall** — a real wall-clock service loop (no virtual time): concurrent
  submitter threads replay a pre-generated diurnal arrival schedule
  against ``AdmissionService.serve`` while the adaptive burst window K
  tracks the load swing online; evidence is per-window p99 admission
  latency against the SLO plus the K values actually chosen.
- **kill_restart** — deterministic virtual-time arms: chaos crashes
  (``svc.cycle`` at a step boundary, ``svc.ingest`` inside the submit
  path) mid-load, then recovery from the durable store + the CycleWAL
  tail + the ingest journal.  The recovered run must match an unkilled
  control bit-for-bit in per-cycle decisions and final state digest,
  lose zero accepted submissions, and duplicate zero admissions.
- **drain** — SIGTERM to the serving process: graceful drain must stop
  accepting (reject with ``draining``), finish in-flight cycles, flush
  the WAL, and exit clean.
- **parity** — the same submit-only traffic through the service loop
  (K pinned to 1) and through ``traffic.run_open_loop`` on a fresh
  batch driver: per-cycle decisions must be bit-identical.

    python -m kueue_tpu_torch.serve_soak [--cqs 16] [--seed N] [--quick]
        [--out PATH] [--torch-device cuda|cpu]

Every Driver runs the device solver on ``--torch-device`` (default
``cuda``: the CUDA kernels; ``cpu``: their plain versions); without a
GPU and without ``--torch-device cpu`` the run raises.  The service
threads of the wall and drain arms launch on the device and stream of
the thread that built their Driver.  The seed comes from ``--seed`` or
KUEUE_TPU_SVC_SEED, the ingest high-water mark from
KUEUE_TPU_SVC_HIGH_WATER.  Prints progress on stderr and the JSON tail
as the last line of stdout (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import sys
import tempfile
import threading
import time

from . import scenarios
from .features import env_int
from .northstar import mesh_info
from .ops.solver import resolve_device
from .remote import state_digest
from .scenarios import log


# ---------------------------------------------------------------------------
# Arm: wall-clock soak with diurnal swing + online K adaptation
# ---------------------------------------------------------------------------

def arm_wall(cfg, seed, td, device):
    w = scenarios.serve_wall(cfg, seed, td, device)
    return {
        "wall_clock": True,
        "duration_s": w["duration_s"],
        "submitted": w["submitted"],
        "admitted": w["admitted"],
        "admissions_per_s": w["admissions_per_s"],
        "drained_clean": w["drained_clean"],
        "slo": {
            "p99_target_s": cfg["slo_p99_s"],
            "held": w["held"],
            "windows": w["windows"],
            "k_values": w["k_values"],
            "k_adapted": len(w["k_values"]) > 1,
        },
        "backpressure": {
            "high_water": cfg["high_water"],
            "rejected": w["rejected"],
            "shed": w["shed"],
        },
        "arrivals": {"process": "diurnal",
                     "trough_rate_per_s": cfg["wall_trough_rate"],
                     "peak_rate_per_s": cfg["wall_peak_rate"],
                     "events": w["events"]},
    }


# ---------------------------------------------------------------------------
# Arm: kill mid-load + restart vs unkilled control (virtual time)
# ---------------------------------------------------------------------------

def gen_kill_schedule(cfg, seed):
    """Per-step submission batches, deterministic: heavier even steps
    keep a backlog alive across the kill point."""
    rng = random.Random(seed)
    out, n = [], 0
    for s in range(cfg["kill_steps"]):
        batch = []
        for _ in range(3 if s % 2 == 0 else 1):
            n += 1
            batch.append((f"w{n}", f"lq-{rng.randrange(cfg['cqs'])}",
                          rng.choice((0, 10, 20)),
                          float(rng.choice((2, 3)))))
        out.append(batch)
    return out


def _submit_scheduled(svc, item):
    name, lq, prio, rt = item
    return svc.submit(name=name, queue_name=lq, requests={"cpu": 1500},
                      priority=prio, runtime_s=rt)


def run_killable(m, cfg, sched, kill_site, kill_at, td, tag):
    """One serving run over ``sched`` (``scenarios.serve_killable``);
    when ``kill_site`` is armed the run crashes, recovers from store +
    WAL + ingest journal, resubmits the interrupted batch (idempotent
    tokens), and continues → (driver, service, decisions, crashed)."""
    r = scenarios.serve_killable(
        m, cfg["cqs"], None, len(sched), td, tag, kill_site=kill_site,
        kill_at=kill_at, batches=sched, submit=_submit_scheduled)
    return r["driver"], r["service"], r["decisions"], r["crashed"]


def arm_kill_restart(m, cfg, seed, td):
    sched = gen_kill_schedule(cfg, seed)
    d_c, svc_c, dec_c, _ = run_killable(m, cfg, sched, None, 0, td, "ctl")
    digest_c = state_digest(d_c)
    accepted_keys = [f"default/{name}" for batch in sched
                     for (name, _, _, _) in batch]
    out = {}
    lost_total = dup_total = 0
    all_identical = all_digests = True
    arms = [("cycle_kill", "svc.cycle", cfg["kill_steps"] // 2 + 1),
            ("ingest_kill", "svc.ingest",
             max(2, len(accepted_keys) // 2))]
    for tag, site, at in arms:
        d_k, svc_k, dec_k, crashed = run_killable(
            m, cfg, sched, site, at, td, tag)
        digest_k = state_digest(d_k)
        lost, dup = scenarios.lost_and_duplicated(accepted_keys, d_k, dec_k)
        identical = dec_k == dec_c
        digests = digest_k == digest_c
        out[tag] = {
            "site": site, "crashed": crashed,
            "cycles": len(dec_k),
            "decisions_identical": identical,
            "digest": digest_k,
            "digests_match": digests,
            "lost_accepted_submissions": lost,
            "duplicated_admissions": dup,
            "duplicate_tokens_resubmitted": svc_k.duplicate_total,
            "sheds": len(svc_k.journal.shed_seqs),
        }
        lost_total += lost
        dup_total += dup
        all_identical = all_identical and identical
        all_digests = all_digests and digests
        log(f"  kill[{tag}]: crashed={crashed} identical={identical} "
            f"digests={digests} lost={lost} dup={dup}")
    return {
        "control_digest": digest_c,
        "control_cycles": len(dec_c),
        "scenarios": out,
        "lost_accepted_submissions": lost_total,
        "duplicated_admissions": dup_total,
        "decisions_identical": all_identical,
        "digests_match": all_digests,
    }


# ---------------------------------------------------------------------------
# Arm: SIGTERM graceful drain (wall clock, real signal)
# ---------------------------------------------------------------------------

def arm_drain(m, cfg, seed, td, device):
    from .utils.journal import CycleWAL
    d = scenarios.serve_driver(m, cfg["cqs"], time.time)
    wal = CycleWAL(path=os.path.join(td, "drain.wal"))
    d.attach_wal(wal)
    svc = m.serving.AdmissionService(d, config=m.serving.ServiceConfig(
        dt_s=cfg["wall_dt_s"], high_water=cfg["high_water"],
        drain_timeout_s=20.0,
        journal_path=os.path.join(td, "drain.ing"), k_max=cfg["k_max"]),
        wal=wal)
    prev = signal.getsignal(signal.SIGTERM)
    svc.install_signal_handlers()
    try:
        server = threading.Thread(
            target=scenarios.thread_target(svc.serve, device), daemon=True)
        server.start()
        n_subs = cfg["drain_submissions"]

        def submitter(lane):
            for i in range(lane, n_subs, 2):
                svc.submit(name=f"d{i}", queue_name=f"lq-{i % cfg['cqs']}",
                           requests={"cpu": 1500}, priority=0,
                           runtime_s=cfg["wall_runtime_s"])
        subs = [threading.Thread(target=submitter, args=(i,), daemon=True)
                for i in range(2)]
        t0 = time.perf_counter()
        for s in subs:
            s.start()
        for s in subs:
            s.join()
        os.kill(os.getpid(), signal.SIGTERM)   # graceful drain, not death
        server.join(timeout=30.0)
        drain_wall = time.perf_counter() - t0
    finally:
        signal.signal(signal.SIGTERM, prev)
    post = svc.submit(name="late", queue_name="lq-0",
                      requests={"cpu": 1500})
    stats = svc.stats()
    applied = sum(1 for i in range(n_subs)
                  if f"default/d{i}" in d.workloads)
    wal_flushed = (wal.stats.get("wal_flushes", 0) > 0
                   and len(wal.tail) == 0)
    clean = (not server.is_alive() and svc.stopped
             and svc.drained_clean and stats["ingest_depth"] == 0)
    return {
        "clean": clean,
        "wal_flushed": wal_flushed,
        "accepted": stats["accepted"],
        "applied_in_store": applied,
        "zero_lost": applied == stats["accepted"] - stats["shed"],
        "rejected_after_drain": post.status == "draining",
        "drain_wall_s": drain_wall,
        "journal": stats["journal"],
    }


# ---------------------------------------------------------------------------
# Arm: decision parity service loop vs batch open-loop runner
# ---------------------------------------------------------------------------

def parity_events(m, cfg, seed) -> list:
    """The parity arm's submissions: Poisson at ``parity_rate`` over the
    arm's cycles, no cancels or churn."""
    spec = m.traffic.TrafficSpec(n_cqs=cfg["cqs"], cancel_fraction=0.0,
                                 churn_fraction=0.0,
                                 runtime_choices_s=(2.0, 4.0))
    stream = m.traffic.ArrivalStream(
        m.traffic.PoissonProcess(cfg["parity_rate"], seed=seed), spec,
        seed=seed)
    return scenarios.serve_events(stream, cfg["parity_cycles"] * 1.0)


def arm_parity(m, cfg, seed):
    n, cycles = cfg["cqs"], cfg["parity_cycles"]
    events = parity_events(m, cfg, seed)
    # batch arm: the open-loop runner
    batch = scenarios.serve_open_loop(m, n, events, cycles)
    # service arm: same events through submit/step, K pinned to 1
    service = scenarios.serve_loop(m, n, events, cycles)
    identical = service["decisions"] == batch["decisions"]
    digests = state_digest(batch["driver"]) == state_digest(
        service["driver"])
    return {
        "cycles": cycles,
        "events": len(events),
        "service_admitted": sum(len(c) for c in service["decisions"]),
        "batch_admitted": sum(len(c) for c in batch["decisions"]),
        "decisions_identical": identical,
        "state_digests_match": digests,
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def decided(tail: dict) -> dict:
    """What a tail decided, without its walls: the parity and kill arms
    whole, the drain's counts, and the wall arm's schedule (its
    latencies and K values follow the wall clock)."""
    return {"parity": tail["parity"], "kill_restart": tail["kill_restart"],
            "drain": {k: v for k, v in tail["drain"].items()
                      if k != "drain_wall_s"},
            "wall_events": tail["wall"]["arrivals"]["events"]}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cqs", type=int, default=16)
    ap.add_argument("--seed", type=int,
                    default=env_int("KUEUE_TPU_SVC_SEED"))
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: 8 CQs, ~6s wall arm")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def config(args) -> dict:
    return {
        "cqs": 8 if args.quick else args.cqs,
        "wall_dt_s": 0.25,
        "wall_duration_s": 6.0 if args.quick else 24.0,
        "wall_trough_rate": 4.0 if args.quick else 8.0,
        "wall_peak_rate": 48.0 if args.quick else 96.0,
        "wall_runtime_s": 0.3,
        "wall_submitters": 4,
        "wall_windows": 6 if args.quick else 8,
        "slo_p99_s": 2.0,
        "high_water": env_int("KUEUE_TPU_SVC_HIGH_WATER"),
        "k_max": 8,
        "kill_steps": 14 if args.quick else 28,
        "drain_submissions": 40 if args.quick else 160,
        "parity_cycles": 20 if args.quick else 48,
        "parity_rate": 4.0,
    }


def run(args) -> dict:
    """The four arms in the script's order → the JSON tail."""
    dev = resolve_device(args.torch_device)
    m = scenarios.serving_modules(dev)
    cfg = config(args)
    seed = args.seed
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve_soak_") as td:
        log(f"serve soak: cqs={cfg['cqs']} seed={seed} "
            f"quick={args.quick} device={dev}")
        log("arm: parity")
        parity = arm_parity(m, cfg, seed)
        log(f"  parity: identical={parity['decisions_identical']} "
            f"admitted={parity['service_admitted']}")
        scenarios.release()
        log("arm: kill_restart")
        kill = arm_kill_restart(m, cfg, seed + 1, td)
        scenarios.release()
        log("arm: drain")
        drain = arm_drain(m, cfg, seed + 2, td, dev)
        log(f"  drain: clean={drain['clean']} "
            f"wal_flushed={drain['wal_flushed']}")
        scenarios.release()
        log("arm: wall")
        wall = arm_wall(cfg, seed + 3, td, dev)
        log(f"  wall: adm/s={wall['admissions_per_s']:.1f} "
            f"held={wall['slo']['held']} k={wall['slo']['k_values']}")
        scenarios.release()

    all_ok = (parity["decisions_identical"]
              and kill["decisions_identical"] and kill["digests_match"]
              and kill["lost_accepted_submissions"] == 0
              and kill["duplicated_admissions"] == 0
              and drain["clean"] and drain["wal_flushed"]
              and wall["slo"]["held"])
    return {
        "metric": "serve_soak_wall_admissions_per_s",
        "unit": "admissions/s",
        "value": wall["admissions_per_s"],
        "cqs": cfg["cqs"],
        "seed": seed,
        "quick": bool(args.quick),
        "mesh": mesh_info(0, dev),
        "config": cfg,
        "wall": wall,
        "kill_restart": kill,
        "drain": drain,
        "parity": parity,
        "all_ok": all_ok,
        "elapsed_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    tail = run(args)
    print(json.dumps(tail, sort_keys=True))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(tail, fh, indent=1, sort_keys=True)
        log(f"wrote {args.out} (all_ok={tail['all_ok']}, "
            f"{tail['elapsed_s']:.1f}s)")
    return 0 if tail["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
