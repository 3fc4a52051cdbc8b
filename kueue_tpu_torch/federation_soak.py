"""Federation soak of the port: N-cluster MultiKueue under fire at 1,000
CQs on the torch device (the JAX package's ``scripts/federation_soak.py``,
every flag, scenario and JSON key kept).

Every scenario runs two arms of the seeded federation sim
(``federation.sim``) from identical specs and identical traffic:

  control — fault-free;
  faulted — the same federation with a seeded ChaosInjector armed.

A scenario passes only if the faulted arm converges back to the control
arm after the fault clears (``decisions_stable``):

  strict parity   — the post-recovery global state (manager + every
                    worker, conditions and timestamps included) is
                    bit-identical to the control arm's
                    (partition/rejoin, duplicate storms, worker crash);
  outcome parity  — the same workloads finish with zero invariant
                    violations (permanent cluster loss: the ejection
                    timing is the fault, so timestamps shift by design,
                    but nothing may be lost or run twice).

Both arms also carry the sim's per-step invariant sampling: no key is
ever quota-reserved on two ACTIVE clusters (double admission) and no key
ever finishes on two workers (double execution).

    python -m kueue_tpu_torch.federation_soak [--cqs 1000] [--workers 4]
        [--seed N] [--quick] [--only a,b] [--out PATH]
        [--torch-device cuda|cpu]

The manager and every worker are Drivers on the device solver on
``--torch-device`` (``FedSpec(device=...)``; default ``cuda``: the CUDA
kernels; ``cpu``: their plain versions); without a GPU and without
``--torch-device cpu`` the run raises.  Events are 5 x the CQs.  The
base seed comes from ``--seed`` or KUEUE_TPU_FED_SEED (default 1511);
scenario i uses seed+i, so any single scenario replays in isolation.
Prints progress on stderr and the JSON tail as the last line of stdout
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

from . import scenarios
from .features import env_value
from .federation.sim import global_digest, outcome
from .ops.solver import resolve_device
from .perf.harness import chaos_report
from .scenarios import log


def run_arm(m, cfg, seed, wal_dir, arm=None, **spec_kw):
    """One sim arm (``scenarios.fed_arm``).  Chaos is armed only after
    construction + traffic load, so site hit counts line up with
    ``step()``'s consult points → (sim, settled, injector or None)."""
    armed = {}

    def arm_it(inj):
        armed["inj"] = inj
        arm(inj)
    sim, settled = scenarios.fed_arm(
        cfg, seed, wal_dir, arm_it if arm is not None else None, m=m,
        **spec_kw)
    return sim, settled, armed.get("inj")


class Checker:
    def __init__(self):
        self.failures: list[str] = []

    def check(self, ok, msg):
        if not ok:
            self.failures.append(msg)
        return ok


def _parity(ck, control, faulted, mode):
    """The convergence verdict both parity levels share."""
    ck.check(faulted.violations == [],
             f"invariant violations: {faulted.violations[:2]}")
    ck.check(control.violations == [], "control arm violated invariants")
    if mode == "strict":
        ck.check(global_digest(faulted) == global_digest(control),
                 "post-recovery global state diverged from the "
                 "fault-free control")
    else:
        ck.check(outcome(faulted) == outcome(control),
                 "finish set diverged from the fault-free control")
        ck.check(all(outcome(faulted).values()),
                 "workloads left unfinished after failover")


def _result(ck, control, faulted, inj, mode, extra=None):
    out = {
        "decisions_stable": not ck.failures,
        "failures": ck.failures,
        "parity": mode,
        "double_admissions": scenarios.fed_double_admissions(faulted),
        "ingested": faulted.ingested,
        "finished": sum(1 for v in outcome(faulted).values() if v),
        "spread": faulted.assignment_spread(),
        "counters": dict(faulted.counters),
        "state_digest": {"control": global_digest(control),
                         "faulted": global_digest(faulted)},
        "chaos": chaos_report(injector=inj),
        "obs": faulted.manager.obs.report(),
    }
    out.update(extra or {})
    return out


def _settled(ck, ok_c, ok_f):
    ck.check(ok_c and ok_f, f"arm did not settle "
             f"(control={ok_c}, faulted={ok_f})")


def scenario_partition_during_nominate(cfg, seed, td, m):
    """Sever two clusters between nomination/admission and winner
    selection (the mid-step consult), heal after 3 steps: the rejoin
    reconciliation must delete exactly the stale mirrors the control
    deleted at winner time, bit-identically."""
    control, ok_c, _i = run_arm(m, cfg, seed, os.path.join(td, "c"))
    victims = tuple(control.worker_names[-2:])
    at_step = max(2, cfg["steps"] // 3)
    faulted, ok_f, inj = run_arm(
        m, cfg, seed, os.path.join(td, "f"),
        arm=lambda i: i.arm("fed.partition", at=2 * at_step,
                            action="partition", payload=(victims, 3)))
    ck = Checker()
    _settled(ck, ok_c, ok_f)
    ck.check(faulted.counters["partitions"] >= 1, "partition never fired")
    ck.check(faulted.counters["heals"] >= 1, "partition never healed")
    ck.check(all(c.active for c in faulted.clusters.values()),
             "a cluster never rejoined")
    _parity(ck, control, faulted, "strict")
    return _result(ck, control, faulted, inj, "strict",
                   {"victims": list(victims), "partition_step": at_step})


def scenario_duplicate_watch_storm(cfg, seed, td, m):
    """At-least-once delivery storm: watch resume tokens held back so
    whole batches re-deliver, plus doubled mutations on the transport.
    Every replay must be absorbed — strict parity against a control
    running the same (quiet) transport wrapper."""
    control, ok_c, _i = run_arm(m, cfg, seed, os.path.join(td, "c"),
                                chaos_transport=True, drift_every=4)
    faulted, ok_f, inj = run_arm(
        m, cfg, seed, os.path.join(td, "f"),
        chaos_transport=True, drift_every=4,
        arm=lambda i: (
            i.arm("remote.duplicate_event", prob=0.25,
                  times=cfg["storm_times"], action="duplicate"),
            i.arm("remote.duplicate", prob=0.05,
                  times=cfg["storm_times"], action="duplicate")))
    ck = Checker()
    _settled(ck, ok_c, ok_f)
    _parity(ck, control, faulted, "strict")
    return _result(ck, control, faulted, inj, "strict",
                   {"storm_times": cfg["storm_times"]})


def scenario_worker_crash_mid_sync(cfg, seed, td, m):
    """Kill a worker between its WAL append and the admit mutation,
    rebuild it from store + journal tail the same virtual second, and
    re-run the interrupted cycle: the watch epoch change forces a
    resync and the recovered federation must match control exactly."""
    control, ok_c, _i = run_arm(m, cfg, seed, os.path.join(td, "c"))
    at_step = max(2, cfg["steps"] // 3)
    faulted, ok_f, inj = run_arm(
        m, cfg, seed, os.path.join(td, "f"),
        arm=lambda i: i.arm("fed.worker_crash", at=at_step,
                            payload=control.worker_names[0]))
    ck = Checker()
    _settled(ck, ok_c, ok_f)
    ck.check(faulted.counters["worker_crashes"] == 1,
             "worker crash never fired")
    ck.check(faulted.counters["mid_admit_crashes"] >= 1,
             "the crash missed the journaled-but-unapplied window")
    ck.check(faulted.counters["wal_tail_replayed"] >= 1,
             "recovery never replayed the WAL tail")
    _parity(ck, control, faulted, "strict")
    return _result(ck, control, faulted, inj, "strict",
                   {"crash_step": at_step})


def scenario_cluster_loss_permanent(cfg, seed, td, m):
    """Destroy a cluster outright: everything it held must be ejected
    (pending deletes queued, checks back to Retry) and re-dispatched to
    the survivors exactly once.  Outcome parity: the ejection timing is
    the fault, so timestamps shift, but the same workloads finish and
    nothing runs twice."""
    control, ok_c, _i = run_arm(m, cfg, seed, os.path.join(td, "c"),
                                worker_lost_timeout=2.0)
    at_step = max(2, cfg["steps"] // 3)
    faulted, ok_f, inj = run_arm(
        m, cfg, seed, os.path.join(td, "f"), worker_lost_timeout=2.0,
        arm=lambda i: i.arm("fed.cluster_loss", at=at_step,
                            payload=control.worker_names[0]))
    ck = Checker()
    _settled(ck, ok_c, ok_f)
    ck.check(faulted.counters["losses"] == 1, "cluster loss never fired")
    ck.check(faulted.counters["ejections"] >= 1,
             "nothing was ejected off the dead cluster")
    lost = control.worker_names[0]
    ck.check(not faulted.clusters[lost].active,
             "the destroyed cluster came back")
    ck.check(all(len(ws) == 1 for ws in faulted._finished_on.values()),
             "a workload executed on two workers")
    _parity(ck, control, faulted, "outcome")
    return _result(ck, control, faulted, inj, "outcome",
                   {"lost_cluster": lost, "loss_step": at_step})


SCENARIOS = [
    ("partition_during_nominate", scenario_partition_during_nominate),
    ("duplicate_watch_storm", scenario_duplicate_watch_storm),
    ("worker_crash_mid_sync", scenario_worker_crash_mid_sync),
    ("cluster_loss_permanent", scenario_cluster_loss_permanent),
]

HARD_PATHS = [
    "fed.partition between nomination and winner selection",
    "half-open try_reconnect + reconcile_rejoined stale-mirror GC",
    "remote.duplicate_event resume-token holdback",
    "remote.duplicate doubled mutations",
    "fed.worker_crash wal.admit tail replay + watch epoch resync",
    "fed.cluster_loss ejection + exactly-once re-dispatch",
]


def decided(tail: dict) -> dict:
    """What a tail decided, without its walls: each scenario's verdict,
    counters, spread, chaos record and control / faulted digests."""
    return {name: {k: v for k, v in s.items()
                   if k not in ("wall_s", "obs")}
            for name, s in tail["scenarios"].items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cqs", type=int, default=1000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int,
                    default=int(env_value("KUEUE_TPU_FED_SEED", "1511")))
    ap.add_argument("--quick", action="store_true",
                    help="tiny federation for a fast functional pass")
    ap.add_argument("--only", default=None,
                    help="comma-separated scenario names")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the Drivers (cuda: the CUDA "
                         "kernels; cpu: their plain versions)")
    return ap


def config(cqs: int, workers: int) -> dict:
    return {
        "cqs": cqs,
        "remote_cqs": max(2, cqs // 4),
        "workers": workers,
        "events": 5 * cqs,
        "rate": max(4.0, cqs / 2.0),   # ~10 virtual seconds of arrivals
        "steps": 12,
        "drain_max": 400,
        "storm_times": 30 * workers if cqs <= 16 else 400,
    }


def run(args) -> dict:
    """Every scenario the flags ask for → the JSON tail."""
    m = scenarios.serving_modules(resolve_device(args.torch_device))
    cqs = 16 if args.quick else args.cqs
    cfg = config(cqs, args.workers)
    only = set(args.only.split(",")) if args.only else None

    gc.collect()
    out: dict[str, dict] = {}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="federation_soak_") as td:
        for i, (name, fn) in enumerate(SCENARIOS):
            if only and name not in only:
                continue
            m.chaos.clear()
            log(f"[{i + 1}/{len(SCENARIOS)}] {name} "
                f"(cqs={cqs}, workers={cfg['workers']}, "
                f"seed={args.seed + i}) ...")
            t0 = time.perf_counter()
            try:
                res = fn(cfg, args.seed + i, os.path.join(td, name), m)
            except Exception as e:   # a scenario bug is a failed scenario
                res = {"decisions_stable": False, "parity": "strict",
                       "double_admissions": 0,
                       "failures": [f"{type(e).__name__}: {e}"]}
            finally:
                m.chaos.clear()
            res["wall_s"] = round(time.perf_counter() - t0, 2)
            res["seed"] = args.seed + i
            out[name] = res
            ok = res["decisions_stable"]
            log(f"    {'converged' if ok else 'DIVERGED'} "
                f"({res['wall_s']}s)"
                + ("" if ok else f" — {res['failures'][:3]}"))
            scenarios.release()

    stable = sum(1 for v in out.values() if v["decisions_stable"])
    return {
        "metric": "federation_soak_recovery_parity",
        "unit": "fault arms converged to the fault-free control",
        "cqs": cqs,
        "remote_cqs": cfg["remote_cqs"],
        "workers": cfg["workers"],
        "events": cfg["events"],
        "seed": args.seed,
        "scenarios": out,
        "scenarios_total": len(out),
        "scenarios_stable": stable,
        "all_stable": stable == len(out) and len(out) > 0,
        "double_admissions_total": sum(
            v.get("double_admissions", 0) for v in out.values()),
        "value": stable,
        "elapsed_s": round(time.perf_counter() - t_start, 2),
        # the first scenario's manager-side obs block stands for the run
        "obs": next((v["obs"] for v in out.values() if "obs" in v), None),
        "hard_paths_exercised": list(HARD_PATHS),
    }


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.workers < 2:
        ap.error("--workers must be >= 2 (failover needs a survivor)")
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
