"""Distributed control-plane soak of the port: real processes, real
sockets, kills (the JAX package's ``scripts/dist_soak.py``, every flag,
arm and JSON key kept).

The control plane splits across OS processes: submitter processes
hammer front-end shard processes through ``POST
/apis/serving/v1/submit``, federation workers run as ``WorkerServer``
processes behind ``HttpWorkerClient`` (through a ``SocketFaultProxy``),
and a seeded ``ProcessSupervisor`` SIGKILLs them on a deterministic
``dist.kill`` schedule.  Arms, one tail:

  saturation     — wall-clock throughput search: every submitter blasts
                   uniquely named submissions, the shards drain them
                   through real ``/admin/step`` cycles, and the round
                   doubles until admissions/s stops rising by 5%;
  kills          — submitter, front_end_shard, service_mid_cycle and
                   federation_worker: each recovers with zero lost and
                   zero duplicated admissions and decisions identical
                   to a single-process control fed the same schedule;
  socket_faults  — the proxy's wire faults against the client's retry
                   classification.

    python -m kueue_tpu_torch.dist_soak [--seed N] [--shards N]
        [--submitters N] [--workers N] [--quick] [--out PATH]
        [--torch-device cuda|cpu]

Every child starts as ``python -m kueue_tpu_torch.dist.child``
(``dist.supervisor.child_argv``): shard and worker children with
``--device`` set to ``--torch-device`` and a ``--stats-file``;
submitters build no Driver.  The in-process controls (a shard service,
the ``FederationSim``) and the federation manager run on
``--torch-device`` too (default ``cuda``: the CUDA kernels; ``cpu``:
their plain versions); without a GPU and without ``--torch-device cpu``
the run raises.  The seed and the process counts come from the flags
or ``KUEUE_TPU_DIST_*`` (``features.env_int``); arm i runs on seed + i.
Prints progress on stderr and the JSON tail as the last line of stdout
(also written to ``--out``); exits 0 when ``all_ok``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from . import scenarios
from .features import env_int
from .ops.solver import resolve_device
from .scenarios import log

#: seconds a child may take from spawn to ready (a child on the card
#: imports torch and opens the kernel library first)
READY_S = 120.0

#: the script's keys of each arm
KEYS = {
    "saturation": ("wall_clock", "rounds", "ceiling_admissions_per_s",
                   "submitter_procs", "shard_procs", "shard_depths", "ok"),
    "front_end_shard": ("killed", "same_port", "steps", "admissions",
                        "decisions_identical", "parity", "lost",
                        "duplicated", "dedupe", "restarts", "ok"),
    "submitter": ("killed", "steps", "admissions", "decisions_identical",
                  "parity", "lost", "duplicated", "dedupe", "restarts",
                  "ok"),
    "service_mid_cycle": ("crashes", "crash_exit", "steps", "admissions",
                          "decisions_identical", "parity", "lost",
                          "duplicated", "restarts", "ok"),
    "federation_worker": ("killed", "steps", "manager_parity",
                          "worker_parity", "decisions_identical", "parity",
                          "settled", "lost", "duplicated", "epoch_resyncs",
                          "client_stats", "proxy", "restarts", "metrics",
                          "ok"),
    "socket_faults": ("proxy", "client", "refused_kind", "refused_retries",
                      "ok"),
}

#: the arms in the script's order (``main``), each with its seed offset
ARMS = (("saturation", scenarios.dist_saturation),
        ("front_end_shard", scenarios.dist_kill_front_end_shard),
        ("submitter", scenarios.dist_kill_submitter),
        ("service_mid_cycle", scenarios.dist_kill_service_mid_cycle),
        ("federation_worker", scenarios.dist_kill_federation_worker),
        ("socket_faults", scenarios.dist_socket_faults))

#: what each arm decided, beside its walls (``decided``)
DECIDED = {
    "front_end_shard": ("killed", "same_port", "steps", "admissions",
                        "decisions_identical", "lost", "duplicated",
                        "dedupe", "restarts"),
    "submitter": ("killed", "steps", "admissions", "decisions_identical",
                  "lost", "duplicated", "dedupe", "restarts"),
    "service_mid_cycle": ("crashes", "crash_exit", "steps", "admissions",
                          "decisions_identical", "lost", "duplicated",
                          "restarts"),
    "federation_worker": ("killed", "steps", "manager_parity",
                          "worker_parity", "settled", "lost", "duplicated",
                          "epoch_resyncs", "restarts"),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int,
                    default=env_int("KUEUE_TPU_DIST_SEED"))
    ap.add_argument("--shards", type=int,
                    default=env_int("KUEUE_TPU_DIST_SHARDS"))
    ap.add_argument("--submitters", type=int,
                    default=env_int("KUEUE_TPU_DIST_SUBMITTERS"))
    ap.add_argument("--workers", type=int,
                    default=env_int("KUEUE_TPU_DIST_WORKERS"))
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: small blasts, short lockstep arms")
    ap.add_argument("--out", default=None,
                    help="also write the JSON tail to this file")
    ap.add_argument("--torch-device", default="cuda",
                    help="the torch device of the shard and worker "
                         "children, the controls and the manager (cuda: "
                         "the CUDA kernels; cpu: their plain versions)")
    return ap


def config(args) -> dict:
    """The script's ``cfg`` (``main``), unchanged."""
    return {
        "cqs": 8,
        "shards": max(2, args.shards),
        "submitters": max(2, args.submitters),
        "workers": max(2, args.workers),
        "per_step": 3 if args.quick else 4,
        "kill_steps": 4 if args.quick else 8,
        "sat_base": 16 if args.quick else 48,
        "sat_max_rounds": 2 if args.quick else 5,
        "sat_drain_cap": 400,
        "fed_cqs": 6,
        "fed_remote_cqs": 4,
        "fed_traffic_steps": 3 if args.quick else 5,
        "fed_pre_kill_steps": 3,
        "fed_post_kill_steps": 4 if args.quick else 7,
        "proxy_reset": 0.03,
        "proxy_latency": 0.05,
    }


def run_arm(name: str, cfg: dict, seed: int, td: str, device: str,
            record: dict | None = None) -> tuple:
    """One arm of ``ARMS`` on ``device`` → (its block with the script's
    keys, its supervisor report); ``record[name]`` gets each child's
    start (spawn to ready, s), last ``--stats-file`` report and argv."""
    fn = dict(ARMS)[name]
    r = fn(dict(cfg, ready_timeout_s=READY_S), seed, td, device=device)
    if record is not None:
        record[name] = {k: r[k] for k in ("starts_s", "child_stats",
                                          "argvs")}
    return {k: r[k] for k in KEYS[name]}, r["report"]


def decided(tail: dict) -> dict:
    """What a tail decided, without its walls: each kill arm's
    admissions, dedupe, crashes and verdicts, the socket arm's proxy
    counts (not its bytes) and client counts, the kill log and the
    processes by role.  The saturation arm is wall-clock throughout, and
    the federation arm's proxy and client counts hang on its 2 s client
    timeout (a worker's slow first cycle on a loaded host adds a retry),
    so neither is in it."""
    sock = tail["socket_faults"]
    return {
        "kills": {arm: {k: tail["kills"][arm][k] for k in keys}
                  for arm, keys in DECIDED.items()},
        "socket_faults": {
            "proxy": {k: v for k, v in sock["proxy"].items()
                      if not k.startswith("bytes")},
            "client": sock["client"], "refused_kind": sock["refused_kind"],
            "refused_retries": sock["refused_retries"], "ok": sock["ok"]},
        "kill_log": tail["dist"]["kill_log"],
        "by_role": tail["dist"]["by_role"],
    }


def headline(tail: dict, record: dict) -> dict:
    """The saturation ceiling and its rounds (n a submitter, accepted,
    drain steps, wall s, admissions/s), and ``all_ok``."""
    sat = tail["saturation"]
    return {"ceiling_admissions_per_s": sat["ceiling_admissions_per_s"],
            "rounds": [[r["n_per_submitter"], r["accepted"],
                        r["drain_steps"], r["elapsed_s"],
                        r["admissions_per_s"]] for r in sat["rounds"]],
            "all_ok": tail["all_ok"]}


def children(tail: dict, record: dict) -> dict:
    """Each arm's children from ``record``: start (spawn to ready, s;
    a restart under "<name> restart"), and from its ``--stats-file``
    whether it held a CUDA context, its launches and its kernel build
    seconds (null: loaded, not built; a child that never stepped has
    no report)."""
    out = {}
    for arm, r in record.items():
        kids = {}
        for name in sorted(set(r["starts_s"]) | set(r["child_stats"])):
            st = r["child_stats"].get(name)
            kids[name] = {"start_s": r["starts_s"].get(name),
                          "cuda": st and st["cuda_initialized"],
                          "launches": st and sum(st["launches"].values()),
                          "build_s": st and st["build_s"]}
        out[arm] = kids
    return out


def _flag(argv: list, name: str):
    return argv[argv.index(name) + 1] if name in argv else None


def check(record: dict) -> list[str]:
    """What ``record`` shows against the contract of the children:
    every argv runs ``kueue_tpu_torch.dist.child``; shards and workers
    take ``--device``, submitters none; every shard reported its steps,
    with a CUDA context and kernel launches exactly when its device is
    the card; a worker that reported holds a context only on the card
    and whenever it launched, and an arm's workers launched on the card.
    (A worker opens its context at its first launch: the socket arm's
    never steps, and a restarted one with nothing left to admit never
    launches.)"""
    out = []
    for arm, r in record.items():
        device = None
        for argv in r["argvs"]:
            role = _flag(argv, "--role")
            if argv[1:3] != ["-m", "kueue_tpu_torch.dist.child"]:
                out.append(f"{arm}: {argv[:3]} is not the port's child")
            if (role == "submitter") != (_flag(argv, "--device") is None):
                out.append(f"{arm}: {role} with --device "
                           f"{_flag(argv, '--device')}")
            device = device or _flag(argv, "--device")
        on_card = str(device).startswith("cuda")
        worker_launches = None
        for name, st in r["child_stats"].items():
            shard = name.startswith("shard")
            if st is None:
                if shard:
                    out.append(f"{arm}: {name} reported no step")
                continue
            n = sum(st["launches"].values())
            ctx = st["cuda_initialized"]
            if not shard:
                worker_launches = (worker_launches or 0) + n
            if (shard and (ctx, n > 0) != (on_card, on_card)) or (
                    not shard and (ctx and not on_card or n > 0 and not ctx)):
                out.append(f"{arm}: {name} CUDA context {ctx}, launches "
                           f"{n} on {device}")
        if on_card and worker_launches == 0:
            out.append(f"{arm}: no worker launched on {device}")
    return out


def run(args, record: dict | None = None) -> dict:
    """Every arm in the script's order → the JSON tail; ``record`` (a
    dict) gets each arm's children (``run_arm``)."""
    device = str(resolve_device(args.torch_device))
    cfg = config(args)
    seed = args.seed
    t0 = time.perf_counter()
    blocks, reports = {}, {}
    with tempfile.TemporaryDirectory(prefix="dist_soak_") as td:
        log(f"dist soak: seed={seed} shards={cfg['shards']} "
            f"submitters={cfg['submitters']} workers={cfg['workers']} "
            f"quick={args.quick} device={device}")
        for i, (name, _fn) in enumerate(ARMS):
            log(f"arm: {name}")
            blocks[name], reports[name] = run_arm(name, cfg, seed + i, td,
                                                  device, record)
            b = blocks[name]
            log(f"  ok={b['ok']}" + (
                f" parity={b['parity']} lost={b['lost']} "
                f"dup={b['duplicated']}" if "parity" in b else ""))
            scenarios.release()
    saturation, sock = blocks["saturation"], blocks["socket_faults"]
    kills = {k: blocks[k] for k in ("submitter", "front_end_shard",
                                    "service_mid_cycle",
                                    "federation_worker")}
    all_ok = (saturation["ok"] and sock["ok"]
              and all(arm["ok"] for arm in kills.values()))
    return {
        "metric": "dist_soak_saturation_admissions_per_s",
        "unit": "admissions/s",
        "value": saturation["ceiling_admissions_per_s"],
        "seed": seed,
        "quick": bool(args.quick),
        "config": cfg,
        "saturation": saturation,
        "kills": kills,
        "socket_faults": sock,
        "dist": scenarios._merge_reports(reports),
        "metrics": kills["federation_worker"].pop("metrics"),
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
        log(f"wrote {args.out}")
    log(f"all_ok={tail['all_ok']} ({tail['elapsed_s']:.1f}s)")
    return 0 if tail["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
