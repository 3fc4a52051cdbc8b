"""``python -m kueue_tpu_torch.dist.child`` — the supervised process body.

Every child of a distributed run executes this module with a
``--role``:

- ``shard``: one LocalQueue-sharded admission front-end — a full
  ``AdmissionService`` over its own ``IngestJournal`` + ``CycleWAL``,
  served by ``VisibilityServer`` with the lockstep ``/admin``
  endpoints enabled.  ``--recover --resume-cycle N`` rebuilds the
  state a SIGKILLed predecessor left in ``--state-dir``.
- ``worker``: one federation worker — a Driver with the worker
  topology behind a ``WorkerServer`` (manifest journal + WAL make it
  recoverable the same way).
- ``submitter``: a lockstep traffic source driven over stdin
  (``step S`` / ``resync S`` / ``blast N`` / ``stats`` / ``exit``),
  submitting the deterministic :func:`~.serving.step_payloads`
  schedule through each shard's public HTTP API with idempotent
  tokens.

Port handoff: servers write their bound port to ``--port-file``
*after* bind (atomic rename), which is what the supervisor's
``wait_ready`` polls — no guessed sleeps anywhere.  ``--crash-site``
arms this process's own chaos injector; an ``InjectedCrash`` escaping
the wrapped step turns into ``os._exit(17)`` — a real mid-cycle
process death, not an exception a handler could swallow.

``--device`` (default ``cuda``) is where the shard's and the worker's
Driver run; on ``cuda`` without a usable GPU the child raises and
dies, which the supervisor's ``wait_ready`` reports.  ``--stats-file``
makes a shard or a worker write, after each of its steps, its kernel
launch counts, the seconds it spent building the kernel library (null
when it only loaded it) and whether it holds a CUDA context.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Optional

#: exit code a chaos-crashed child dies with (distinguishes an armed
#: InjectedCrash from a genuine fault in soak triage)
CRASH_EXIT = 17


def _write_port_file(path: str, port: int) -> None:
    """Atomic bound-port handoff: the supervisor never reads a torn
    write."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(str(port))
    os.replace(tmp, path)


def _arm_crash(site: str, at: int) -> None:
    """Install this process's own injector with one armed crash."""
    from ..chaos import injector as chaos
    inj = chaos.ChaosInjector(seed=0)
    inj.arm(site, at=at)
    chaos.install(inj)


def _dying(fn):
    """Wrap a step function so an armed InjectedCrash kills the whole
    process (SIGKILL-equivalent: no cleanup, no flush)."""
    from ..chaos.injector import InjectedCrash

    def wrapper(*a, **kw):
        try:
            return fn(*a, **kw)
        except InjectedCrash:
            os._exit(CRASH_EXIT)
    return wrapper


def _reporting(fn, path: str):
    """Wrap a step function so that after each call the process writes
    what ``--stats-file`` reports to ``path`` (atomic rename)."""
    import torch

    from .. import kernels

    def wrapper(*a, **kw):
        out = fn(*a, **kw)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"pid": os.getpid(), "launches": kernels.LAUNCHES,
                       "build_s": kernels.BUILD["seconds"],
                       "cuda_initialized": torch.cuda.is_initialized()}, f)
        os.replace(tmp, path)
        return out
    return wrapper


def _serve_forever() -> None:
    threading.Event().wait()


# ---------------------------------------------------------------------------
# Roles
# ---------------------------------------------------------------------------

def run_shard(args) -> int:
    from ..visibility import VisibilityServer
    from .serving import build_shard_service, recover_shard_service
    if args.recover:
        svc, _clock = recover_shard_service(
            args.shard_id, args.n_cqs, args.state_dir,
            resume_cycle=args.resume_cycle, dt_s=args.dt_s,
            epoch_t=args.epoch_t, high_water=args.high_water,
            device=args.device)
    else:
        svc, _clock = build_shard_service(
            args.shard_id, args.n_cqs, args.state_dir, dt_s=args.dt_s,
            epoch_t=args.epoch_t, high_water=args.high_water,
            device=args.device)
    if args.stats_file:
        svc.step = _reporting(svc.step, args.stats_file)
    if args.crash_site:
        _arm_crash(args.crash_site, args.crash_at)
        svc.step = _dying(svc.step)
    server = VisibilityServer(svc.driver, port=args.port,
                              admission=svc, admin=True)
    port = server.start()
    if args.port_file:
        _write_port_file(args.port_file, port)
    _serve_forever()
    return 0


def run_worker(args) -> int:
    from ..remote import WorkerServer
    from .worker import build_worker, recover_worker
    if args.recover:
        d, clock, _wal, journal, _n = recover_worker(
            args.name, args.remote_cqs, args.state_dir,
            quota_m=args.quota_m, epoch_t=args.epoch_t,
            resume_t=args.resume_t, device=args.device)
    else:
        d, clock, _wal, journal = build_worker(
            args.name, args.remote_cqs, args.state_dir,
            quota_m=args.quota_m, epoch_t=args.epoch_t, device=args.device)
    if args.stats_file:
        d.schedule_once = _reporting(d.schedule_once, args.stats_file)
    if args.crash_site:
        _arm_crash(args.crash_site, args.crash_at)
        d.schedule_once = _dying(d.schedule_once)
    server = WorkerServer(d, port=args.port, journal=journal,
                          admin=True, clock=clock)
    server.start()
    if args.port_file:
        _write_port_file(args.port_file, server.port)
    _serve_forever()
    return 0


def run_submitter(args) -> int:
    from .serving import ShardClient, shard_of, step_payloads
    ports = [int(p) for p in args.shard_ports.split(",") if p]
    clients = [ShardClient(p, timeout=args.timeout) for p in ports]
    n_shards = len(clients)
    counts = {"submitted": 0, "accepted": 0, "duplicates": 0,
              "rejected": 0, "blasted": 0}
    blast_seq = 0

    def submit_one(body: dict) -> None:
        shard = shard_of(body["queue_name"], n_shards)
        res = clients[shard].submit(
            body, retry_deadline_s=args.retry_deadline) or {}
        counts["submitted"] += 1
        status = res.get("status")
        if res.get("duplicate"):
            counts["duplicates"] += 1
        elif status == "accepted":
            counts["accepted"] += 1
        else:
            counts["rejected"] += 1

    def submit_step(step: int) -> None:
        for body in step_payloads(step, args.submitter_id,
                                  args.n_submitters, args.per_step,
                                  args.n_cqs, runtime_s=args.runtime_s):
            submit_one(body)

    print("ready", flush=True)
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0]
        if cmd == "step":
            step = int(parts[1])
            before = counts["accepted"]
            submit_step(step)
            print(f"done {step} {counts['accepted'] - before} "
                  f"{counts['duplicates']}", flush=True)
        elif cmd == "resync":
            # resubmit every payload of steps 0..S-1; idempotent
            # tokens turn the replays into observable dedupes
            upto = int(parts[1])
            before_dup = counts["duplicates"]
            for step in range(upto):
                submit_step(step)
            print(f"resynced {upto} "
                  f"{counts['duplicates'] - before_dup}", flush=True)
        elif cmd == "blast":
            # wall-clock saturation lane: n uniquely-named submissions
            # round-robin over every queue, as fast as the wire allows
            n = int(parts[1])
            t0 = time.monotonic()
            before = counts["accepted"]
            for _ in range(n):
                idx = blast_seq
                blast_seq += 1
                name = f"bl-{args.submitter_id}-{idx}"
                submit_one({
                    "name": name, "namespace": "default",
                    "queue_name": f"lq-{idx % args.n_cqs}",
                    "priority": 0, "requests": {"cpu": 1000},
                    "count": 1, "runtime_s": args.runtime_s,
                    "token": f"default/{name}"})
            counts["blasted"] += n
            print(f"blasted {n} {counts['accepted'] - before} "
                  f"{time.monotonic() - t0:.6f}", flush=True)
        elif cmd == "stats":
            out = dict(counts)
            out["requests"] = sum(c.stats["requests"] for c in clients)
            out["retries"] = sum(c.stats["retries"] for c in clients)
            print(json.dumps(out), flush=True)
        elif cmd == "exit":
            print("bye", flush=True)
            return 0
        else:
            print(f"err unknown command {cmd!r}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="kueue_tpu_torch.dist.child")
    ap.add_argument("--role", required=True,
                    choices=["shard", "worker", "submitter"])
    # common / servers
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default="")
    ap.add_argument("--state-dir", default=".")
    ap.add_argument("--recover", type=int, default=0)
    ap.add_argument("--crash-site", default="")
    ap.add_argument("--crash-at", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stats-file", default="")
    # shard
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--n-cqs", type=int, default=8)
    ap.add_argument("--dt-s", type=float, default=1.0)
    ap.add_argument("--epoch-t", type=float, default=1000.0)
    ap.add_argument("--high-water", type=int, default=1 << 20)
    ap.add_argument("--resume-cycle", type=int, default=0)
    # worker
    ap.add_argument("--name", default="w0")
    ap.add_argument("--remote-cqs", type=int, default=4)
    ap.add_argument("--quota-m", type=int, default=4000)
    ap.add_argument("--resume-t", type=float, default=None)
    # submitter
    ap.add_argument("--submitter-id", type=int, default=0)
    ap.add_argument("--n-submitters", type=int, default=1)
    ap.add_argument("--per-step", type=int, default=4)
    ap.add_argument("--shard-ports", default="")
    ap.add_argument("--runtime-s", type=float, default=3.0)
    ap.add_argument("--retry-deadline", type=float, default=10.0)
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    if args.role == "shard":
        return run_shard(args)
    if args.role == "worker":
        return run_worker(args)
    return run_submitter(args)


if __name__ == "__main__":
    sys.exit(main())
