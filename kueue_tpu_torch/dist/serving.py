"""LocalQueue-sharded multi-process serving helpers.

The distributed front-end splits the admission service by its natural
partition key — the heap-per-ClusterQueue (PAPER.md L3): every
LocalQueue routes to exactly one shard process, whole cohorts stay
together (quota borrowing never crosses a shard), and each shard runs
a full ``AdmissionService`` over its own ``IngestJournal`` +
``CycleWAL``.  Because CQs outside a shard's cohorts receive no
submissions and an empty CQ admits nothing, the union of per-shard
decisions equals the single-process control bit for bit — the
dist-soak's parity arms enforce exactly that.

This module holds everything both ends need: the shard router, the
cluster topology builder (shared with the single-process control so
parity is by construction), shard-process build/recover, and the
parent-side :class:`ShardClient` that submits and drives lockstep
steps over HTTP.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
import zlib
from typing import Optional

from ..api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    PodSet,
    PreemptionPolicy,
    QueueingStrategy,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from ..controller.driver import Driver
from ..serving import AdmissionService, ServiceConfig, recover_service
from ..utils.journal import CycleWAL, IngestJournal

#: cohort width of the soak topology (cluster_spec groups cq-q into
#: cohort co-(q//4)); the shard router keys on it so borrowing repos
#: never straddle shards
COHORT_WIDTH = 4


class VirtualClock:
    """The soaks' mutable virtual clock (shared shape with
    scripts/serve_soak.py so services built either side tick alike)."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def cluster_spec(n_cqs: int):
    """The serve-soak topology: cohorts of 4, 4000m cpu each,
    BEST_EFFORT_FIFO, lq-N → cq-N.  Defined here so shard children and
    the single-process control build identical clusters from the same
    function."""
    def fn(d):
        d.apply_resource_flavor(ResourceFlavor(name="default"))
        for q in range(n_cqs):
            name = f"cq-{q}"
            d.apply_cluster_queue(ClusterQueue(
                name=name, cohort=f"co-{q // COHORT_WIDTH}",
                queueing_strategy=QueueingStrategy.BEST_EFFORT_FIFO,
                preemption=PreemptionPolicy(),
                resource_groups=[ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[FlavorQuotas(name="default", resources={
                        "cpu": ResourceQuota(nominal=4000)})])]))
            d.apply_local_queue(LocalQueue(name=f"lq-{q}",
                                           cluster_queue=name))
    return fn


def shard_of(queue_name: str, n_shards: int) -> int:
    """Route a LocalQueue to its front-end shard.

    ``lq-q`` routes by cohort (``(q // COHORT_WIDTH) % n_shards``) so
    every CQ that can borrow from a cohort-mate lands on the same
    shard; non-numeric names fall back to a stable content hash."""
    if n_shards <= 1:
        return 0
    if queue_name.startswith("lq-"):
        try:
            q = int(queue_name[3:])
            return (q // COHORT_WIDTH) % n_shards
        except ValueError:
            pass
    return zlib.crc32(queue_name.encode()) % n_shards


def workload_of(payload: dict) -> Workload:
    """Rebuild the exact workload a shard ingested from its journaled
    accept payload (the same construction as
    ``AdmissionService._workload_of``, timestamps included)."""
    return Workload(
        name=payload["name"], namespace=payload["namespace"],
        queue_name=payload["queue_name"], priority=payload["priority"],
        creation_time=payload["creation_time"],
        pod_sets=[PodSet(name="main", count=payload["count"],
                         requests=dict(payload["requests"]))])


def shard_paths(state_dir: str, shard_id: int) -> tuple[str, str]:
    return (f"{state_dir}/shard{shard_id}.wal",
            f"{state_dir}/shard{shard_id}.ingest")


def _shard_config(dt_s: float, epoch_t: float, journal_path: str,
                  high_water: int) -> ServiceConfig:
    # k_max=1 pins the deterministic lockstep arms, exactly like the
    # serve-soak kill arms; compaction stays off WAL-side so a killed
    # shard can replay its full decision history
    return ServiceConfig(dt_s=dt_s, k_max=1, journal_path=journal_path,
                         high_water=high_water, epoch_t=epoch_t)


def build_shard_service(shard_id: int, n_cqs: int, state_dir: str,
                        dt_s: float = 1.0, epoch_t: float = 1000.0,
                        high_water: int = 1 << 20, device: str = "cuda"
                        ) -> tuple[AdmissionService, VirtualClock]:
    """Fresh shard process: full topology (parity by construction — CQs
    of other shards stay empty), durable per-shard WAL + ingest
    journal."""
    wal_path, journal_path = shard_paths(state_dir, shard_id)
    clock = VirtualClock(epoch_t)
    d = Driver(clock=clock, device=device)
    cluster_spec(n_cqs)(d)
    wal = CycleWAL(wal_path, compact_every=0)
    d.attach_wal(wal)
    svc = AdmissionService(
        d, config=_shard_config(dt_s, epoch_t, journal_path, high_water),
        wal=wal)
    return svc, clock


def recover_shard_service(shard_id: int, n_cqs: int, state_dir: str,
                          resume_cycle: int, dt_s: float = 1.0,
                          epoch_t: float = 1000.0,
                          high_water: int = 1 << 20, device: str = "cuda"
                          ) -> tuple[AdmissionService, VirtualClock]:
    """Rebuild a SIGKILLed shard from its durable journals alone.

    The initial store is every applied, non-shed accept payload from
    the ingest journal; the WAL's committed history replays every
    decision since onto it (``replay_history``), then
    ``recover_service`` rolls the uncommitted tail forward and
    re-enqueues the accepted-but-unapplied suffix.  ``resume_cycle``
    (the step count at kill, known to the lockstep parent) positions
    the virtual clock so cycle accounting continues where the dead
    process stopped."""
    wal_path, journal_path = shard_paths(state_dir, shard_id)
    wal = CycleWAL.resume(wal_path)
    jr = IngestJournal.load(journal_path)
    store: dict[str, Workload] = {}
    for rec in jr.accepted:
        if rec["seq"] in jr.shed_seqs or rec["seq"] > jr.applied_upto:
            continue
        wl = workload_of(rec["wl"])
        store[wl.key] = wl
    wal.replay_history(store)
    clock = VirtualClock(epoch_t + resume_cycle * dt_s)
    d = Driver(clock=clock, device=device)
    cluster_spec(n_cqs)(d)
    svc = recover_service(
        d, list(store.values()), wal,
        config=_shard_config(dt_s, epoch_t, journal_path, high_water),
        journal_path=journal_path)
    return svc, clock


def step_payloads(step: int, submitter_id: int, n_submitters: int,
                  per_step: int, n_cqs: int,
                  runtime_s: float = 3.0) -> list[dict]:
    """The deterministic submission schedule: the payloads submitter
    ``submitter_id`` sends at lockstep barrier ``step``.

    Both sides of every parity check call this — the submitter child
    processes and the single-process control — so the distributed run
    and its control receive byte-identical workloads by construction.
    Global index = ``(step * n_submitters + submitter_id) * per_step +
    i`` keeps names unique across submitters and steps; queues
    round-robin over all LocalQueues so every shard sees traffic."""
    out = []
    for i in range(per_step):
        idx = (step * n_submitters + submitter_id) * per_step + i
        name = f"wl-{idx}"
        out.append({"name": name, "namespace": "default",
                    "queue_name": f"lq-{idx % n_cqs}", "priority": 0,
                    "requests": {"cpu": 1000}, "count": 1,
                    "runtime_s": runtime_s,
                    "token": f"default/{name}"})
    return out


class ShardClient:
    """Parent-side HTTP client for one shard (or service) process:
    submits through the public serving API and drives the lockstep
    ``/admin`` barriers.  Submissions retry through connect-refused
    and reset windows (a shard mid-restart) under a wall deadline —
    idempotent tokens make the retry safe and the dedupe observable."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 10.0):
        self.base_url = f"http://{host}:{port}"
        self.timeout = timeout
        self.stats = {"requests": 0, "retries": 0}

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              retry_deadline_s: float = 0.0):
        deadline = time.monotonic() + retry_deadline_s
        while True:
            self.stats["requests"] += 1
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(
                self.base_url + path, data=data, method=method,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout) as resp:
                    payload = resp.read()
                return json.loads(payload) if payload else None
            except urllib.error.HTTPError as e:
                # 429/503 are application outcomes, not transport faults
                payload = e.read()
                try:
                    return json.loads(payload) if payload else None
                except json.JSONDecodeError:
                    return None
            except Exception as e:
                import http.client
                transient = isinstance(
                    e, (OSError, http.client.HTTPException))
                if not transient or time.monotonic() >= deadline:
                    raise
                self.stats["retries"] += 1
                time.sleep(0.05)

    # -- public serving API --

    def submit(self, body: dict, retry_deadline_s: float = 0.0) -> dict:
        return self._call("POST", "/apis/serving/v1/submit", body,
                          retry_deadline_s=retry_deadline_s)

    def svc_stats(self) -> dict:
        return self._call("GET", "/apis/serving/v1/stats")

    def position(self, token: str) -> dict:
        from urllib.parse import quote
        return self._call(
            "GET", f"/apis/serving/v1/position?token={quote(token, safe='')}")

    # -- lockstep barriers --

    def step(self, retry_deadline_s: float = 0.0) -> dict:
        return self._call("POST", "/admin/step", {},
                          retry_deadline_s=retry_deadline_s)

    def drain(self) -> dict:
        return self._call("POST", "/admin/drain", {})

    def digest(self) -> dict:
        return self._call("GET", "/admin/digest")

    def ready(self) -> bool:
        try:
            return self._call("GET", "/readyz") is not None
        except (urllib.error.URLError, OSError, ConnectionError):
            return False
