"""Long-lived admission service wrapping ``Driver``.

The batch harnesses feed a pre-built event list through
``Driver.schedule_once`` in one thread with virtual time; this module
is the production shape of the same loop: concurrent submitters, a
durable ingest journal, wall-clock SLOs, overload backpressure,
graceful drain, and crash-restart continuity.

Data path
---------

``submit()`` (any thread) journals an accept record durably
(utils.journal.IngestJournal), then enqueues the submission on the
thread-safe :class:`~kueue_tpu.serving.ingest.IngestQueue`.  ``step()``
(the service thread, only thread that touches the driver) drains the
queue at the cycle boundary, bulk-creates the batch through
``Driver.ingest_workloads`` — one queue-manager lock acquisition, the
PackJournal dirt marked per workload exactly as the batch path does —
marks the journal applied, and runs ``schedule_once`` K times.

Backpressure
------------

Past the ``high_water`` ingest depth the service rejects with a
retry-after estimate derived from the arrival-rate EWMA; a submission
that outranks the lowest-priority pending entry shed-replaces it
instead (shed is journaled and reported to the victim's token — a
recorded outcome, never a silent drop).

Adaptive burst window
---------------------

K is chosen online per step: the expected work for the step (pending
backlog + EWMA arrivals over ``dt``) divided by the admitted-per-cycle
capacity estimate, snapped up a power-of-two ladder.  Clearing each
step's expected arrivals within the step bounds queueing delay to
~``dt`` ≪ the p99 SLO across diurnal/MMPP swings; the SLO block of the
SERVE artifact (scripts/serve_soak.py) is the evidence.

Crash-restart continuity
------------------------

Three chaos sites (``svc.ingest`` / ``svc.cycle`` / ``svc.shutdown``)
let the soak SIGKILL the service at the nastiest boundaries.
:func:`recover_service` replays the CycleWAL tail over the surviving
store (``Driver.recover_from``), then replays the ingest journal:
accepted-but-unapplied submissions re-enter the queue in acceptance
order, skipping keys already present in the recovered store (the crash
may have landed between the store apply and the apply marker) — zero
accepted submissions lost, zero admissions duplicated, enforced
decision-bit-identically against an unkilled control.  Submission
tokens are idempotent: resubmitting an accepted token returns its
prior outcome without re-journaling or re-enqueueing.

Cycle accounting assumes crashes land at the ``svc.*`` boundaries (step
start, submit path, drain epilogue); mid-cycle WAL crash sites keep
their existing recovery semantics through ``Driver.recover_from`` but
are exercised by the chaos soak, not this service's kill arms.

SIGTERM (``install_signal_handlers``) triggers graceful drain: stop
accepting, finish in-flight cycles until the ingest queue is empty,
flush the WAL and close the ingest journal, exit clean.
"""

from __future__ import annotations

import math
import signal
import threading
import time
from dataclasses import dataclass, replace
from typing import Optional

from ..api.types import WL_QUOTA_RESERVED, PodSet, Workload
from ..chaos import injector as _chaos
from ..features import env_int, env_value
from ..obs.trace import span as _span
from ..traffic.runner import RateEWMA
from ..utils.journal import IngestJournal
from .ingest import IngestQueue, Submission


@dataclass
class ServiceConfig:
    """Knobs for one AdmissionService.  ``None`` fields fall back to
    the registered ``KUEUE_TPU_SVC_*`` env flags at construction."""

    dt_s: float = 0.05              # seconds per service step
    high_water: Optional[int] = None        # ingest backpressure depth
    slo_p99_s: Optional[float] = None       # p99 admission-latency SLO
    drain_timeout_s: Optional[float] = None  # graceful-drain deadline
    journal_path: Optional[str] = None      # ingest journal ("" = memory)
    k_ladder: tuple = (1, 2, 4, 8, 16, 32)  # burst-window rungs
    k_max: int = 32                 # cap (1 pins the deterministic arms)
    ewma_halflife_s: float = 5.0    # arrival-rate tracking speed
    epoch_t: Optional[float] = None  # virtual epoch (recovery continuity)

    def resolved(self) -> "ServiceConfig":
        return replace(
            self,
            high_water=(self.high_water if self.high_water is not None
                        else env_int("KUEUE_TPU_SVC_HIGH_WATER")),
            slo_p99_s=(self.slo_p99_s if self.slo_p99_s is not None
                       else float(env_value("KUEUE_TPU_SVC_SLO_P99_S"))),
            drain_timeout_s=(
                self.drain_timeout_s if self.drain_timeout_s is not None
                else float(env_int("KUEUE_TPU_SVC_DRAIN_TIMEOUT_S"))),
            journal_path=(
                self.journal_path if self.journal_path is not None
                else env_value("KUEUE_TPU_SVC_INGEST_JOURNAL")))


@dataclass
class SubmitResult:
    """What a submitter gets back, every outcome explicit."""

    status: str              # accepted | rejected | shed | draining
    token: str = ""
    seq: int = 0
    reason: str = ""
    retry_after_s: float = 0.0
    queue_depth: int = 0
    duplicate: bool = False  # a repeat of an already-settled token


class AdmissionService:
    """The long-lived service loop around one ``Driver``.

    Thread contract: ``submit`` / ``queue_position`` / ``pending`` are
    safe from any thread; ``step`` / ``serve`` / ``drain`` run on the
    single service thread, which is the only thread that touches the
    driver (scheduler, cache, queues, WAL, spans)."""

    def __init__(self, driver, config: Optional[ServiceConfig] = None,
                 wal=None, journal: Optional[IngestJournal] = None):
        self.driver = driver
        self.clock = driver.clock
        self.metrics = driver.metrics
        self.cfg = (config or ServiceConfig()).resolved()
        self.wal = wal if wal is not None else driver._wal
        if journal is not None:
            self.journal = journal
        else:
            self.journal = IngestJournal(self.cfg.journal_path or None)
        self.ingest = IngestQueue()
        self.ewma = RateEWMA(halflife_s=self.cfg.ewma_halflife_s)
        self._lock = threading.RLock()
        self._tokens: dict[str, SubmitResult] = {}
        self._virtual = hasattr(self.clock, "t")
        self.epoch = (self.cfg.epoch_t if self.cfg.epoch_t is not None
                      else float(self.clock()))
        self.cycle_index = int(round(
            (float(self.clock()) - self.epoch) / self.cfg.dt_s))
        self._finish_at: dict[int, list[str]] = {}
        self._runtime_of: dict[str, float] = {}
        self._service_keys: set[str] = set()   # applied, not yet admitted
        self._accept_wall: dict[str, float] = {}
        self._arrivals_since_step = 0
        self._admit_cap = 1.0          # admitted-per-cycle estimate
        self._retry_after = self.cfg.dt_s
        self.k_last = 1
        self._draining = False
        self._drain_requested = False
        self.drained_clean = False
        self.stopped = False
        self.accepted_total = 0
        self.rejected_total = 0
        self.duplicate_total = 0
        self.shed_total = 0
        self.admitted_total = 0
        self._wall0 = time.perf_counter()
        self.telemetry: list[dict] = []      # per-step soak samples
        self.latency_log: list[tuple] = []   # (t_wall_rel, latency_s)

    # -- submit path (any thread) --------------------------------------

    def submit(self, name: str, queue_name: str, requests: dict,
               priority: int = 0, namespace: str = "default",
               creation_time: Optional[float] = None,
               runtime_s: float = 0.0, count: int = 1,
               token: Optional[str] = None) -> SubmitResult:
        """Accept (journal + enqueue), reject with retry-after, or
        shed-replace — one outcome per call, idempotent per token."""
        with self._lock:
            if self._draining:
                self.metrics.svc_submission("draining")
                self.rejected_total += 1
                return SubmitResult(status="draining", reason="draining",
                                    retry_after_s=self._retry_after)
            tok = token if token is not None else f"{namespace}/{name}"
            prior = self._tokens.get(tok)
            if prior is not None:
                self.metrics.svc_submission("duplicate")
                self.duplicate_total += 1
                return replace(prior, duplicate=True)
            depth = self.ingest.depth()
            victim: Optional[Submission] = None
            if depth >= self.cfg.high_water:
                victim = self.ingest.lowest_priority()
                if victim is None or victim.priority >= priority:
                    self.metrics.svc_submission("rejected")
                    self.rejected_total += 1
                    return SubmitResult(
                        status="rejected", token=tok,
                        reason="backpressure", queue_depth=depth,
                        retry_after_s=self._retry_after)
            ct = (creation_time if creation_time is not None
                  else float(self.clock()))
            sub = Submission(token=tok, seq=0, name=name,
                             namespace=namespace, queue_name=queue_name,
                             priority=priority, creation_time=ct,
                             requests=dict(requests), count=count,
                             runtime_s=runtime_s)
            sub.seq = self.journal.accept(tok, sub.payload())
            if victim is not None:
                self.ingest.remove(victim)
                self.journal.shed(victim.seq, victim.token)
                self._tokens[victim.token] = SubmitResult(
                    status="shed", token=victim.token, seq=victim.seq,
                    reason="displaced by higher priority")
                self.shed_total += 1
                self.metrics.svc_submission("shed")
            if _chaos.ACTIVE is not None:
                _chaos.ACTIVE.crashpoint("svc.ingest")
            self.ingest.append(sub)
            self._accept_wall[sub.key] = time.perf_counter()
            self._arrivals_since_step += 1
            self.accepted_total += 1
            self.metrics.svc_submission("accepted")
            res = SubmitResult(status="accepted", token=tok, seq=sub.seq,
                               queue_depth=self.ingest.depth())
            self._tokens[tok] = res
            return res

    # -- visibility (any thread) ---------------------------------------

    def queue_position(self, token: str) -> dict:
        """Live status of one token: settled outcome, pending position
        in the ingest queue, or admitted/finished from the store."""
        with self._lock:
            res = self._tokens.get(token)
            if res is None:
                return {"token": token, "status": "unknown"}
            pos = self.ingest.position(token)
            if pos is not None:
                return {"token": token, "status": "pending",
                        "position": pos, "depth": self.ingest.depth()}
            out = {"token": token, "status": res.status, "seq": res.seq}
            if res.status == "accepted":
                wl = self.driver.workloads.get(
                    self._key_of_token(token, res))
                if wl is not None:
                    if wl.is_finished:
                        out["status"] = "finished"
                    elif wl.has_quota_reservation:
                        out["status"] = "admitted"
                        out["cluster_queue"] = wl.admission.cluster_queue
                    else:
                        out["status"] = "queued"
            return out

    def _key_of_token(self, token: str, res: SubmitResult) -> str:
        for rec in self.journal.accepted:
            if rec["seq"] == res.seq:
                p = rec["wl"]
                return f"{p['namespace']}/{p['name']}"
        return token

    def pending(self, limit: int = 100) -> dict:
        """The serving pending-workload listing: ingest entries not yet
        drained plus the per-step counters."""
        subs = self.ingest.snapshot()[:limit]
        return {
            "ingest_depth": self.ingest.depth(),
            "high_water": self.cfg.high_water,
            "draining": self._draining,
            "items": [{"token": s.token, "seq": s.seq, "key": s.key,
                       "queue_name": s.queue_name,
                       "priority": s.priority} for s in subs],
        }

    def stats(self) -> dict:
        return {
            "accepted": self.accepted_total,
            "rejected": self.rejected_total,
            "duplicate": self.duplicate_total,
            "shed": self.shed_total,
            "admitted": self.admitted_total,
            "ingest_depth": self.ingest.depth(),
            "cycle_index": self.cycle_index,
            "k_last": self.k_last,
            "arrival_rate_ewma": self.ewma.rate_per_s,
            "draining": self._draining,
            "drained_clean": self.drained_clean,
            "journal": dict(self.journal.stats),
        }

    # -- the service cycle (service thread only) -----------------------

    def _choose_k(self, backlog: int) -> int:
        """Online burst window: cycles this step needed to clear the
        pending backlog plus the EWMA-expected arrivals, snapped up the
        ladder.  Clearing each step's expected work within the step
        keeps queueing delay near ``dt``, which is what holds the p99
        SLO across the load swing."""
        if self.cfg.k_max <= 1:
            return 1
        need = backlog + self.ewma.rate_per_s * self.cfg.dt_s
        raw = need / max(1.0, self._admit_cap)
        target = max(1, min(self.cfg.k_max, math.ceil(raw)))
        for rung in self.cfg.k_ladder:
            if rung >= target:
                return max(1, min(rung, self.cfg.k_max))
        return max(1, min(self.cfg.k_ladder[-1], self.cfg.k_max))

    def _workload_of(self, sub: Submission) -> Workload:
        return Workload(name=sub.name, namespace=sub.namespace,
                        queue_name=sub.queue_name, priority=sub.priority,
                        creation_time=sub.creation_time,
                        pod_sets=[PodSet(name="main", count=sub.count,
                                         requests=dict(sub.requests))])

    def step(self) -> dict:
        """One service step: drain the ingest queue at the cycle
        boundary, bulk-apply, run K scheduling cycles, settle finishes
        and latency accounting.  Mirrors traffic.runner.run_open_loop's
        per-cycle order exactly (clock, finishes, inject, schedule), so
        service-path decisions are bit-identical to the batch runner on
        identical traffic."""
        if _chaos.ACTIVE is not None:
            _chaos.ACTIVE.crashpoint("svc.cycle")
        decisions: list[list[str]] = []
        with _span("svc.cycle"):
            with self._lock:
                batch = self.ingest.drain()
                self._arrivals_since_step = 0
            self.ewma.update(len(batch), self.cfg.dt_s)
            k = self._choose_k(len(self._service_keys) + len(batch))
            self.k_last = k
            admitted_n = 0
            for i in range(k):
                c = self.cycle_index
                if self._virtual:
                    self.clock.t = self.epoch + (c + 1) * self.cfg.dt_s
                for key in self._finish_at.pop(c, ()):
                    wl = self.driver.workloads.get(key)
                    if wl is not None and wl.has_quota_reservation \
                            and not wl.is_finished:
                        self.driver.finish_workload(key)
                if i == 0 and batch:
                    with _span("svc.ingest"):
                        self.driver.ingest_workloads(
                            [self._workload_of(s) for s in batch])
                        for s in batch:
                            self._runtime_of[s.key] = s.runtime_s
                            self._service_keys.add(s.key)
                        self.journal.mark_applied(batch[-1].seq, c)
                stats = self.driver.schedule_once()
                admitted = sorted(stats.admitted)
                decisions.append(admitted)
                now_w = time.perf_counter()
                for key in admitted:
                    if key not in self._service_keys:
                        continue   # re-admission of an evicted workload
                    self._service_keys.discard(key)
                    self.admitted_total += 1
                    admitted_n += 1
                    t0 = self._accept_wall.pop(key, None)
                    if t0 is not None:
                        lat = now_w - t0
                        self.metrics.svc_admission_latency(lat)
                        self.latency_log.append(
                            (now_w - self._wall0, lat))
                    rt = self._runtime_of.pop(key, 0.0)
                    if rt > 0:
                        fin = c + max(1, int(round(rt / self.cfg.dt_s)))
                        self._finish_at.setdefault(fin, []).append(key)
                self.cycle_index = c + 1
            # capacity estimate feeding the next step's K choice
            if admitted_n > 0:
                self._admit_cap = (0.8 * self._admit_cap
                                   + 0.2 * (admitted_n / k))
            depth = self.ingest.depth()
            self._retry_after = min(
                60.0, max(self.cfg.dt_s,
                          depth / max(self.ewma.rate_per_s,
                                      1.0 / self.cfg.dt_s)))
            self.metrics.svc_sample(
                depth=depth, high_water=self.cfg.high_water, burst_k=k,
                ewma_rate=self.ewma.rate_per_s,
                retry_after_s=self._retry_after)
            sample = {"t_wall": time.perf_counter() - self._wall0,
                      "cycle": self.cycle_index, "k": k,
                      "batch": len(batch), "depth": depth,
                      "ewma_rate": self.ewma.rate_per_s,
                      "admitted": admitted_n, "decisions": decisions}
            self.telemetry.append(sample)
            return sample

    # -- drain / shutdown ----------------------------------------------

    def request_drain(self) -> None:
        """Stop accepting; ``serve``/``drain`` finish the in-flight
        work.  Safe from any thread and from a signal handler."""
        with self._lock:
            self._draining = True
            self._drain_requested = True

    def install_signal_handlers(self) -> None:
        """SIGTERM → graceful drain.  Call from the main thread."""
        signal.signal(signal.SIGTERM, lambda signum, frame:
                      self.request_drain())

    def drain(self) -> bool:
        """Synchronous graceful drain on the service thread: stop
        accepting, step until the ingest queue is empty (every accepted
        submission applied) or the deadline passes, then flush the WAL
        and close the ingest journal.  Returns (and records) whether
        the drain was clean."""
        self.request_drain()
        deadline = time.perf_counter() + self.cfg.drain_timeout_s
        while self.ingest.depth() > 0 \
                and time.perf_counter() < deadline:
            self.step()
        clean = self.ingest.depth() == 0
        if _chaos.ACTIVE is not None:
            _chaos.ACTIVE.crashpoint("svc.shutdown")
        with _span("svc.shutdown"):
            if self.wal is not None:
                self.wal.commit()
            self.journal.close()
        self.drained_clean = clean
        self.stopped = True
        return clean

    def serve(self, stop: Optional[threading.Event] = None) -> dict:
        """Wall-clock loop: one step per ``dt``, until a drain is
        requested (SIGTERM or ``request_drain``) or ``stop`` is set —
        both exits run the graceful drain.  Returns final stats."""
        self._wall0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.step()
            if stop is not None and stop.is_set():
                self.request_drain()
            if self._drain_requested:
                self.drain()
                break
            lag = self.cfg.dt_s - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
        return self.stats()

    # -- recovery ------------------------------------------------------

    def _rebuild_from_journal(self) -> None:
        """Post-crash state rebuild from the resumed ingest journal:
        token outcomes, the un-applied ingest suffix, and the finish
        schedule of admitted-in-flight workloads (admit cycle derived
        from the QuotaReserved transition time against the epoch)."""
        dt = self.cfg.dt_s
        for rec in self.journal.accepted:
            tok, seq = rec["token"], rec["seq"]
            if seq in self.journal.shed_seqs:
                self._tokens[tok] = SubmitResult(status="shed",
                                                 token=tok, seq=seq)
            else:
                self._tokens[tok] = SubmitResult(status="accepted",
                                                 token=tok, seq=seq)
        for rec in self.journal.unapplied():
            sub = Submission.from_payload(rec["wl"], token=rec["token"],
                                          seq=rec["seq"])
            if sub.key in self.driver.workloads:
                continue   # applied pre-crash; only the marker was lost
            self.ingest.append(sub)
        for rec in self.journal.accepted:
            if rec["seq"] in self.journal.shed_seqs:
                continue
            p = rec["wl"]
            key = f"{p['namespace']}/{p['name']}"
            wl = self.driver.workloads.get(key)
            if wl is None or wl.is_finished:
                continue
            rt = p.get("runtime_s", 0.0)
            if wl.has_quota_reservation:
                if rt > 0:
                    cond = wl.conditions.get(WL_QUOTA_RESERVED)
                    c_admit = int(round(
                        (cond.last_transition_time - self.epoch)
                        / dt)) - 1
                    fin = c_admit + max(1, int(round(rt / dt)))
                    self._finish_at.setdefault(
                        max(fin, self.cycle_index), []).append(key)
            else:
                self._runtime_of[key] = rt
                self._service_keys.add(key)


def recover_service(driver, stored, wal, config: Optional[ServiceConfig]
                    = None, journal_path: Optional[str] = None
                    ) -> AdmissionService:
    """Crash recovery: the CycleWAL tail replays over the surviving
    store (``Driver.recover_from``), then the durable ingest journal
    rebuilds the token map, re-enqueues the accepted-but-unapplied
    suffix in acceptance order (skipping keys the recovered store
    already holds — the crash may have landed between the store apply
    and the apply marker), and reconstructs the finish schedule for
    admitted-in-flight workloads.  ``driver`` is a fresh driver with
    cluster state already applied; ``stored`` is the crashed driver's
    durable workload store.  Pass the original service's ``epoch_t`` in
    ``config`` so cycle accounting continues where the crashed process
    stopped."""
    cfg = (config or ServiceConfig()).resolved()
    driver.recover_from(stored, wal)
    path = journal_path if journal_path is not None else cfg.journal_path
    journal = IngestJournal.resume(path) if path else IngestJournal(None)
    svc = AdmissionService(driver, config=cfg, wal=wal, journal=journal)
    svc._rebuild_from_journal()
    return svc
