"""MultiKueue: multi-cluster dispatch (reference
pkg/controller/admissionchecks/multikueue, KEP 693).

Worker clusters are full in-process Drivers (the reference's multikueue
integration tests run multiple envtest apiservers in one process the same
way — SURVEY §4.3).  The dispatch protocol mirrors
multikueue/workload.go:

1. a workload reserves quota on the manager; its CQ carries a MultiKueue
   AdmissionCheck;
2. the controller mirrors the workload to every cluster in the check's
   MultiKueueConfig (nomination);
3. the first worker to reserve quota wins; mirrors elsewhere are deleted;
4. the check flips Ready; the local job stays suspended (managedBy);
5. remote status (admitted / finished) is copied back; a lost worker
   ejects the assignment after ``worker_lost_timeout`` and the check
   returns to Pending for re-dispatch (multikueuecluster.go:255 GC +
   workload.go ejection).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from ..api.types import (
    AdmissionCheckState,
    MultiKueueConfig,
    Workload,
)

MULTIKUEUE_CONTROLLER_NAME = "kueue.x-k8s.io/multikueue"


RETRY_BASE_S = 1.0
RETRY_MAX_S = 60.0


@dataclass
class WorkerCluster:
    """A remote cluster behind a connection that can drop (reference
    multikueuecluster.go remoteClient).

    ``driver`` — an in-process Driver (the multi-envtest pattern) — or
    ``client`` — any transport client (kueue_tpu.remote.HttpWorkerClient
    for a real process/socket boundary).  Reconnection follows the
    reference's exponential retry (multikueuecluster.go:67 retryAfter,
    :134-226 watch re-establishment) with a half-open circuit: a failed
    operation marks the cluster lost; health probes retry with doubling
    backoff; a *passing* probe only opens a half-open trial window —
    the controller must complete the rejoin reconciliation over the
    real API before ``reconnect()`` closes the circuit, and a failure
    during the trial re-opens it with the backoff escalated (a flapping
    worker never gets a fresh budget per flap).  ``reconnect_budget``
    > 0 caps total probes before the cluster is declared permanently
    failed."""
    name: str
    driver: object = None             # in-process Driver (optional)
    client: object = None             # transport client
    active: bool = True
    lost_since: Optional[float] = None
    next_retry: float = 0.0
    retry_backoff: float = RETRY_BASE_S
    watch: object = None              # remote.WatchLoop when streaming
    half_open: bool = False           # probe passed, rejoin unproven
    reconnect_attempts: int = 0       # probes since the cluster went lost
    reconnect_budget: int = 0         # 0 = unlimited probes
    failed_permanently: bool = False

    def __post_init__(self):
        if self.client is None and self.driver is not None:
            from ..remote import LocalWorkerClient
            self.client = LocalWorkerClient(self.driver)

    def mark_lost(self, now: float) -> None:
        if self.half_open:
            # a half-open trial failed: keep escalating the backoff
            # instead of resetting it
            self.half_open = False
            self.active = False
            if self.lost_since is None:
                self.lost_since = now
            self.retry_backoff = min(self.retry_backoff * 2.0, RETRY_MAX_S)
            self.next_retry = now + self.retry_backoff
            return
        if self.active:
            self.active = False
            self.lost_since = now
            self.retry_backoff = RETRY_BASE_S
            self.next_retry = now + self.retry_backoff

    def try_reconnect(self, now: float) -> bool:
        """Half-open health probe with exponential backoff and a probe
        budget.  True means the probe passed and the trial window is
        open — NOT that the cluster is active again; the caller runs
        the rejoin reconciliation and calls ``reconnect()`` (or
        ``mark_lost()`` on failure) to settle the circuit."""
        if self.active or self.failed_permanently or now < self.next_retry:
            return False
        self.reconnect_attempts += 1
        if self.client.healthy():
            self.half_open = True
            return True
        if (self.reconnect_budget
                and self.reconnect_attempts >= self.reconnect_budget):
            self.failed_permanently = True
            return False
        self.retry_backoff = min(self.retry_backoff * 2.0, RETRY_MAX_S)
        self.next_retry = now + self.retry_backoff
        return False

    def reconnect(self) -> None:
        self.active = True
        self.half_open = False
        self.lost_since = None
        self.retry_backoff = RETRY_BASE_S
        self.reconnect_attempts = 0


@dataclass
class _Assignment:
    cluster: str
    nominated: list[str] = field(default_factory=list)


class MultiKueueController:
    """reference multikueue/workload.go wlReconciler."""

    def __init__(self, manager_driver, check_name: str,
                 config: MultiKueueConfig,
                 clusters: dict[str, WorkerCluster],
                 origin: str = "multikueue",
                 worker_lost_timeout: float = 300.0,
                 manager_jobs=None,
                 worker_jobs: dict[str, object] | None = None):
        self.manager = manager_driver
        # back-reference for the debugger's federation-circuit section
        # (debugger.dump_state reads driver.multikueue.clusters)
        manager_driver.multikueue = self
        self.check_name = check_name
        self.config = config
        self.clusters = clusters
        self.origin = origin
        self.worker_lost_timeout = worker_lost_timeout
        self.assignments: dict[str, _Assignment] = {}
        # mirrors that must be deleted on a currently-unreachable worker:
        # flushed when it reconnects (a lost delete would otherwise
        # orphan worker quota forever)
        self.pending_deletes: dict[str, set[str]] = {}
        # optional job-level dispatch (reference MultiKueueAdapter.SyncJob,
        # jobframework/interface.go:227): the manager's JobManager plus one
        # per worker cluster; jobs are mirrored instead of bare workloads
        self.manager_jobs = manager_jobs
        self.worker_jobs = worker_jobs or {}

    # ------------------------------------------------------------------

    def _relevant(self, wl: Workload) -> bool:
        return (self.check_name in wl.admission_check_states
                and wl.has_quota_reservation and not wl.is_finished)

    def _mirror(self, wl: Workload) -> Workload:
        remote = Workload(
            name=wl.name, namespace=wl.namespace, queue_name=wl.queue_name,
            pod_sets=[copy.deepcopy(ps) for ps in wl.pod_sets],
            priority=wl.priority, creation_time=wl.creation_time)
        return remote

    def _worker_op(self, cluster: WorkerCluster, fn, *args, default=None):
        """Run one transport operation; a connection failure marks the
        cluster lost (multikueuecluster.go:134 watch loss)."""
        from ..remote import ConnectionLost
        try:
            return fn(*args)
        except ConnectionLost:
            cluster.mark_lost(self.manager.clock())
            return default

    def start_watches(self, poll_timeout: float = 10.0) -> None:
        """Per-cluster watch streams (reference multikueuecluster.go:187
        watch channels): worker events are pushed to the controller
        instead of polled one GET per assigned workload per reconcile.
        Re-establishment + event replay are handled by the WatchLoop."""
        from ..remote import WatchLoop
        for cluster in self.clusters.values():
            if cluster.watch is None and cluster.client is not None:
                cluster.watch = WatchLoop(cluster.client,
                                          poll_timeout=poll_timeout)
                cluster.watch.start()

    def stop_watches(self) -> None:
        for cluster in self.clusters.values():
            if cluster.watch is not None:
                cluster.watch.stop()
                cluster.watch = None

    def _drain_watches(self, now: float) -> list[tuple[str, str]]:
        """Pull pending events from every watch queue.  Connection
        markers drive the cluster's lost/reconnected state; workload
        events return as (cluster, key) for targeted syncs."""
        import queue as _queue
        touched: list[tuple[str, str]] = []
        for cname, cluster in self.clusters.items():
            w = cluster.watch
            if w is None:
                continue
            while True:
                try:
                    kind, key, _note = w.events.get_nowait()
                except _queue.Empty:
                    break
                if kind == "__lost__":
                    cluster.mark_lost(now)
                elif kind == "__reconnected__":
                    if cluster.active:
                        cluster.reconnect()   # refresh backoff state
                    else:
                        # the stream is back: treat it as a passing
                        # half-open probe — the rejoin reconciliation
                        # must prove the worker over the real API
                        # before the cluster reactivates
                        cluster.half_open = True
                        self.reconcile_rejoined(cname)
                elif kind == "__resync__":
                    # fresh worker epoch: the remote may have lost every
                    # mirror — resync everything tied to this cluster
                    for akey, asg in self.assignments.items():
                        if asg.cluster == cname or cname in asg.nominated:
                            touched.append((cname, akey))
                elif kind in ("QuotaReserved", "Finished", "Deleted",
                              "Preempted"):
                    touched.append((cname, key))
        return touched

    def reconcile(self) -> None:
        now = self.manager.clock()
        touched = self._drain_watches(now)
        # connection health: the watch loop is authoritative when
        # streaming; otherwise retry lost workers with exponential
        # backoff.  Either way, eject assignments once a worker stays
        # lost past the timeout.
        for name, cluster in self.clusters.items():
            # health probes run even with a watch attached: a transient
            # _worker_op failure can mark the cluster lost while the
            # watch stream (a separate connection) stays healthy and so
            # never emits a __reconnected__ marker
            if not cluster.active and cluster.try_reconnect(now):
                self.reconcile_rejoined(name)
            if (not cluster.active and cluster.lost_since is not None
                    and now - cluster.lost_since > self.worker_lost_timeout):
                self._eject_cluster(name)

        # with watches, remote state arrives as events: the per-workload
        # GET polling loop runs only for watchless transports (and for
        # job-level dispatch, whose execution-status copy-back has no
        # event source)
        watching = all(c.watch is not None
                       for c in self.clusters.values()) and self.clusters
        for key, wl in list(self.manager.workloads.items()):
            if not self._relevant(wl):
                if key in self.assignments:
                    self._cleanup(key)
                continue
            state = wl.admission_check_states[self.check_name]
            asg = self.assignments.get(key)
            if asg is None:
                self._nominate(key, wl)
            elif not watching or self.manager_jobs is not None:
                self._sync(key, wl, state.state, asg)

        if watching and self.manager_jobs is None:
            # targeted event-driven syncs (deduped; when the polling
            # loop ran above it already covered every assignment)
            for key in dict.fromkeys(k for _c, k in touched):
                asg = self.assignments.get(key)
                wl = self.manager.workloads.get(key)
                if asg is None or wl is None or not self._relevant(wl):
                    continue
                state = wl.admission_check_states[self.check_name]
                self._sync(key, wl, state.state, asg)

    # ------------------------------------------------------------------

    def _owner_job(self, wl: Workload):
        """The manager-side job owning this workload, if job-level
        dispatch is attached."""
        if self.manager_jobs is None:
            return None
        for job in self.manager_jobs.jobs.values():
            wl_key = self.manager_jobs.reconciler.workload_key_for(job)
            if wl_key == wl.key:
                return job
        return None

    def _sync_job(self, cname: str, job) -> None:
        """Mirror the job object to a worker cluster (adapter SyncJob):
        the worker's own jobframework creates and manages the workload."""
        import copy
        worker_jm = self.worker_jobs.get(cname)
        if worker_jm is None:
            return
        if job.key in worker_jm.jobs:
            return
        clone = copy.deepcopy(job)
        if hasattr(clone, "set_managed_by"):
            clone.set_managed_by(None)   # the worker runs it for real
        worker_jm.upsert(clone)

    def _nominate(self, key: str, wl: Workload) -> None:
        """Create mirrors on every configured active cluster
        (workload.go nominateAndSynchronizeWorkers)."""
        job = self._owner_job(wl)
        nominated = []
        for cname in self.config.clusters:
            cluster = self.clusters.get(cname)
            if cluster is None or not cluster.active:
                continue
            if job is not None and cname in self.worker_jobs:
                self._sync_job(cname, job)
            else:
                self._worker_op(cluster, cluster.client.create_workload,
                                self._mirror(wl))
                if not cluster.active:
                    # the create may have landed before the connection
                    # dropped: clean it up when the worker comes back
                    self.pending_deletes.setdefault(cname, set()).add(
                        wl.key)
                    continue
            nominated.append(cname)
        if not nominated:
            return
        self.assignments[key] = _Assignment(cluster="", nominated=nominated)

    def _sync(self, key: str, wl: Workload, state: AdmissionCheckState,
              asg: _Assignment) -> None:
        # give each nominated worker a scheduling chance, then pick the
        # first with quota reserved (workload.go: first to reserve wins)
        if not asg.cluster:
            for cname in asg.nominated:
                cluster = self.clusters.get(cname)
                if cluster is None or not cluster.active:
                    continue
                remote = self._worker_op(cluster,
                                         cluster.client.get_workload, key)
                if remote is not None and remote.has_quota_reservation:
                    asg.cluster = cname
                    break
            if asg.cluster:
                # delete the losing mirrors
                for cname in asg.nominated:
                    if cname != asg.cluster:
                        self._delete_remote(cname, key)
                asg.nominated = [asg.cluster]
                self.manager.set_admission_check_state(
                    key, self.check_name, AdmissionCheckState.READY,
                    f'The workload got reservation on "{asg.cluster}"')
            return

        cluster = self.clusters.get(asg.cluster)
        if cluster is None or not cluster.active:
            return  # lost; ejection handled by the timeout scan
        remote = self._worker_op(cluster, cluster.client.get_workload, key)
        if not cluster.active:
            return  # connection dropped mid-sync
        if remote is None:
            # remote deleted under us → re-dispatch
            self._reset(key)
            return
        # job-level dispatch: copy the remote job's execution status back
        # to the (suspended) manager job (reference workload.go copy-back)
        job = self._owner_job(wl)
        if job is not None:
            worker_jm = self.worker_jobs.get(asg.cluster)
            if worker_jm is not None:
                worker_job = worker_jm.jobs.get(job.key)
                if worker_job is not None:
                    job.sync_status_from(worker_job)
        if remote.is_finished:
            msg = remote.conditions.get("Finished")
            self.manager.finish_workload(
                key, msg.message if msg else "Finished on worker")
            self._cleanup(key)

    # ------------------------------------------------------------------

    def _delete_remote(self, cname: str, key: str) -> None:
        cluster = self.clusters.get(cname)
        if cluster is None:
            return
        if not cluster.active:
            # unreachable: remember the delete for the reconnect flush
            self.pending_deletes.setdefault(cname, set()).add(key)
            return
        worker_jm = self.worker_jobs.get(cname)
        if worker_jm is not None:
            # job-level mirrors: delete the worker job (cascades to its
            # workload via the worker JobManager)
            for jkey, job in list(worker_jm.jobs.items()):
                if worker_jm.reconciler.workload_key_for(job) == key:
                    worker_jm.delete(jkey)
        self._worker_op(cluster, cluster.client.delete_workload, key)
        if not cluster.active:
            self.pending_deletes.setdefault(cname, set()).add(key)

    def reconcile_rejoined(self, cname: str) -> bool:
        """WAL-consistent rejoin reconciliation — the half-open trial.

        The manager's journal-recovered store plus the assignment map
        rebuilt from it are its durable intent; a rejoining worker's
        listing is the actual state.  Replaying one against the other
        resolves every nominate/admit race a partition can leave:

        - mirrors whose deletes were lost while the worker was
          unreachable (its daemon may even have admitted them) die
          before anything else dispatches — the no-double-admission
          guarantee on rejoin;
        - mirrors still in a live nomination or assignment are kept
          (the normal sync resumes them), as are finished-winner
          records whose manager workload also finished;
        - assignments pointing at this worker whose mirror vanished
          (the worker restarted empty) reset for re-dispatch.

        Runs while the cluster is half-open: any transport failure
        aborts back to lost with the backoff escalated (the circuit
        re-opens); only a clean pass closes it via ``reconnect()``.
        Returns True when the cluster is active again."""
        cluster = self.clusters.get(cname)
        if cluster is None or cluster.active:
            return cluster is not None and cluster.active
        from ..remote import ConnectionLost
        pending = self.pending_deletes.get(cname, set())
        try:
            listing = cluster.client.list_workloads()
            for key in sorted(listing):
                finished = listing[key]
                asg = self.assignments.get(key)
                wl = self.manager.workloads.get(key)
                keep_assigned = (
                    asg is not None and wl is not None
                    and self._relevant(wl)
                    and (asg.cluster == cname
                         or (not asg.cluster and cname in asg.nominated)))
                keep_record = (finished and wl is not None
                               and wl.is_finished and key not in pending)
                if keep_assigned or keep_record:
                    pending.discard(key)
                    continue
                worker_jm = self.worker_jobs.get(cname)
                if worker_jm is not None:
                    for jkey, job in list(worker_jm.jobs.items()):
                        if worker_jm.reconciler.workload_key_for(job) == key:
                            worker_jm.delete(jkey)
                cluster.client.delete_workload(key)
                pending.discard(key)
            # deletes queued for mirrors the worker no longer holds are moot
            for key in list(pending):
                if key not in listing:
                    pending.discard(key)
            # the partition may have eaten this worker's mirrors: anything
            # assigned here but gone must re-dispatch
            for key, asg in list(self.assignments.items()):
                if asg.cluster == cname and key not in listing:
                    self._reset(key)
        except ConnectionLost:
            cluster.mark_lost(self.manager.clock())
            return False
        self.pending_deletes.pop(cname, None)
        cluster.reconnect()
        return True

    def _cleanup(self, key: str) -> None:
        asg = self.assignments.pop(key, None)
        if asg is None:
            return
        for cname in asg.nominated:
            wl = self.manager.workloads.get(key)
            if wl is None or not wl.is_finished:
                self._delete_remote(cname, key)

    def _reset(self, key: str) -> None:
        self.assignments.pop(key, None)
        self.manager.set_admission_check_state(
            key, self.check_name, AdmissionCheckState.RETRY,
            "Lost the remote reservation; will re-dispatch")

    def _eject_cluster(self, cname: str) -> None:
        """Worker lost beyond timeout: requeue everything assigned to it
        (workload.go workerLostTimeout ejection) and queue deletes for
        every mirror it may still hold — if the worker ever rejoins,
        its stale mirrors must die before they can double-admit against
        the re-dispatched assignment."""
        for key, asg in list(self.assignments.items()):
            if asg.cluster == cname or cname in asg.nominated:
                self.pending_deletes.setdefault(cname, set()).add(key)
                self._reset(key)
                self.manager.obs.emit("eject", key, reason="WorkerLost",
                                      note=cname)

    def recover_assignments(self) -> int:
        """Rebuild the assignment map after a manager restart
        (Driver.recover_from): the map itself is in-memory, but every
        fact it encodes is recoverable — the journal-recovered store
        says which workloads carry this check, and the workers' actual
        listings say who holds the mirror.  A READY check with multiple
        holders keeps the first in config order and deletes the rest
        (the same winner the original selection would have picked).
        Returns the number of assignments restored."""
        restored = 0
        listings: dict[str, dict[str, bool]] = {}
        for cname, cluster in self.clusters.items():
            if not cluster.active:
                continue
            out = self._worker_op(cluster, cluster.client.list_workloads,
                                  default=None)
            if out is not None:
                listings[cname] = out
        for key, wl in list(self.manager.workloads.items()):
            if key in self.assignments or not self._relevant(wl):
                continue
            holders = [c for c in self.config.clusters
                       if key in listings.get(c, {})]
            if not holders:
                continue
            state = wl.admission_check_states[self.check_name].state
            if state == AdmissionCheckState.READY:
                winner = holders[0]
                self.assignments[key] = _Assignment(cluster=winner,
                                                    nominated=[winner])
                for cname in holders[1:]:
                    self._delete_remote(cname, key)
            else:
                self.assignments[key] = _Assignment(cluster="",
                                                    nominated=holders)
            restored += 1
        return restored

    # ------------------------------------------------------------------

    def run_gc(self) -> None:
        """Remote GC (multikueuecluster.go:255 runGC): delete worker
        mirrors whose manager workload is gone.  One list round trip per
        cluster ({key: finished}); stops on connection loss."""
        managed = set(self.manager.workloads)
        for cluster in self.clusters.values():
            if not cluster.active:
                continue
            listing = self._worker_op(cluster,
                                      cluster.client.list_workloads,
                                      default={})
            for key, finished in listing.items():
                if not cluster.active:
                    break   # lost mid-GC: stop issuing doomed requests
                if key not in managed and not finished:
                    self._worker_op(cluster,
                                    cluster.client.delete_workload, key)
