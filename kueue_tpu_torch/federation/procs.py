"""Federation over real sockets: manager in-process, workers as
``WorkerServer`` child processes.

:class:`ProcFederation` runs the exact :class:`~.sim.FederationSim`
step choreography — ingest, manager cycle, nomination reconcile,
worker cycles, worker finishes, watch pump, winner reconcile, local
finishes, invariants — but every worker interaction crosses a real
TCP socket through ``remote.HttpWorkerClient``.  The
r15 machinery this finally exercises honestly: the reconnect circuit
sees actual connection refusals while a worker is down, retry and
deadline budgets burn against real transport faults (optionally
through a ``dist.proxy.SocketFaultProxy``), and a
SIGKILLed worker's restart presents a fresh watch epoch whose
``__resync__`` replays the event log from zero over the wire.

Determinism contract: all virtual clocks advance only at lockstep
barriers — the harness POSTs ``/admin/clock`` to every worker right
after advancing its own clock, so condition timestamps land
bit-identical to a :class:`FederationSim` control fed the same
traffic.  Parity is judged by ``state_digest`` on both managers and
on every worker (the control's drivers locally, the processes over
``GET /admin/digest``).
"""

from __future__ import annotations

from typing import Optional

from ..api.types import (
    AdmissionCheck,
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    MultiKueueConfig,
    PodSet,
    PreemptionPolicy,
    QueueingStrategy,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
    Workload,
)
from ..admissionchecks.multikueue import MultiKueueController, WorkerCluster
from ..controller.driver import Driver
from ..remote import ConnectionLost, HttpWorkerClient, WatchLoop
from .sim import VirtualClock


def manager_topology(n_cqs: int, remote_cqs: int, quota_m: int = 8000):
    """The FederationSim manager shape: cohorts of 4, the first
    ``remote_cqs`` ClusterQueues carrying the ``mk`` MultiKueue check."""
    def fn(d):
        d.apply_resource_flavor(ResourceFlavor(name="default"))
        d.apply_admission_check(AdmissionCheck(
            name="mk", controller_name="kueue.x-k8s.io/multikueue"))
        with d.bulk_apply():
            for q in range(n_cqs):
                checks = ("mk",) if q < remote_cqs else ()
                d.apply_cluster_queue(ClusterQueue(
                    name=f"cq-{q}", cohort=f"co-{q // 4}",
                    queueing_strategy=QueueingStrategy.BEST_EFFORT_FIFO,
                    preemption=PreemptionPolicy(),
                    admission_checks=list(checks),
                    resource_groups=[ResourceGroup(
                        covered_resources=["cpu"],
                        flavors=[FlavorQuotas(name="default", resources={
                            "cpu": ResourceQuota(nominal=quota_m)})])]))
                d.apply_local_queue(LocalQueue(
                    name=f"lq-{q}", cluster_queue=f"cq-{q}"))
    return fn


def fed_traffic(steps: int, per_step: int, n_cqs: int,
                runtime_s: int = 2, start_step: int = 1) -> dict[int, list]:
    """Deterministic federation traffic: the same
    ``(key, lq, cpu_m, prio, runtime_s)`` tuples for the process run
    and its in-process control.  Queues round-robin over all manager
    LocalQueues, so the schedule covers both the MultiKueue range and
    the locally-admitted remainder."""
    by_step: dict[int, list] = {}
    idx = 0
    for s in range(start_step, start_step + steps):
        lane = []
        for _ in range(per_step):
            lane.append((f"default/fw-{idx}", f"lq-{idx % n_cqs}",
                         1000, 0, runtime_s))
            idx += 1
        by_step[s] = lane
    return by_step


class ProcFederation:
    """The manager side of a multi-process federation (see module doc).

    ``worker_urls`` maps worker name → base URL — normally the child
    process's bound port, optionally a :class:`SocketFaultProxy` in
    front of it.  The caller owns the worker processes (spawning,
    killing, recovering them); this harness only talks to their
    sockets and keeps its bookkeeping identical to FederationSim's."""

    def __init__(self, worker_urls: dict[str, str], n_cqs: int = 6,
                 remote_cqs: int = 4, manager_quota_m: int = 8000,
                 worker_quota_m: int = 4000, runtime_steps: int = 2,
                 worker_lost_timeout: float = 3.0,
                 reconnect_budget: int = 0,
                 client_timeout: float = 5.0,
                 client_retries: Optional[int] = None,
                 client_deadline_s: Optional[float] = None,
                 device: str = "cuda"):
        self.clock = VirtualClock()
        self.step_no = 0
        self.n_cqs = n_cqs
        self.remote_cqs = remote_cqs
        self.runtime_steps = runtime_steps
        self.worker_names = list(worker_urls)
        self.manager = Driver(clock=self.clock, device=device)
        manager_topology(n_cqs, remote_cqs, manager_quota_m)(self.manager)
        self.worker_quota_m = worker_quota_m

        self.clients: dict[str, HttpWorkerClient] = {}
        self.clusters: dict[str, WorkerCluster] = {}
        for name, url in worker_urls.items():
            client = HttpWorkerClient(
                url, timeout=client_timeout, retries=client_retries,
                backoff_base=0.02, backoff_max=0.2,
                deadline_s=client_deadline_s)
            self.clients[name] = client
            cluster = WorkerCluster(name=name, client=client,
                                    reconnect_budget=reconnect_budget)
            # pumped at the barrier, never a thread
            cluster.watch = WatchLoop(client, poll_timeout=0.0)
            self.clusters[name] = cluster
        self.config = MultiKueueConfig(name="fed",
                                       clusters=list(worker_urls))
        self.ctl = MultiKueueController(
            self.manager, check_name="mk", config=self.config,
            clusters=self.clusters, origin="fed",
            worker_lost_timeout=worker_lost_timeout)

        self._traffic: dict[int, list] = {}
        self._runtime: dict[str, int] = {}
        self._w_admit_step: dict[str, dict[str, int]] = {
            n: {} for n in self.worker_names}
        self._m_admit_step: dict[str, int] = {}
        self._finished_on: dict[str, set] = {}
        self.ingested = 0
        self.violations: list[dict] = []
        self.counters = {"worker_unreachable": 0, "status_skips": 0}

    # -- traffic -------------------------------------------------------

    def load_traffic(self, by_step: dict[int, list]) -> None:
        self._traffic = dict(by_step)

    def _ingest(self):
        for key, lq, cpu_m, prio, runtime_s in self._traffic.pop(
                self.step_no, []):
            ns, _, name = key.partition("/")
            self.manager.create_workload(Workload(
                name=name, namespace=ns, queue_name=lq, priority=prio,
                creation_time=self.clock(),
                pod_sets=[PodSet(name="main", count=1,
                                 requests={"cpu": cpu_m})]))
            self._runtime[key] = max(1, int(runtime_s))
            self.ingested += 1

    # -- the socket-crossing choreography ------------------------------

    def _push_clock(self):
        """Pin every reachable worker's virtual clock to the manager's
        — first thing after the barrier advance, so every condition a
        worker stamps this step carries the manager's timestamp."""
        for name, client in self.clients.items():
            try:
                client.set_clock(self.clock.t)
            except ConnectionLost:
                self.counters["worker_unreachable"] += 1

    def _step_workers(self):
        for name, client in self.clients.items():
            try:
                client.admin_step()
            except ConnectionLost:
                self.counters["worker_unreachable"] += 1

    def _worker_status(self, name: str) -> Optional[dict]:
        try:
            return self.clients[name].admin_status()
        except ConnectionLost:
            self.counters["status_skips"] += 1
            return None

    def _drive_worker_finishes(self):
        """FederationSim._drive_worker_finishes over the wire: observe
        reservation status via ``/admin/status``, finish the winner's
        job through the public finish endpoint once its modeled
        runtime elapsed."""
        for name in self.worker_names:
            status = self._worker_status(name)
            if status is None:
                continue   # unreachable == dead this step
            seen = self._w_admit_step[name]
            for key, (has_qr, finished) in status.items():
                if has_qr and not finished and key not in seen:
                    seen[key] = self.step_no
            for key in list(seen):
                st = status.get(key)
                if st is None or not st[0]:
                    if st is None or not st[1]:
                        seen.pop(key, None)
                    continue
                if st[1]:
                    continue
                asg = self.ctl.assignments.get(key)
                if asg is None or asg.cluster != name:
                    continue   # only the winner's job executes
                rt = self._runtime.get(key, self.runtime_steps)
                if self.step_no - seen[key] >= rt:
                    try:
                        self.clients[name].finish_workload(
                            key, f"Finished on {name}")
                    except ConnectionLost:
                        self.counters["worker_unreachable"] += 1
                        continue
                    self._finished_on.setdefault(key, set()).add(name)

    def _drive_local_finishes(self):
        seen = self._m_admit_step
        for key, wl in self.manager.workloads.items():
            if "mk" in wl.admission_check_states:
                continue   # remote: finishes arrive via copy-back
            if (wl.has_quota_reservation and not wl.is_finished
                    and key not in seen):
                seen[key] = self.step_no
        for key in list(seen):
            wl = self.manager.workloads.get(key)
            if wl is None or not wl.has_quota_reservation:
                if wl is None or not wl.is_finished:
                    seen.pop(key, None)
                continue
            if wl.is_finished:
                continue
            rt = self._runtime.get(key, self.runtime_steps)
            if self.step_no - seen[key] >= rt:
                self.manager.finish_workload(key, "Finished locally")

    def _pump_watches(self):
        for cluster in self.clusters.values():
            cluster.watch.pump()

    def _check_invariants(self):
        """Zero-double-admission, judged from live socket status."""
        statuses = {name: self._worker_status(name)
                    for name in self.worker_names}
        for key, asg in self.ctl.assignments.items():
            if not asg.cluster:
                continue
            holders = []
            for name, status in statuses.items():
                if not self.clusters[name].active or status is None:
                    continue
                st = status.get(key)
                if st is not None and st[0] and not st[1]:
                    holders.append(name)
            if len(holders) > 1:
                self.violations.append({
                    "step": self.step_no, "key": key,
                    "kind": "double_admission", "holders": holders})
        for key, names in self._finished_on.items():
            if len(names) > 1:
                self.violations.append({
                    "step": self.step_no, "key": key,
                    "kind": "double_execution",
                    "holders": sorted(names)})
                self._finished_on[key] = {sorted(names)[0]}

    def step(self) -> None:
        self.step_no += 1
        self.clock.t += 1.0
        self._push_clock()
        self._ingest()
        self.manager.schedule_once()
        self.ctl.reconcile()               # nomination
        self._step_workers()
        self._drive_worker_finishes()
        self._pump_watches()
        self.ctl.reconcile()               # winner selection, copy-back
        self._drive_local_finishes()
        self._check_invariants()

    def settled(self) -> bool:
        if self._traffic:
            return False
        return all(wl.is_finished
                   for wl in self.manager.workloads.values())

    def run(self, steps: int, drain_max: int = 200) -> bool:
        for _ in range(steps):
            self.step()
        drained = 0
        while drained < drain_max and not self.settled():
            self.step()
            drained += 1
        return self.settled()

    # -- parity & observability ----------------------------------------

    def digests(self) -> dict:
        """Manager digest locally, each worker's over the socket."""
        from ..remote import state_digest
        out = {"manager": state_digest(self.manager), "workers": {}}
        for name, client in self.clients.items():
            try:
                out["workers"][name] = client.admin_digest()
            except ConnectionLost:
                out["workers"][name] = None
        return out

    def client_stats(self) -> dict:
        return {name: dict(c.stats) for name, c in self.clients.items()}
