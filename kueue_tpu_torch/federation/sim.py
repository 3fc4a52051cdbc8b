"""Seeded N-worker-cluster MultiKueue federation simulation.

A manager Driver spills admissions across N worker Drivers through the
real MultiKueue protocol — ``MultiKueueController`` nomination, watch
streams with resume tokens, winner selection, copy-back — under a
single shared virtual clock, with every delivery pumped at explicit
points so the whole federation is deterministic: same spec + same seed
+ same chaos arming ⇒ bit-identical global state, which is what the
soak's control-arm parity checks ride on.

Time model: one ``step()`` is one virtual second.  Each step ingests
the traffic due, runs one manager scheduling cycle, one cycle per
worker, pumps every watch, and reconciles the controller twice (before
worker cycles: nomination; after: winner selection + copy-back).
Workload execution is modeled the way the reference runs MultiKueue
jobs: mirrors reserve quota on every nominated worker, but only the
*winner's* job executes (managedBy keeps the rest suspended) — the sim
finishes a mirror ``runtime`` steps after its admission only while the
manager's assignment points at that cluster.

Chaos sites consulted inside ``step()`` (see ``chaos/injector.py``):

- ``fed.partition``   — twice per step (step start, and mid-step
  between the watch pump and the second reconcile, which is how a
  partition lands *between* nomination/admission and winner selection);
  payload ``([cluster, ...], duration_steps)``;
- ``fed.cluster_loss`` — once per step (start); payload ``cluster``:
  the cluster is *destroyed* — severed forever, its scheduler stops,
  and its modeled jobs stop executing (a loss is dead machines, not a
  slow link; the partition action is the slow link);
- ``fed.worker_crash`` — once per step (before worker cycles); payload
  ``cluster``: kills that worker mid-admission (its WAL tail holds the
  journaled-but-unapplied op), rebuilds it from store + journal at the
  same virtual instant, and re-runs the interrupted cycle.

Invariants sampled after every step's final reconcile:

- *no double-admission*: for every key with an established assignment,
  at most one ACTIVE cluster holds a quota reservation;
- *exactly-once execution*: no key ever finishes on two workers.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

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
from ..chaos import injector as _chaos
from ..chaos.injector import ChaosInjector, InjectedCrash
from ..controller.driver import Driver
from ..remote import ChaosWorkerClient, LocalWorkerClient, WatchLoop
from ..utils.journal import CycleWAL


class VirtualClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@dataclass
class FedSpec:
    """Deterministic federation shape (same spec ⇒ same topology)."""
    n_workers: int = 4
    n_cqs: int = 1000          # manager CQs; the first remote_cqs carry "mk"
    remote_cqs: int = 250      # mirrored CQ range on every worker
    manager_quota_m: int = 8000
    worker_quota_m: int = 4000
    runtime_steps: int = 2     # modeled execution time per workload
    worker_lost_timeout: float = 3.0
    reconnect_budget: int = 0  # 0 = unlimited half-open probes
    drift_every: int = 0       # 0 disables capacity drift
    drift_factors: tuple = (0.5, 1.0, 1.5)
    seed: int = 0
    use_device_solver: bool = True
    chaos_transport: bool = False   # wrap clients for remote.* faults
    device: str = "cuda"       # every Driver of the federation runs here


def _drift_pick(seed: int, worker: str, epoch: int,
                factors: tuple) -> float:
    """Seeded, order-free drift choice: a pure function of
    (seed, worker, epoch) so both arms of a parity pair agree."""
    import zlib
    h = zlib.crc32(f"{seed}/{worker}/{epoch}".encode())
    return factors[h % len(factors)]


def schedule_traffic(events, n_cqs: int, remote_cqs: int,
                     start_step: int = 1):
    """Quantize a traffic stream's submit events onto sim steps.

    Remote-marked events route into the manager's MultiKueue CQ range
    ``[0, remote_cqs)``; local events into ``[remote_cqs, n_cqs)``.
    Returns ({step: [(key, lq, cpu_m, priority, runtime_s)]}, n_remote).
    """
    by_step: dict[int, list] = {}
    n_remote = 0
    local_span = max(1, n_cqs - remote_cqs)
    for ev in events:
        if ev.kind != "submit":
            continue
        if ev.remote:
            q = ev.cq % max(1, remote_cqs)
            n_remote += 1
        else:
            q = remote_cqs + (ev.cq % local_span)
        step = start_step + int(ev.t)
        by_step.setdefault(step, []).append(
            (ev.key, f"lq-{q}", ev.cpu_m, ev.priority, ev.runtime_s))
    return by_step, n_remote


class FederationSim:
    """The federation under one deterministic clock (see module doc)."""

    def __init__(self, spec: FedSpec, wal_dir: str,
                 config_clusters=None):
        self.spec = spec
        self.clock = VirtualClock()
        self.step_no = 0
        os.makedirs(wal_dir, exist_ok=True)
        self.wal_dir = wal_dir
        self._drift_scale: dict[str, float] = {}
        self._heal_at: dict[str, int] = {}
        self._dead: set[str] = set()
        self._w_admit_step: dict[str, dict[str, int]] = {}
        self._m_admit_step: dict[str, int] = {}
        self._runtime: dict[str, int] = {}
        self._finished_on: dict[str, set] = {}
        self._traffic: dict[int, list] = {}
        self.ingested = 0
        self.violations: list[dict] = []
        self.counters = {"ejections": 0, "worker_crashes": 0,
                         "mid_admit_crashes": 0, "wal_tail_replayed": 0,
                         "partitions": 0, "heals": 0, "losses": 0,
                         "drift_changes": 0}

        names = [f"w{i}" for i in range(spec.n_workers)]
        self.worker_names = names
        self.manager = Driver(clock=self.clock,
                              use_device_solver=spec.use_device_solver,
                              device=spec.device)
        self._manager_topology()(self.manager)

        self.workers: dict[str, Driver] = {}
        self.wals: dict[str, CycleWAL] = {}
        self._local: dict[str, LocalWorkerClient] = {}
        self.clusters: dict[str, WorkerCluster] = {}
        for name in names:
            self._drift_scale[name] = 1.0
            self._w_admit_step[name] = {}
            d = Driver(clock=self.clock, device=spec.device)
            self._worker_topology(name)(d)
            wal = CycleWAL(os.path.join(wal_dir, f"{name}.wal"))
            d.attach_wal(wal)
            self.workers[name] = d
            self.wals[name] = wal
            raw = LocalWorkerClient(d)
            self._local[name] = raw
            client = (ChaosWorkerClient(raw, backoff_base=0.0,
                                        backoff_max=0.0)
                      if spec.chaos_transport else raw)
            cluster = WorkerCluster(
                name=name, client=client,
                reconnect_budget=spec.reconnect_budget)
            # watches are pumped by the sim, never started as threads
            cluster.watch = WatchLoop(client, poll_timeout=0.0)
            self.clusters[name] = cluster

        self.config = MultiKueueConfig(
            name="fed", clusters=list(config_clusters
                                      if config_clusters is not None
                                      else names))
        self.ctl = MultiKueueController(
            self.manager, check_name="mk", config=self.config,
            clusters=self.clusters, origin="fed",
            worker_lost_timeout=spec.worker_lost_timeout)
        # count re-dispatches without changing controller behavior
        self._orig_reset = self.ctl._reset

        def counting_reset(key):
            self.counters["ejections"] += 1
            self._orig_reset(key)
        self.ctl._reset = counting_reset

    # -- topology ------------------------------------------------------

    def _cq(self, name: str, cohort: str, nominal_m: int,
            checks=()) -> ClusterQueue:
        return ClusterQueue(
            name=name, cohort=cohort,
            queueing_strategy=QueueingStrategy.BEST_EFFORT_FIFO,
            preemption=PreemptionPolicy(),
            admission_checks=list(checks),
            resource_groups=[ResourceGroup(
                covered_resources=["cpu"],
                flavors=[FlavorQuotas(name="default", resources={
                    "cpu": ResourceQuota(nominal=nominal_m)})])])

    def _manager_topology(self):
        sp = self.spec

        def fn(d):
            d.apply_resource_flavor(ResourceFlavor(name="default"))
            d.apply_admission_check(AdmissionCheck(
                name="mk",
                controller_name="kueue.x-k8s.io/multikueue"))
            with d.bulk_apply():
                for q in range(sp.n_cqs):
                    checks = ("mk",) if q < sp.remote_cqs else ()
                    d.apply_cluster_queue(self._cq(
                        f"cq-{q}", f"co-{q // 4}", sp.manager_quota_m,
                        checks))
                    d.apply_local_queue(LocalQueue(
                        name=f"lq-{q}", cluster_queue=f"cq-{q}"))
        return fn

    def _worker_topology(self, name: str):
        sp = self.spec
        scale = self._drift_scale.get(name, 1.0)

        def fn(d):
            d.apply_resource_flavor(ResourceFlavor(name="default"))
            with d.bulk_apply():
                for q in range(sp.remote_cqs):
                    d.apply_cluster_queue(self._cq(
                        f"cq-{q}", f"co-{q // 4}",
                        int(sp.worker_quota_m * scale)))
                    d.apply_local_queue(LocalQueue(
                        name=f"lq-{q}", cluster_queue=f"cq-{q}"))
        return fn

    def _apply_drift(self):
        sp = self.spec
        if not sp.drift_every or self.step_no % sp.drift_every:
            return
        epoch = self.step_no // sp.drift_every
        for name in self.worker_names:
            scale = _drift_pick(sp.seed, name, epoch, sp.drift_factors)
            if scale == self._drift_scale[name]:
                continue
            self._drift_scale[name] = scale
            self.counters["drift_changes"] += 1
            d = self.workers[name]
            with d.bulk_apply():
                for q in range(sp.remote_cqs):
                    d.apply_cluster_queue(self._cq(
                        f"cq-{q}", f"co-{q // 4}",
                        int(sp.worker_quota_m * scale)))

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

    # -- faults --------------------------------------------------------

    def sever(self, name: str) -> None:
        self._local[name].ok = False

    def heal(self, name: str) -> None:
        self._local[name].ok = True

    def _consult_partition(self):
        inj = _chaos.ACTIVE
        if inj is None:
            return
        f = inj.hit("fed.partition")
        if f is not None:
            targets, duration = f.payload
            for name in targets:
                self.sever(name)
                self._heal_at[name] = self.step_no + int(duration)
                self.counters["partitions"] += 1

    def _consult_cluster_loss(self):
        inj = _chaos.ACTIVE
        if inj is None:
            return
        f = inj.hit("fed.cluster_loss")
        if f is not None:
            name = str(f.payload)
            self.sever(name)
            self._dead.add(name)
            self._heal_at.pop(name, None)
            self.counters["losses"] += 1

    def _consult_worker_crash(self):
        inj = _chaos.ACTIVE
        if inj is None:
            return None
        f = inj.hit("fed.worker_crash")
        return None if f is None else str(f.payload)

    def _heal_due(self):
        for name, at in list(self._heal_at.items()):
            if self.step_no >= at:
                self.heal(name)
                del self._heal_at[name]
                self.counters["heals"] += 1

    def _crash_and_recover_worker(self, name: str) -> None:
        """Kill the worker mid-admission — the WAL tail holds the
        journaled-but-unapplied admit — then rebuild it from store +
        journal at the same virtual instant and complete the
        interrupted cycle (the chaos_soak mid-admit protocol, here with
        the manager's watch stream observing the restart: the fresh
        driver's event-log epoch forces a replay-from-zero resync)."""
        old = self.workers[name]
        prev = _chaos.ACTIVE
        scoped = ChaosInjector(seed=self.spec.seed)
        # scoped injector: the manager's own wal.admit hits must not
        # consume this arming
        scoped.arm("wal.admit", at=1)
        _chaos.install(scoped)
        crashed = False
        try:
            old.schedule_once()
        except InjectedCrash:
            crashed = True
            self.counters["mid_admit_crashes"] += 1
        finally:
            if prev is None:
                _chaos.clear()
            else:
                _chaos.install(prev)
        d2 = Driver(clock=self.clock, device=self.spec.device)
        self._worker_topology(name)(d2)
        replayed = d2.recover_from(old.workloads.values(),
                                   self.wals[name])
        self.workers[name] = d2
        self._local[name].driver = d2
        self.clusters[name].driver = d2
        self.counters["worker_crashes"] += 1
        self.counters["wal_tail_replayed"] += replayed
        if crashed:
            d2.schedule_once()   # finish the interrupted cycle

    # -- execution model -----------------------------------------------

    def _drive_worker_finishes(self):
        for name, w in self.workers.items():
            if name in self._dead:
                continue
            seen = self._w_admit_step[name]
            for key, wl in w.workloads.items():
                if (wl.has_quota_reservation and not wl.is_finished
                        and key not in seen):
                    seen[key] = self.step_no
            for key in list(seen):
                wl = w.workloads.get(key)
                if wl is None or not wl.has_quota_reservation:
                    if wl is None or not wl.is_finished:
                        seen.pop(key, None)
                    continue
                if wl.is_finished:
                    continue
                asg = self.ctl.assignments.get(key)
                if asg is None or asg.cluster != name:
                    continue   # only the winner's job executes
                rt = self._runtime.get(key, self.spec.runtime_steps)
                if self.step_no - seen[key] >= rt:
                    w.finish_workload(key, f"Finished on {name}")
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
            rt = self._runtime.get(key, self.spec.runtime_steps)
            if self.step_no - seen[key] >= rt:
                self.manager.finish_workload(key, "Finished locally")

    # -- invariants ----------------------------------------------------

    def _check_invariants(self):
        for key, asg in self.ctl.assignments.items():
            if not asg.cluster:
                continue
            holders = []
            for name, w in self.workers.items():
                if not self.clusters[name].active:
                    continue
                wl = w.workloads.get(key)
                if (wl is not None and wl.has_quota_reservation
                        and not wl.is_finished):
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

    # -- the step ------------------------------------------------------

    def _pump_watches(self):
        for cluster in self.clusters.values():
            cluster.watch.pump()

    def step(self) -> None:
        self.step_no += 1
        self.clock.t += 1.0
        self._consult_cluster_loss()
        self._consult_partition()          # consult #1: step start
        self._heal_due()
        self._apply_drift()
        from ..obs.trace import span as _span
        self._ingest()
        self.manager.schedule_once()
        with _span("fed.sync"):
            self.ctl.reconcile()           # nomination
        crash_target = self._consult_worker_crash()
        for name in self.worker_names:
            if name in self._dead:
                continue
            if name == crash_target:
                self._crash_and_recover_worker(name)
            else:
                self.workers[name].schedule_once()
        # finishes land before the pump so a winner's finish is copied
        # back the same virtual second it happens — a cluster destroyed
        # next step can never strand an already-finished result
        self._drive_worker_finishes()
        self._pump_watches()
        self._consult_partition()          # consult #2: mid-step
        with _span("fed.sync"):
            self.ctl.reconcile()           # winner selection, copy-back
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

    # -- observability -------------------------------------------------

    def assignment_spread(self) -> dict[str, int]:
        """How many finished executions each cluster took (the
        spillover picture capacity drift produces)."""
        spread = {name: 0 for name in self.worker_names}
        for _key, names in self._finished_on.items():
            for name in names:
                spread[name] += 1
        return spread


# ---------------------------------------------------------------------------
# Parity state (the chaos_soak bit-identical bar, federation-wide)
# ---------------------------------------------------------------------------

def full_state(d) -> dict:
    """Every workload's durable status, timestamps included."""
    out = {}
    for key, w in d.workloads.items():
        out[key] = (
            w.is_finished, w.is_active, w.has_quota_reservation,
            None if w.admission is None else (
                w.admission.cluster_queue,
                tuple((a.name, tuple(sorted(a.flavors.items())),
                       tuple(sorted(a.resource_usage.items())), a.count)
                      for a in w.admission.pod_set_assignments)),
            tuple(sorted((c.type, c.status.value, c.reason, c.message,
                          c.last_transition_time)
                         for c in w.conditions.values())),
            tuple(sorted((s.name, s.state.value)
                         for s in w.admission_check_states.values())),
            None if w.requeue_state is None else
            (w.requeue_state.count, w.requeue_state.requeue_at),
        )
    return out


def global_state(sim: FederationSim) -> dict:
    return {"manager": full_state(sim.manager),
            "workers": {name: full_state(w)
                        for name, w in sim.workers.items()}}


def global_digest(sim: FederationSim) -> str:
    g = global_state(sim)
    blob = repr((sorted(g["manager"].items()),
                 sorted((n, sorted(s.items()))
                        for n, s in g["workers"].items()))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def outcome(sim: FederationSim) -> dict:
    """Placement-free outcome: which manager workloads finished.  The
    cluster-loss scenario compares this (plus the zero-double ledgers)
    instead of the bit-identical digest — losing a cluster necessarily
    shifts eviction conditions and timestamps."""
    return {key: wl.is_finished
            for key, wl in sim.manager.workloads.items()}
