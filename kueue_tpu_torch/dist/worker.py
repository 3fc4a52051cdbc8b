"""Federation-worker process build and recovery.

A federation worker process is a real ``WorkerServer`` (remote.py)
around a Driver with the FederationSim worker topology.  Its durable
state is two journals: a ``ManifestJournal`` of every workload
manifest the manager created (written before the create's ack) and a
``CycleWAL`` of every decision since.  A SIGKILLed worker therefore
rebuilds bit-identically: manifests → initial store, WAL committed
history → every decision replayed (``replay_history``; compaction is
off in worker processes), WAL tail → the possibly half-applied last
cycle (``Driver.recover_from``).  The restarted server presents a
fresh watch epoch, which is what drives the manager's ``__resync__``
path over a real socket.
"""

from __future__ import annotations

from typing import Optional

from ..api import manifests as m
from ..api.types import (
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    PreemptionPolicy,
    QueueingStrategy,
    ResourceFlavor,
    ResourceGroup,
    ResourceQuota,
)
from ..controller.driver import Driver
from ..utils.journal import CycleWAL, ManifestJournal
from .serving import VirtualClock


def worker_topology(remote_cqs: int, quota_m: int = 4000):
    """The FederationSim worker shape: cohorts of 4, BEST_EFFORT_FIFO,
    lq-N → cq-N, one cpu flavor."""
    def fn(d):
        d.apply_resource_flavor(ResourceFlavor(name="default"))
        with d.bulk_apply():
            for q in range(remote_cqs):
                d.apply_cluster_queue(ClusterQueue(
                    name=f"cq-{q}", cohort=f"co-{q // 4}",
                    queueing_strategy=QueueingStrategy.BEST_EFFORT_FIFO,
                    preemption=PreemptionPolicy(),
                    resource_groups=[ResourceGroup(
                        covered_resources=["cpu"],
                        flavors=[FlavorQuotas(name="default", resources={
                            "cpu": ResourceQuota(nominal=quota_m)})])]))
                d.apply_local_queue(LocalQueue(
                    name=f"lq-{q}", cluster_queue=f"cq-{q}"))
    return fn


def worker_paths(state_dir: str, name: str) -> tuple[str, str]:
    return (f"{state_dir}/{name}.wal", f"{state_dir}/{name}.manifests")


def build_worker(name: str, remote_cqs: int, state_dir: str,
                 quota_m: int = 4000, epoch_t: float = 1000.0,
                 device: str = "cuda"
                 ) -> tuple[Driver, VirtualClock, CycleWAL, ManifestJournal]:
    """Fresh worker process state: driver + virtual clock + both
    durable journals (WAL compaction off — recovery replays the full
    decision history)."""
    wal_path, mf_path = worker_paths(state_dir, name)
    clock = VirtualClock(epoch_t)
    d = Driver(clock=clock, device=device)
    worker_topology(remote_cqs, quota_m)(d)
    wal = CycleWAL(wal_path, compact_every=0)
    d.attach_wal(wal)
    journal = ManifestJournal(mf_path)
    return d, clock, wal, journal


def recover_worker(name: str, remote_cqs: int, state_dir: str,
                   quota_m: int = 4000, epoch_t: float = 1000.0,
                   resume_t: Optional[float] = None, device: str = "cuda"
                   ) -> tuple[Driver, VirtualClock, CycleWAL,
                              ManifestJournal, int]:
    """Rebuild a SIGKILLed worker from its journals alone.

    Initial store = the manifest journal folded (tombstones applied);
    then the WAL's committed history replays every admit/evict/finish
    since; then ``recover_from`` rolls the uncommitted tail forward and
    rebuilds cache/queues.  ``resume_t`` positions the virtual clock
    (the lockstep parent knows the step time at kill).  Returns the
    rebuilt pieces plus the count of tail ops replayed."""
    wal_path, mf_path = worker_paths(state_dir, name)
    wal = CycleWAL.resume(wal_path)
    store = {}
    for key, doc in ManifestJournal.load(mf_path).items():
        store[key] = m.from_manifest(doc)
    wal.replay_history(store)
    clock = VirtualClock(epoch_t if resume_t is None else resume_t)
    d = Driver(clock=clock, device=device)
    worker_topology(remote_cqs, quota_m)(d)
    replayed = d.recover_from(store.values(), wal)
    journal = ManifestJournal(mf_path)
    return d, clock, wal, journal, replayed
