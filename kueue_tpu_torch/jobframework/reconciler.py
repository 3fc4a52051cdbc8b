"""The generic job reconciler: the job↔workload state machine.

Capability parity with reference
pkg/controller/jobframework/reconciler.go:233 ReconcileGenericJob:

- a managed job must be suspended until its workload is admitted;
- admission injects pod-set info (flavor node selectors, topology,
  admission-check updates) and unsuspends;
- losing quota (eviction/preemption/deactivation) stops the job and
  restores the original pod templates;
- job completion finishes the workload; pod-set equivalence changes
  recreate it (ensureOneWorkload, reconciler.go:642).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..api.types import Workload
from ..podset import (
    PodSetInfo,
    merge_podset_infos,
    podset_infos_from_admission,
)
from .interface import (
    ComposableJob,
    GenericJob,
    JobWithCustomStop,
    JobWithManagedBy,
    JobWithReclaimablePods,
    StopReason,
    workload_name_for_job,
)

MANAGER_NAME = "kueue-tpu.x-k8s.io/controller"


class JobReconciler:
    """reference jobframework/reconciler.go JobReconciler."""

    def __init__(self, driver, manager_name: str = MANAGER_NAME):
        self.driver = driver
        self.manager_name = manager_name

    # ------------------------------------------------------------------

    def workload_key_for(self, job: GenericJob) -> str:
        return f"{job.namespace}/{workload_name_for_job(job.gvk, job.name)}"

    def reconcile(self, job: GenericJob) -> None:
        driver = self.driver
        wl_key = self.workload_key_for(job)
        wl = driver.workload(wl_key)

        # MultiKueue: a job managed by another controller stays suspended
        # here (reference JobWithManagedBy, interface.go:158)
        if isinstance(job, JobWithManagedBy):
            mb = job.managed_by()
            if mb is not None and mb != self.manager_name:
                return

        message, success, finished = job.finished()
        if finished:
            if wl is not None and not wl.is_finished:
                driver.finish_workload(wl_key, message or "Job finished")
            return

        if not job.queue_name and wl is None:
            return  # not managed (reference manageability checks)

        if wl is None:
            if not job.is_suspended():
                # job started without admission — gate it
                self._stop(job, None, StopReason.NO_MATCHING_WORKLOAD,
                           "No matching Workload; suspending")
                return
            driver.create_workload(self._construct_workload(job))
            return

        if not wl.is_admitted and not self._equivalent(job, wl):
            # pod sets changed under us: recreate (ensureOneWorkload)
            driver.delete_workload(wl_key)
            driver.create_workload(self._construct_workload(job))
            return

        if wl.is_admitted and job.is_suspended():
            self._start(job, wl)
            return

        if not wl.has_quota_reservation and not job.is_suspended():
            self._stop(job, wl, StopReason.NOT_ADMITTED,
                       "Not admitted; suspending")
            return

        if wl.is_admitted and not job.is_suspended():
            # PodsReady condition sync from the running job (reference
            # workload_controller.go PodsReady handling; feeds the
            # WaitForPodsReady blockAdmission gate + timeout countdown)
            driver.set_pods_ready(wl_key, job.pods_ready())

        if isinstance(job, JobWithReclaimablePods) and wl.has_quota_reservation:
            rp = job.reclaimable_pods()
            if rp:
                driver.update_reclaimable_pods(wl_key, rp)

    # ------------------------------------------------------------------

    def _construct_workload(self, job: GenericJob) -> Workload:
        """reference interface.go:209 NewWorkload / ConstructWorkload."""
        if isinstance(job, ComposableJob):
            wl = job.construct_composable_workload()
        else:
            wl = Workload(
                name=workload_name_for_job(job.gvk, job.name),
                namespace=job.namespace,
                queue_name=job.queue_name,
                pod_sets=job.pod_sets())
        pc = job.priority_class_name
        if pc:
            resolved = self.driver.resolve_priority_class(pc)
            if resolved is not None:
                wl.priority = resolved.value
                wl.priority_class_name = resolved.name
                wl.priority_class_source = "kueue.x-k8s.io/workloadpriorityclass"
        if not wl.creation_time:
            wl.creation_time = self.driver.clock()
        return wl

    def _equivalent(self, job: GenericJob, wl: Workload) -> bool:
        """Pod-set equivalence (reference reconciler.go equivalentToWorkload)."""
        job_ps = (job.construct_composable_workload().pod_sets
                  if isinstance(job, ComposableJob) else job.pod_sets())
        if len(job_ps) != len(wl.pod_sets):
            return False
        for a, b in zip(job_ps, wl.pod_sets):
            if (a.name, a.count, dict(a.requests)) != (
                    b.name, b.count, dict(b.requests)):
                return False
        return True

    def _podset_infos(self, wl: Workload) -> list[PodSetInfo]:
        flavors = self.driver.cache.resource_flavors
        infos = podset_infos_from_admission(
            wl.pod_sets, wl.admission.pod_set_assignments, flavors)
        updates = [PodSetInfo.from_update(u)
                   for st in wl.admission_check_states.values()
                   for u in st.pod_set_updates]
        if updates:
            merge_podset_infos(infos, updates)
        return infos

    def _start(self, job: GenericJob, wl: Workload) -> None:
        """reference reconciler.go startJob."""
        job.run_with_podsets_info(self._podset_infos(wl))
        self.driver.events.append(("Started", job.key, wl.key))

    def _stop(self, job: GenericJob, wl: Optional[Workload],
              reason: StopReason, message: str) -> None:
        """reference reconciler.go stopJob."""
        infos: Sequence[PodSetInfo] = ()
        if wl is not None and wl.admission is not None:
            infos = self._podset_infos(wl)
        if isinstance(job, JobWithCustomStop):
            job.stop(infos, reason, message)
        else:
            job.suspend()
            job.restore_podsets_info(infos)
        self.driver.events.append(("Stopped", job.key, reason.value))


class JobManager:
    """Holds live jobs and drives reconciliation rounds against the
    driver (the in-process stand-in for controller-runtime watches)."""

    def __init__(self, driver, manager_name: str = MANAGER_NAME):
        self.driver = driver
        self.reconciler = JobReconciler(driver, manager_name)
        self.jobs: dict[str, GenericJob] = {}

    def upsert(self, job: GenericJob) -> None:
        """Admit a job object through the webhook chain, then reconcile
        (the controller-runtime webhook → watch → reconcile path)."""
        from .webhook import validate_job_create, validate_job_update
        old = self.jobs.get(job.key)
        if old is None or old is job:
            validate_job_create(job)
        else:
            validate_job_update(old, job)
        self.jobs[job.key] = job
        self.reconciler.reconcile(job)

    def delete(self, job_key: str) -> None:
        job = self.jobs.pop(job_key, None)
        if job is not None:
            self.driver.delete_workload(
                self.reconciler.workload_key_for(job))

    def sync(self) -> None:
        for job in list(self.jobs.values()):
            self.reconciler.reconcile(job)

    def run(self, max_rounds: int = 25) -> None:
        """Reconcile + schedule until a fixed point."""
        for _ in range(max_rounds):
            self.sync()
            self.driver.run_until_settled()
            self.sync()
            before = self._fingerprint()
            self.driver.run_until_settled()
            self.sync()
            if self._fingerprint() == before:
                return

    def _fingerprint(self):
        return (tuple(sorted(self.driver.admitted_keys())),
                tuple((k, j.is_suspended(), j.finished()[2])
                      for k, j in sorted(self.jobs.items())))
