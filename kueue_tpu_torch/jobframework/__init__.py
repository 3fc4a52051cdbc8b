"""The job-integration framework (reference pkg/controller/jobframework).

A GenericJob SPI + generic reconciler driving the job↔workload state
machine, and a registry of integrations.  Concrete integrations live in
``kueue_tpu.jobs``.
"""

from .interface import (
    ComposableJob,
    GenericJob,
    IntegrationCallbacks,
    JobWithCustomStop,
    JobWithManagedBy,
    JobWithReclaimablePods,
    StopReason,
    for_each_integration,
    get_integration,
    register_integration,
    workload_name_for_job,
)
from .reconciler import JobManager, JobReconciler

__all__ = [
    "ComposableJob", "GenericJob", "IntegrationCallbacks",
    "JobWithCustomStop", "JobWithManagedBy", "JobWithReclaimablePods",
    "StopReason", "JobManager", "JobReconciler",
    "for_each_integration", "get_integration", "register_integration",
    "workload_name_for_job",
]
