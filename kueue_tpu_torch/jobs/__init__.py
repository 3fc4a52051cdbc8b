"""Concrete job integrations (reference pkg/controller/jobs/*).

Importing this package registers every built-in integration with the
jobframework registry, mirroring the reference's blank-import pattern
(pkg/controller/jobs/jobs.go:12-23).  The set mirrors the reference's 11
frameworks: batch Job, Pod (+ pod groups), JobSet, the Kubeflow family
(TFJob/PyTorchJob/XGBoostJob/PaddleJob/JAXJob), MPIJob, RayJob,
RayCluster, AppWrapper, LeaderWorkerSet, StatefulSet, Deployment.
"""

from .batch_job import BatchJob
from .pod import PlainPod, PodGroup
from .jobset import JobSet, ReplicatedJobSpec
from .kubeflow import (
    JAXJob,
    MPIJob,
    PaddleJob,
    PyTorchJob,
    ReplicaSpec,
    TFJob,
    XGBoostJob,
)
from .ray import RayCluster, RayJob
from .appwrapper import AppWrapper
from .serving import Deployment, LeaderWorkerSet, StatefulSet

__all__ = [
    "AppWrapper", "BatchJob", "Deployment", "JAXJob", "JobSet",
    "LeaderWorkerSet", "MPIJob", "PaddleJob", "PlainPod", "PodGroup",
    "PyTorchJob", "RayCluster", "RayJob", "ReplicaSpec",
    "ReplicatedJobSpec", "StatefulSet", "TFJob", "XGBoostJob",
]
