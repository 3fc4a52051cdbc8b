"""Admission-check controllers (reference pkg/controller/admissionchecks).

Two-phase admission (KEP 993): the scheduler reserves quota and attaches
pending check states; these controllers flip them to Ready/Retry/Rejected
and the workload only starts when every check is Ready.
"""

from .multikueue import MULTIKUEUE_CONTROLLER_NAME, MultiKueueController, WorkerCluster
from .provisioning import (
    PROVISIONING_CONTROLLER_NAME,
    ProvisioningController,
    ProvisioningRequest,
)

__all__ = [
    "MULTIKUEUE_CONTROLLER_NAME", "MultiKueueController", "WorkerCluster",
    "PROVISIONING_CONTROLLER_NAME", "ProvisioningController",
    "ProvisioningRequest",
]
