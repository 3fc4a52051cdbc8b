"""Admission-check controllers (reference pkg/controller/admissionchecks).

Two-phase admission (KEP 993): the scheduler reserves quota and attaches
pending check states; these controllers flip them to Ready/Retry/Rejected
and the workload only starts when every check is Ready.
"""

# The MultiKueue names (MULTIKUEUE_CONTROLLER_NAME, MultiKueueController,
# WorkerCluster) come with multikueue.py, which needs the remote plane.
from .provisioning import (
    PROVISIONING_CONTROLLER_NAME,
    ProvisioningController,
    ProvisioningRequest,
)

__all__ = [
    "PROVISIONING_CONTROLLER_NAME", "ProvisioningController",
    "ProvisioningRequest",
]
