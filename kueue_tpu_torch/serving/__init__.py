"""Serving: the long-lived concurrent admission service around Driver.

``service`` owns the loop (submit → durable ingest journal →
cycle-boundary drain → K scheduling cycles), the backpressure and
adaptive-burst-window policies, graceful drain, and crash recovery;
``ingest`` is the thread-safe queue between submitter threads and the
service thread.  The HTTP surface (submit, queue position, pending
listing) hangs off ``visibility.VisibilityServer``.
"""

from .ingest import IngestQueue, Submission
from .service import (
    AdmissionService,
    ServiceConfig,
    SubmitResult,
    recover_service,
)

__all__ = [
    "AdmissionService",
    "IngestQueue",
    "ServiceConfig",
    "SubmitResult",
    "Submission",
    "recover_service",
]
