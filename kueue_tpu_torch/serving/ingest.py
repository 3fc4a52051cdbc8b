"""Thread-safe bounded ingest queue for the admission service.

Concurrent submitter threads append :class:`Submission` entries; the
service thread drains the whole queue at each cycle boundary
(service.py step) into ``Driver.ingest_workloads``.  Entries keep
their journal sequence number, so a drain hands the batch over in
exact acceptance order and recovery can re-enqueue the un-applied
suffix in the same order the original process accepted it.

The queue itself is mechanics only — append / remove / drain /
introspection under one lock.  The backpressure *policy* (reject past
the high-water mark, shed lowest-priority pending first) lives in the
service, which composes a policy decision with the journal append and
the queue mutation under its own lock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Submission:
    """One accepted submission, as journaled and as queued."""

    token: str               # idempotency token (defaults to the key)
    seq: int                 # ingest-journal sequence number
    name: str
    namespace: str
    queue_name: str
    priority: int
    creation_time: float     # the driver clock's time at acceptance
    requests: dict = field(default_factory=dict)
    count: int = 1
    runtime_s: float = 0.0   # service time once admitted (0 = external)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def payload(self) -> dict:
        """The journaled form — everything needed to rebuild the
        workload bit-identically after a crash."""
        return {"name": self.name, "namespace": self.namespace,
                "queue_name": self.queue_name, "priority": self.priority,
                "creation_time": self.creation_time,
                "requests": dict(self.requests), "count": self.count,
                "runtime_s": self.runtime_s}

    @classmethod
    def from_payload(cls, payload: dict, token: str,
                     seq: int) -> "Submission":
        return cls(token=token, seq=seq, name=payload["name"],
                   namespace=payload["namespace"],
                   queue_name=payload["queue_name"],
                   priority=payload["priority"],
                   creation_time=payload["creation_time"],
                   requests=dict(payload["requests"]),
                   count=payload["count"],
                   runtime_s=payload["runtime_s"])


class IngestQueue:
    """Seq-ordered pending submissions, safe under concurrent append
    (submitters) and drain (the service cycle loop)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: list[Submission] = []

    def append(self, sub: Submission) -> None:
        with self._lock:
            self._entries.append(sub)

    def remove(self, sub: Submission) -> bool:
        with self._lock:
            try:
                self._entries.remove(sub)
                return True
            except ValueError:
                return False

    def drain(self) -> list[Submission]:
        """Atomically take everything, in acceptance (seq) order."""
        with self._lock:
            out, self._entries = self._entries, []
        out.sort(key=lambda s: s.seq)
        return out

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def lowest_priority(self) -> Optional[Submission]:
        """The shed candidate: lowest priority, youngest (largest seq)
        among ties — the entry whose loss costs the least and whose
        submitter waited the shortest."""
        with self._lock:
            if not self._entries:
                return None
            return min(self._entries, key=lambda s: (s.priority, -s.seq))

    def position(self, token: str) -> Optional[int]:
        """0-based drain position of a pending submission, None when
        the token is not (or no longer) pending."""
        with self._lock:
            ordered = sorted(self._entries, key=lambda s: s.seq)
        for i, sub in enumerate(ordered):
            if sub.token == token:
                return i
        return None

    def snapshot(self) -> list[Submission]:
        with self._lock:
            return sorted(self._entries, key=lambda s: s.seq)
