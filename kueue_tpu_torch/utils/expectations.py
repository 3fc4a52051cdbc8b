"""Expectations store (reference pkg/util/expectations/store.go:30).

A UID-set synchronization barrier: a controller records the object UIDs
whose updates it initiated and only trusts its cache once every expected
update has been observed — the pod-group integration uses it to avoid
racing its own ungate patches (reference pod integration)."""

from __future__ import annotations

import threading


class Store:
    def __init__(self, name: str = "expectations"):
        self.name = name
        self._lock = threading.Lock()
        self._store: dict[str, set[str]] = {}

    def expect_uids(self, key: str, uids: list[str]) -> None:
        """reference store.go ExpectUIDs."""
        with self._lock:
            self._store.setdefault(key, set()).update(uids)

    def observed_uid(self, key: str, uid: str) -> None:
        """reference store.go ObservedUID."""
        with self._lock:
            uids = self._store.get(key)
            if uids is not None:
                uids.discard(uid)
                if not uids:
                    del self._store[key]

    def satisfied(self, key: str) -> bool:
        """reference store.go Satisfied: all expected updates observed."""
        with self._lock:
            return not self._store.get(key)

    def forget(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)
