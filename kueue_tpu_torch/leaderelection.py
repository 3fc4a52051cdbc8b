"""Leader election for the file-store deployment.

The reference gates the scheduler behind Kubernetes lease-based leader
election (pkg/config/config.go:97-110; scheduler.go:150-154 runs only
when elected).  The file-store equivalent is an exclusive ``flock`` on
``<state-dir>/leader.lock``: exactly one ``cli serve`` daemon per store
is active; others wait until the leader exits and then take over.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class FileLease:
    """Exclusive advisory lock on the store's leader.lock file."""

    def __init__(self, state_dir: str):
        self.path = os.path.join(state_dir, "leader.lock")
        self._fd: Optional[int] = None

    @property
    def held(self) -> bool:
        return self._fd is not None

    def try_acquire(self) -> bool:
        """Non-blocking acquisition attempt."""
        import fcntl
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._fd = fd
        return True

    def acquire(self, stop: Optional[threading.Event] = None,
                poll_interval: float = 0.1) -> bool:
        """Block until leadership is acquired or ``stop`` is set."""
        while True:
            if self.try_acquire():
                return True
            if stop is not None:
                if stop.wait(poll_interval):
                    return False
            else:
                import time
                time.sleep(poll_interval)

    def release(self) -> None:
        if self._fd is not None:
            import fcntl
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
