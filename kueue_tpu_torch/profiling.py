"""torch.profiler integration: per-cycle step markers + on-demand traces.

One ``record_function`` range per scheduling cycle, so the kernel launches
of a cycle (admit scans, preemption searches) line up under named cycle
steps in the exported Chrome/Perfetto trace.

Usage: ``start_trace(logdir)`` / ``stop_trace()`` around any driver
activity; ``stop_trace`` writes ``trace.json`` into logdir.
``cycle_step`` and ``annotation`` are no-ops until a trace is active.

``DeviceClock`` reads what ran on the card over a stretch of work from
the profiler's CUDA activity alone (CUPTI, no host events): the
kernels' launches record no timing events of their own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

_active = threading.Event()
_prof = None
_logdir: Optional[str] = None


def start_trace(logdir: str) -> None:
    """Begin a torch.profiler trace (host + CUDA activity) to logdir."""
    global _prof, _logdir
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _prof = profile(activities=activities)
    _prof.__enter__()
    _logdir = logdir
    _active.set()


def stop_trace():
    """End the active trace, export ``<logdir>/trace.json`` and return the
    profiler (its ``key_averages()`` has the per-kernel sums)."""
    global _prof
    if not _active.is_set():
        return None
    _active.clear()
    prof, _prof = _prof, None
    prof.__exit__(None, None, None)
    os.makedirs(_logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(_logdir, "trace.json"))
    return prof


def trace_active() -> bool:
    return _active.is_set()


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """start_trace/stop_trace as a context; no-op when logdir is None."""
    if not logdir:
        yield
        return
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


@contextlib.contextmanager
def cycle_step(cycle: int):
    """Mark one scheduling cycle as a profiler range."""
    if not _active.is_set():
        yield
        return
    from torch.profiler import record_function
    with record_function(f"schedule_cycle#{cycle}"):
        yield


@contextlib.contextmanager
def annotation(name: str):
    """Named sub-range (nominate / admit-scan / preemption-search)."""
    if not _active.is_set():
        yield
        return
    from torch.profiler import record_function
    with record_function(name):
        yield


class DeviceClock:
    """Device activity of the work inside the block, from torch.profiler's
    CUDA activity (CUPTI): ``kernel_ms`` / ``kernel_count`` per kernel of
    ``kernels.KERNELS`` (each ``__global__`` symbol mapped to its
    launcher's name by ``kernels.launcher_of``), ``other_ms`` of every
    other activity (PyTorch's kernels, copies, fills), ``busy_ms`` the
    union of all activity intervals, ``activities`` their number, and
    ``spans_us`` every activity's (start, end) by name, in microseconds.
    The busy-wait kernels of ``torch.cuda._sleep`` are left out of all of
    these; ``spin_us`` keeps their spans.  The block ends with
    ``torch.cuda.synchronize()``.  One clock at a time, and not inside
    ``start_trace``.

    Late in a ten-minute process on an H100, the profiler dropped the
    first 44 to 50 device activities of many sessions (a count fixed
    within the process, whatever the activities' durations: a 50 ms spin
    and 49 launches, or 49 of 1,200 short kernels), all of them in a
    session of 51; and the device's timestamps, converted to the host's
    clock, drifted 1.4 ms from it, while it keeps only the activities
    inside its window on the host's clock.  So a session starts with
    ``PAD`` throwaway spins, and its window is held open ``MARGIN_S`` on
    the host before the work and after its synchronize."""

    PAD = 256
    MARGIN_S = 0.05

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(self.MARGIN_S)
        for _ in range(self.PAD):
            torch.cuda._sleep(1)
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        time.sleep(self.MARGIN_S)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.events())
        self._prof = None

    def _read(self, events) -> None:
        from torch.autograd import DeviceType

        from . import kernels
        self.kernel_ms = dict.fromkeys(kernels.KERNELS, 0.0)
        self.kernel_count = dict.fromkeys(kernels.KERNELS, 0)
        self.spans_us: dict[str, list] = {}
        self.spin_us: list = []
        self.other_ms = 0.0
        spans = []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            t0, t1 = e.time_range.start, e.time_range.end
            if "spin_kernel" in e.name:
                self.spin_us.append((t0, t1))
                continue
            spans.append((t0, t1))
            self.spans_us.setdefault(e.name, []).append((t0, t1))
            name = kernels.launcher_of(e.name)
            if name is None:
                self.other_ms += (t1 - t0) / 1e3
            else:
                self.kernel_ms[name] += (t1 - t0) / 1e3
                self.kernel_count[name] += 1
        self.activities = len(spans)
        busy, end = 0.0, float("-inf")
        for t0, t1 in sorted(spans):
            if t1 > end:
                busy += t1 - max(t0, end)
                end = t1
        self.busy_ms = busy / 1e3
