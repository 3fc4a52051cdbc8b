"""Seeded, deterministic arrival processes for open-loop traffic.

Every process and the stream wrapper are pure functions of their seed:
the same ``(process, spec, seed)`` triple yields the same event
sequence across runs, and a pickle round-trip mid-stream resumes with
the identical tail (``random.Random`` pickles its full Mersenne state).
Event timestamps are *virtual* seconds; the runner quantizes them onto
scheduling cycles, which is what makes a recorded stream replayable
decision-bit-identically (traffic/runner.py).

Seeds are mixed with integer constants only — never hashed tuples or
strings, whose hashes are salted per-process by PYTHONHASHSEED and
would silently break cross-run determinism.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Iterator, Optional

_MIX_PROCESS = 0x9E3779B1   # golden-ratio constants: decorrelate the
_MIX_MARKS = 0x85EBCA6B     # process clock from the mark draws


@dataclass(frozen=True)
class TrafficEvent:
    """One event in the open-loop stream.

    ``submit`` carries the full workload shape; ``cancel`` and
    ``priority`` target a previously-submitted key (``cq`` is -1 and
    the shape fields are unused)."""

    t: float                 # virtual arrival time, seconds
    kind: str                # "submit" | "cancel" | "priority"
    key: str                 # workload key ("<namespace>/<name>")
    cq: int                  # target ClusterQueue index (lq-<cq>)
    cpu_m: int = 0           # millicpu request
    priority: int = 0        # submit: initial prio; priority: new prio
    runtime_s: float = 0.0   # service time once admitted
    remote: bool = False     # route through the MultiKueue worker client


@dataclass(frozen=True)
class TrafficSpec:
    """Workload-mark distribution: what each arrival looks like."""

    n_cqs: int
    namespace: str = "default"
    cpu_choices: tuple = (1500,)
    priorities: tuple = (0, 10, 20)
    runtime_choices_s: tuple = (2.0,)
    cancel_fraction: float = 0.02     # share of arrivals that cancel
    churn_fraction: float = 0.02      # share that re-prioritize
    remote_fraction: float = 0.0      # share submitted via remote.py
    live_window: int = 4096           # recent-key pool for cancel/churn


class PoissonProcess:
    """Homogeneous Poisson arrivals: exponential inter-arrival gaps."""

    def __init__(self, rate_per_s: float, seed: int = 0):
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        self.rate_per_s = float(rate_per_s)
        self._rng = random.Random(_MIX_PROCESS ^ (seed & 0xFFFFFFFF))

    def next_gap(self, t: float) -> float:
        return self._rng.expovariate(self.rate_per_s)

    def describe(self) -> dict:
        return {"process": "poisson", "rate_per_s": self.rate_per_s}


class DiurnalProcess:
    """Sinusoidal rate between trough and peak over ``period_s``,
    sampled exactly by Lewis–Shedler thinning against the peak rate."""

    def __init__(self, trough_rate_per_s: float, peak_rate_per_s: float,
                 period_s: float, seed: int = 0):
        if not (0 < trough_rate_per_s <= peak_rate_per_s):
            raise ValueError("need 0 < trough <= peak")
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self.trough_rate_per_s = float(trough_rate_per_s)
        self.peak_rate_per_s = float(peak_rate_per_s)
        self.period_s = float(period_s)
        self._rng = random.Random(_MIX_PROCESS ^ (seed & 0xFFFFFFFF))

    def rate_at(self, t: float) -> float:
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period_s))
        return (self.trough_rate_per_s
                + (self.peak_rate_per_s - self.trough_rate_per_s) * phase)

    def next_gap(self, t: float) -> float:
        t0 = t
        while True:
            t0 += self._rng.expovariate(self.peak_rate_per_s)
            if self._rng.random() * self.peak_rate_per_s <= self.rate_at(t0):
                return t0 - t

    def describe(self) -> dict:
        return {"process": "diurnal",
                "trough_rate_per_s": self.trough_rate_per_s,
                "peak_rate_per_s": self.peak_rate_per_s,
                "period_s": self.period_s}


class MMPPProcess:
    """2-state Markov-modulated Poisson (bursty traffic): exponential
    dwell in a quiet and a burst state, Poisson arrivals at the active
    state's rate, simulated by competing exponentials."""

    def __init__(self, quiet_rate_per_s: float, burst_rate_per_s: float,
                 mean_dwell_s: float, seed: int = 0,
                 burst_dwell_s: Optional[float] = None):
        if quiet_rate_per_s < 0 or burst_rate_per_s <= 0:
            raise ValueError("rates must be non-negative (burst positive)")
        if mean_dwell_s <= 0:
            raise ValueError("mean_dwell_s must be positive")
        self.rates = (float(quiet_rate_per_s), float(burst_rate_per_s))
        self.dwells = (float(mean_dwell_s),
                       float(burst_dwell_s
                             if burst_dwell_s is not None else mean_dwell_s))
        self.state = 0
        self._dwell_left: Optional[float] = None
        self._rng = random.Random(_MIX_PROCESS ^ (seed & 0xFFFFFFFF))

    def next_gap(self, t: float) -> float:
        acc = 0.0
        while True:
            if self._dwell_left is None:
                self._dwell_left = self._rng.expovariate(
                    1.0 / self.dwells[self.state])
            rate = self.rates[self.state]
            gap = (self._rng.expovariate(rate) if rate > 0
                   else float("inf"))
            if gap <= self._dwell_left:
                self._dwell_left -= gap
                return acc + gap
            acc += self._dwell_left
            self.state ^= 1
            self._dwell_left = None

    def describe(self) -> dict:
        return {"process": "mmpp",
                "quiet_rate_per_s": self.rates[0],
                "burst_rate_per_s": self.rates[1],
                "mean_dwell_s": self.dwells[0],
                "burst_dwell_s": self.dwells[1]}


class ArrivalStream:
    """Infinite deterministic event iterator.

    Each process arrival is marked as a submit, a cancel of a recent
    key, or a priority churn of a recent key, using an independent
    seeded mark generator so changing the arrival process doesn't
    reshuffle the marks.  The recent-key pool is bounded
    (``spec.live_window``) so state stays O(1)."""

    def __init__(self, process, spec: TrafficSpec, seed: int = 0):
        self.process = process
        self.spec = spec
        self.seed = seed
        self._marks = random.Random(_MIX_MARKS ^ ((seed + 1) & 0xFFFFFFFF))
        self.t = 0.0
        self.n = 0
        self._recent: list[str] = []

    def __iter__(self) -> Iterator[TrafficEvent]:
        return self

    def __next__(self) -> TrafficEvent:
        sp = self.spec
        m = self._marks
        self.t += self.process.next_gap(self.t)
        roll = m.random()
        if self._recent and roll < sp.cancel_fraction:
            key = self._recent.pop(m.randrange(len(self._recent)))
            return TrafficEvent(t=self.t, kind="cancel", key=key, cq=-1)
        if self._recent and roll < sp.cancel_fraction + sp.churn_fraction:
            key = self._recent[m.randrange(len(self._recent))]
            return TrafficEvent(t=self.t, kind="priority", key=key, cq=-1,
                                priority=m.choice(sp.priorities))
        self.n += 1
        key = f"{sp.namespace}/t{self.n}"
        self._recent.append(key)
        if len(self._recent) > sp.live_window:
            self._recent.pop(0)
        return TrafficEvent(
            t=self.t, kind="submit", key=key,
            cq=m.randrange(sp.n_cqs),
            cpu_m=m.choice(sp.cpu_choices),
            priority=m.choice(sp.priorities),
            runtime_s=m.choice(sp.runtime_choices_s),
            remote=m.random() < sp.remote_fraction)

    def take(self, n: int) -> list[TrafficEvent]:
        return [next(self) for _ in range(n)]

    def describe(self) -> dict:
        d = dict(self.process.describe())
        d["seed"] = self.seed
        d["n_cqs"] = self.spec.n_cqs
        return d


class ReplayStream:
    """Finite iterator over a recorded event list — the replay arm of
    the decision-bit-identity check (runner records every event it
    consumed; rerunning through a ReplayStream must produce identical
    per-cycle decisions)."""

    def __init__(self, events):
        self._events = list(events)
        self._i = 0

    def __iter__(self) -> Iterator[TrafficEvent]:
        return self

    def __next__(self) -> TrafficEvent:
        if self._i >= len(self._events):
            raise StopIteration
        ev = self._events[self._i]
        self._i += 1
        return ev
