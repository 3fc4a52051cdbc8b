"""The open-loop traffic subsystem of the port (``kueue_tpu_torch.traffic``)
against the JAX package's: the cases of tests/test_traffic_arrivals.py on
the port, the same seed giving the same event stream in both packages;
the cases of tests/test_traffic_openloop.py (the remote-routing one
through each package's ``remote.LocalWorkerClient``) with every
``OpenLoopResult``
decision and latency equal between the JAX Driver (host solver, as the
reference test builds it) and the port's ``Driver(device="cpu")`` at 8
CQs; replay bit-identity, the bisection, and chip_smoke.py phase 19's
run (``scenarios.traffic_probe``) small on both packages.  Tolerance
0."""

from __future__ import annotations

import dataclasses
import importlib
import pickle
from types import SimpleNamespace

import pytest

from kueue_tpu_torch import scenarios
from kueue_tpu_torch.traffic import (
    ArrivalStream,
    DiurnalProcess,
    MMPPProcess,
    OpenLoopResult,
    PoissonProcess,
    ReplayStream,
    TrafficSpec,
    find_sustainable_rate,
)
from tests.conftest import FakeClock

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")
SPEC = dict(n_cqs=8, cpu_choices=(500, 1500), priorities=(0, 10, 20),
            runtime_choices_s=(2.0, 4.0), cancel_fraction=0.05,
            churn_fraction=0.05, remote_fraction=0.25)
N_CQS = 8
# 8 CQs x 2 slots (4000m / 1500m) / 2 s runtime: ~8 admissions/s capacity
LOOP_SPEC = dict(n_cqs=N_CQS, cpu_choices=(1500,), priorities=(0, 10, 20),
                 runtime_choices_s=(2.0,), cancel_fraction=0.02,
                 churn_fraction=0.02)


def package(root):
    """Package ``root``'s modules that the cases use."""
    m = SimpleNamespace(**{
        name.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{name}")
        for name in ("api.types", "traffic", "controller.driver",
                     "remote")})
    m.root = root
    return m


def procs(m, seed):
    tr = m.traffic
    return [tr.PoissonProcess(5.0, seed=seed),
            tr.DiurnalProcess(1.0, 10.0, period_s=60.0, seed=seed),
            tr.MMPPProcess(1.0, 20.0, mean_dwell_s=5.0, seed=seed)]


def stream(m, i, seed, spec=SPEC):
    return m.traffic.ArrivalStream(procs(m, seed)[i],
                                   m.traffic.TrafficSpec(**spec), seed=seed)


def rows(events):
    return [dataclasses.astuple(e) for e in events]


PORT = package("kueue_tpu_torch")


# -- arrivals (tests/test_traffic_arrivals.py on the port) -----------------

@pytest.mark.parametrize("i", range(3))
def test_same_seed_identical_stream(i):
    assert stream(PORT, i, 11).take(300) == stream(PORT, i, 11).take(300)


@pytest.mark.parametrize("i", range(3))
def test_different_seed_differs(i):
    assert stream(PORT, i, 11).take(100) != stream(PORT, i, 12).take(100)


@pytest.mark.parametrize("i", range(3))
def test_pickle_roundtrip_resumes_identical_tail(i):
    live = stream(PORT, i, 7)
    live.take(150)
    clone = pickle.loads(pickle.dumps(live))
    assert live.take(50) == clone.take(50)


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("seed", [3, 11])
def test_same_seed_same_stream_in_both_packages(i, seed):
    """A seeded stream is the JAX package's event for event: times,
    kinds, keys, CQs, shapes, priorities, runtimes, remote flags."""
    got = [rows(stream(package(root), i, seed).take(400))
           for root in PACKAGES]
    assert got[0] == got[1]


def test_event_shape_and_marks():
    spec = TrafficSpec(**SPEC)
    evs = ArrivalStream(PoissonProcess(10.0, seed=3), spec, seed=3).take(500)
    assert all(e1.t <= e2.t for e1, e2 in zip(evs, evs[1:]))
    assert {e.kind for e in evs} == {"submit", "cancel", "priority"}
    submitted = set()
    for e in evs:
        if e.kind == "submit":
            assert 0 <= e.cq < spec.n_cqs
            assert e.cpu_m in spec.cpu_choices
            assert e.priority in spec.priorities
            assert e.runtime_s in spec.runtime_choices_s
            assert e.key not in submitted
            submitted.add(e.key)
        else:
            assert e.key in submitted
    assert any(e.remote for e in evs if e.kind == "submit")


def test_cancel_removes_key_from_pool():
    evs = ArrivalStream(PoissonProcess(10.0, seed=5), TrafficSpec(**SPEC),
                        seed=5).take(2000)
    cancelled = set()
    for e in evs:
        if e.kind == "cancel":
            assert e.key not in cancelled
            cancelled.add(e.key)
    assert cancelled


def test_replay_stream_is_finite_and_faithful():
    evs = ArrivalStream(MMPPProcess(2.0, 8.0, 3.0, seed=9),
                        TrafficSpec(**SPEC), seed=9).take(64)
    assert list(ReplayStream(evs)) == evs
    rs = ReplayStream(evs)
    list(rs)
    assert list(rs) == []


def test_describe_carries_process_params():
    s = ArrivalStream(DiurnalProcess(1.0, 4.0, 60.0, seed=2),
                      TrafficSpec(**SPEC), seed=2)
    d = s.describe()
    assert d["process"] == "diurnal"
    assert d["seed"] == 2 and d["n_cqs"] == SPEC["n_cqs"]


# -- the open loop (tests/test_traffic_openloop.py on both packages) --------

def build(m, n_cqs=N_CQS):
    """The reference test's cluster (``scenarios.traffic_spec``): the JAX
    Driver on its host solver, the port's on the CPU."""
    clock = FakeClock(1000.0)
    kw = (dict(use_device_solver=False) if m.root == "kueue_tpu"
          else dict(device="cpu"))
    d = m.driver.Driver(clock=clock, **kw)
    scenarios.traffic_spec(m.types, d, n_cqs)
    return d, clock


def run(m, rate, seed=101, duration=30.0, events=None, remote_fraction=0.0):
    tr = m.traffic
    d, clock = build(m)
    s = (tr.ReplayStream(events) if events is not None else
         tr.ArrivalStream(tr.PoissonProcess(rate, seed=seed),
                          tr.TrafficSpec(**LOOP_SPEC,
                                         remote_fraction=remote_fraction),
                          seed=seed))
    client = m.remote.LocalWorkerClient(d) if remote_fraction else None
    cfg = tr.OpenLoopConfig(duration_s=duration, dt_s=1.0, slo_p99_s=8.0)
    return d, tr.run_open_loop(d, clock, s, cfg, remote_client=client)


# every field of OpenLoopResult that the event stream decides (not the
# host's wall clock)
DECIDED = ("cycles", "submitted", "admitted", "cancelled", "churned",
           "remote_submitted", "p50_latency_s", "p99_latency_s",
           "mean_latency_s", "end_depth", "max_depth", "latency_hist",
           "requeue_unparked", "requeue_storm_peak",
           "snap_cqs_recloned_per_cycle", "snap_trees_reused_per_cycle",
           "snap_full_rebuilds", "truncated", "meets_slo", "decisions")


def both(rate, **kw):
    """``run`` on both packages → (port driver, port result), after
    checking that every decided field is equal."""
    (_, j), (d, p) = (run(package(root), rate, **kw) for root in PACKAGES)
    for k in DECIDED:
        assert getattr(p, k) == getattr(j, k), k
    assert rows(p.events) == rows(j.events)
    return d, p


def test_sustainable_rate_bounded_growth():
    _, res = both(3.0)
    assert res.submitted > 40
    assert res.admitted > 0.8 * res.submitted
    assert res.max_depth < 25
    assert res.end_depth < 12
    assert res.meets_slo and res.p99_latency_s <= 8.0
    assert not res.truncated


def test_replay_is_decision_bit_identical():
    _, live = both(4.0, seed=77, duration=20.0)
    _, replay = run(PORT, 4.0, duration=20.0, events=live.events)
    assert replay.decisions == live.decisions
    assert replay.admitted == live.admitted
    assert replay.p99_latency_s == live.p99_latency_s


def test_remote_submissions_route_through_worker_client():
    """Remote-marked arrivals go through ``remote.LocalWorkerClient``
    into the same Driver and are admitted like the rest, alike in both
    packages."""
    _, res = both(3.0, seed=5, remote_fraction=0.5)
    assert res.remote_submitted > 0
    assert res.admitted > 0.7 * res.submitted
    assert res.meets_slo


def test_metrics_and_stats_surfaced():
    d, res = both(3.0, seed=9)
    gauges = d.metrics.gauges
    assert ("kueue_open_loop_queue_depth", "active") in gauges
    assert ("kueue_open_loop_admissions_per_second",) in gauges
    hist = d.metrics.histograms[
        ("kueue_open_loop_admission_latency_seconds",)]
    assert hist.n == res.admitted
    st = d.stats
    assert st["snapshot"]["snap_builds"] > 0
    assert "requeue_storm_peak" in st["queue"]
    assert res.snap_cqs_recloned_per_cycle >= 0.0
    assert res.latency_hist and all(c > 0 for _, c in res.latency_hist)


def test_past_capacity_misses_the_slo_in_both_packages():
    """At twice the quota ceiling the backlog grows and the censored p99
    breaks the SLO, alike in both packages."""
    _, res = both(16.0, seed=5, duration=20.0)
    assert not res.meets_slo and res.end_depth > 20


def test_find_sustainable_rate_bisection():
    def probe(rate):
        r = OpenLoopResult()
        r.meets_slo = rate <= 10.0
        r.p99_latency_s = rate
        return r

    best, probes = find_sustainable_rate(probe, lo=2.0, hi=20.0, iters=6)
    assert len(probes) == 6
    assert all(p.rate_per_s > 0 for p in probes)
    assert 9.5 < best <= 10.0


def test_bisection_over_real_runs_in_both_packages():
    """``find_sustainable_rate`` over fresh runs at 8 CQs: the same
    probes, rates and verdicts in both packages."""
    out = []
    for root in PACKAGES:
        m = package(root)
        best, probes = m.traffic.find_sustainable_rate(
            lambda rate, m=m: run(m, rate, seed=scenarios.rate_seed(
                1109, rate), duration=15.0)[1], 2.0, 24.0, iters=3)
        out.append((best, [(p.rate_per_s, p.meets_slo, p.p99_latency_s,
                            p.decisions) for p in probes]))
    assert out[0] == out[1]
    assert 2.0 < out[1][0] < 24.0


# -- chip_smoke.py phase 19, small ------------------------------------------

def test_traffic_probe_matches_the_jax_package():
    """``scenarios.traffic_probe`` (traffic_soak.py's cluster, marks and
    seeding, the port's Driver on the CPU with its device solver) at 16
    CQs and half the capacity estimate: the JAX package's runner on its
    own Driver (device solver) over the same cluster and stream decides
    the same; a replay of the consumed events on a fresh port driver is
    bit-identical."""
    n = 16
    rate = round(scenarios.traffic_capacity(n) * 0.5, 1)
    seed = scenarios.rate_seed(1109, rate)
    port, _ = scenarios.traffic_probe(n, rate, seed=seed, device="cpu",
                                      duration_s=15.0)
    scenarios.release()
    jm = package("kueue_tpu")
    clock = scenarios.VirtualClock()
    d = jm.driver.Driver(clock=clock, use_device_solver=True)
    scenarios.traffic_spec(jm.types, d, n)
    tr = jm.traffic
    ref = tr.run_open_loop(d, clock, tr.ArrivalStream(
        tr.PoissonProcess(rate, seed=seed),
        tr.TrafficSpec(**dataclasses.asdict(scenarios.traffic_marks(n))),
        seed=seed), tr.OpenLoopConfig(duration_s=15.0, dt_s=1.0,
                                      slo_p99_s=8.0))
    for k in DECIDED:
        assert getattr(port, k) == getattr(ref, k), k
    assert port.admitted > 0 and port.meets_slo
    replay, _ = scenarios.traffic_probe(n, rate, seed=seed, device="cpu",
                                        events=port.events, duration_s=15.0)
    scenarios.release()
    assert replay.decisions == port.decisions
    assert scenarios.traffic_capacity(1000) == pytest.approx(666.6667, 1e-4)
