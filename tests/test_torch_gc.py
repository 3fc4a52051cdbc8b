"""The port's drain twins collect as the reference scripts do
(kueue_tpu_torch.scenarios): a build ends with ``gc.collect();
gc.freeze()`` (scripts/northstar_e2e.py :199-200 and :517-518, bench.py
:312-313), a drain runs with automatic collection off (:292, :592) and
turns it on again afterwards, also when it raises, and ``release()``
unfreezes and collects (bench.py :332-333).  Reduced sizes, on the CPU."""

import gc

import pytest

from kueue_tpu_torch import scenarios


@pytest.fixture
def cycles_off(monkeypatch):
    """Whether collection was on at each ``schedule_once`` /
    ``schedule_burst`` call of any Driver of the port."""
    from kueue_tpu_torch.controller.driver import Driver
    seen = []
    for name in ("schedule_once", "schedule_burst"):
        real = getattr(Driver, name)

        def wrapped(self, *a, _real=real, **kw):
            seen.append(gc.isenabled())
            return _real(self, *a, **kw)
        monkeypatch.setattr(Driver, name, wrapped)
    return seen


@pytest.fixture
def heap():
    """Collection on and nothing frozen before, released after."""
    gc.enable()
    scenarios.release()
    yield
    scenarios.release()
    gc.enable()


def test_northstar_build_freezes_and_drain_collects_nothing(heap,
                                                           cycles_off):
    d, clock, _, wave = scenarios.build_northstar(40, 200, device="cpu")
    frozen = gc.get_freeze_count()
    assert frozen > 0 and gc.isenabled()
    r = scenarios.run_northstar(d, clock, wave, cycles=6)
    assert cycles_off == [False] * 6 and gc.isenabled()
    assert r["admitted"] > 0 and r["preempted"] > 0
    del d
    scenarios.release()
    assert gc.get_freeze_count() < frozen


@pytest.mark.parametrize("kind", ["bench", "bench_burst", "fs", "burst",
                                  "tas", "sustained"])
def test_every_drain_runs_with_collection_off(kind, heap, cycles_off):
    if kind in ("bench", "bench_burst"):
        d, clock, total, waves = scenarios.build_bench(0.02, device="cpu")
        run = (scenarios.run_bench if kind == "bench"
               else scenarios.drain_bench_burst)
        call = lambda: run(d, clock, total, waves)  # noqa: E731
    elif kind == "fs":
        d, clock, _ = scenarios.build_northstar_fs(20, 200, device="cpu")
        call = lambda: scenarios.run_northstar_fs(d, clock,  # noqa: E731
                                                  cycles=4)
    elif kind == "burst":
        d, clock, _, wave = scenarios.build_northstar(20, 100,
                                                      device="cpu")
        call = lambda: scenarios.northstar_burst(d, clock,  # noqa: E731
                                                 wave, cycles=6)
    elif kind == "tas":
        with scenarios.tas_gates():
            d, clock, runtimes = scenarios.build_tas(
                device="cpu", blocks=2, subblocks=4, hosts=8, n_cqs=8,
                n_cohorts=2, per_cq=20)
        call = lambda: scenarios.run_tas(d, clock,  # noqa: E731
                                         runtimes, cycles=4)
    else:
        call = lambda: scenarios.sustained_drain(  # noqa: E731
            device="cpu", cycles=8)
    if kind != "sustained":
        assert gc.get_freeze_count() > 0
    if kind == "tas":
        with scenarios.tas_gates():
            r = call()
    else:
        r = call()
    assert cycles_off and not any(cycles_off) and gc.isenabled()
    assert r["records" if kind == "sustained" else "cycle_times"]


def test_collection_on_again_when_a_phase_raises(heap):
    d, clock, total, waves = scenarios.build_bench(0.01, device="cpu")

    def broken():
        assert not gc.isenabled()
        raise RuntimeError("a cycle failed")
    d.schedule_once = broken
    with pytest.raises(RuntimeError, match="a cycle failed"):
        scenarios.run_bench(d, clock, total, waves)
    assert gc.isenabled()


def test_collection_left_off_when_it_was_off(heap):
    gc.disable()
    assert scenarios.measured(gc.isenabled)() is False
    assert not gc.isenabled()
    gc.enable()
