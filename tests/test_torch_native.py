"""The port's native (C++) route: ``kueue_tpu_torch.native`` against the
JAX package's ``kueue_tpu.native`` and against the port's own
``solve_cycle``/``admit_scan_plain``, and ``Driver(device="cpu",
solver_backend="native")`` against the JAX Driver with
``solver_backend="native"`` on seeded scenarios (identical events and
per-cycle decisions).  Skips only where g++ is absent, as
tests/test_native_core.py does."""

import importlib
import random

import numpy as np
import pytest
import torch

from kueue_tpu import native as jnative
from kueue_tpu_torch import native, scenarios
from kueue_tpu_torch.ops import cycle as tc
from kueue_tpu_torch.parallel import cycle_args

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no g++ to build the cycle core")

torch.set_num_threads(1)


def _packed(**kw):
    _, _, _, packed = scenarios.packed_cycle(device="cpu", **kw)
    return packed


@pytest.mark.parametrize("kw", [{}, dict(contended=True),
                                dict(contended=True, preemption=True)],
                         ids=["plain", "contended", "preemption"])
def test_native_classify_matches_jax_and_solve_cycle(kw):
    import __graft_entry__ as ge
    packed = _packed(**kw)
    nat = native.classify_cycle(packed)
    _, _, _, jpacked = ge._packed_cycle(**kw)
    ref = jnative.classify_cycle(jpacked)
    out = tc.solve_cycle(*cycle_args(packed, device="cpu"),
                         depth=packed.depth, run_scan=False)
    solve = (out[4].numpy(), out[5].numpy(), out[3].numpy())
    for a, b, c in zip(nat, ref, solve):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert (nat[0] >= 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_admit_scan_matches_plain(seed):
    from kueue_tpu_torch import testing
    c = testing.admit_cycle(np.random.default_rng(seed), n_cqs=8,
                            n_cohorts=3, depth=3, F=3, W=48, R=2,
                            n_valid=40)
    args = testing.admit_args(c)
    plain = tc.admit_scan_plain(*[torch.from_numpy(a) for a in args],
                                depth=c["depth"])
    nat = native.admit_scan_raw(*args)
    assert nat.dtype == np.bool_
    np.testing.assert_array_equal(nat, plain.numpy())
    assert plain.any() and not plain[:40].all()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _scenario(pkg, seed, n_cohorts=2, cqs_per_cohort=3, n_wl=60,
              preemption=False):
    """tests/test_device_cycle.py build_driver, for either package, with
    the native backend."""
    t = importlib.import_module(f"{pkg}.api.types")
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    clock = _Clock()
    if pkg == "kueue_tpu":
        d = Driver(clock=clock, use_device_solver=True,
                   solver_backend="native")
    else:
        d = Driver(clock=clock, device="cpu", solver_backend="native")
    rng = random.Random(seed)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    pre = (t.PreemptionPolicy(
        reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
        within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY)
        if preemption else t.PreemptionPolicy())
    for c in range(n_cohorts):
        for q in range(cqs_per_cohort):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(t.ClusterQueue(
                name=name, cohort=f"cohort-{c}", preemption=pre,
                resource_groups=[t.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[t.FlavorQuotas(name="default", resources={
                        "cpu": t.ResourceQuota(nominal=4000,
                                               borrowing_limit=8000)})])]))
            d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                             cluster_queue=name))
    for i in range(n_wl):
        c = rng.randrange(n_cohorts)
        q = rng.randrange(cqs_per_cohort)
        d.create_workload(t.Workload(
            name=f"wl-{i}", queue_name=f"lq-{c}-{q}",
            priority=rng.choice([10, 10, 50, 100]),
            creation_time=float(i + 1),
            pod_sets=[t.PodSet(name="main", count=1, requests={
                "cpu": rng.choice([1000, 2000, 4000])})]))
    return d, clock, t


def _drive(d, clock, t, n_cycles=40, runtime=4, wave_at=None):
    """Cycles with fake execution; at ``wave_at`` a high-priority wave
    that must preempt."""
    log, running = [], []
    for cycle in range(n_cycles):
        clock.t += 1.0
        if cycle == wave_at:
            for i in range(6):
                d.create_workload(t.Workload(
                    name=f"boss-{i}", queue_name=f"lq-{i % 2}-0",
                    priority=1000, creation_time=clock.t,
                    pod_sets=[t.PodSet(name="main", count=1,
                                       requests={"cpu": 6000})]))
        stats = d.schedule_once()
        log.append((sorted(stats.admitted), sorted(stats.skipped),
                    sorted(stats.preempted_targets)))
        running += [(cycle + runtime, k) for k in stats.admitted]
        still = []
        for fin, key in running:
            wl = d.workload(key)
            if wl is None or not wl.has_quota_reservation:
                continue
            if fin <= cycle:
                d.finish_workload(key)
            else:
                still.append((fin, key))
        running = still
    return log


@pytest.mark.parametrize("seed,preemption", [(31, False), (32, False),
                                             (33, True)])
def test_native_driver_matches_jax_native_driver(seed, preemption):
    runs = {}
    for pkg in ("kueue_tpu", "kueue_tpu_torch"):
        d, clock, t = _scenario(pkg, seed, preemption=preemption)
        runs[pkg] = (_drive(d, clock, t, wave_at=3 if preemption else None),
                     d.events, d.scheduler.solver.stats)
    (jlog, jev, _), (tlog, tev, stats) = runs.values()
    assert tlog == jlog
    assert tev == jev
    assert stats["native_dispatches"] > 0, stats
    assert stats["host_cycles"] == 0, stats
    if preemption:
        assert any(targets for _, _, targets in tlog)


def test_driver_backend_values():
    from kueue_tpu_torch.controller.driver import Driver
    assert Driver(device="cpu").scheduler.solver.backend == "auto"
    for name, backend in (("accel", "accel"), ("cpu", "accel"),
                          ("native", "native")):
        assert Driver(device="cpu", solver_backend=name).scheduler.solver \
            .backend == backend
    for bad in ("cuda", "device"):
        with pytest.raises(ValueError, match="solver_backend"):
            Driver(device="cpu", solver_backend=bad)


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "libbad.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        native.classify_cycle(_packed())
    assert not (tmp_path / "libbad.so").exists()
