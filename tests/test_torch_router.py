"""The port's calibrated dispatch router (``ops.solver.choose_route``,
``fastest_route``, ``CycleSolver.warmup``) against the JAX solver's
(kueue_tpu/ops/solver.py ``_route_device`` / ``dispatch``), on the CPU:
a table that favours the C++ loop routes every flat and forest cycle
there and the flipped table none, warm-up records a native entry beside
each device entry, both packages given one hand-set table route the same
cycles the same way, and every route decides as the JAX Driver does
(tests/test_native_core.py :111 and :145).  On a card "auto" stays on
the card whatever the table says (the route function, with a card's
device type)."""

import importlib
import random

import pytest
import torch

from kueue_tpu_torch import compilecache, native
from kueue_tpu_torch.ops.solver import (CycleSolver, choose_route,
                                        fastest_route, resolve_backend)

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="no g++ to build the cycle core")

KINDS = ("flat", "forest", "preempt", "fs")


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Each test's sidecars in its own directory."""
    monkeypatch.setenv("KUEUE_TPU_COMPILE_CACHE", str(tmp_path))
    monkeypatch.setattr(compilecache, "_enabled_dir", None)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _scenario(pkg, seed, backend="auto", use_device=True, n_cohorts=4,
              cqs_per_cohort=5, n_wl=160, preemption=False):
    """tests/test_device_cycle.py build_driver for either package (the
    port's Driver on the CPU) on a wider cluster, so that cycles fall in
    several head-count buckets."""
    t = importlib.import_module(f"{pkg}.api.types")
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    clock = _Clock()
    kw = {} if pkg == "kueue_tpu" else {"device": "cpu"}
    d = Driver(clock=clock, use_device_solver=use_device,
               solver_backend=backend, **kw)
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


def _drive(d, clock, t, n_cycles=30, runtime=3, wave_at=None):
    """Cycles with fake execution; at ``wave_at`` a high-priority wave
    that must preempt.  Returns each cycle's decisions."""
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


def _table(native_s, device_s, route="cpu"):
    """Every flat and forest bucket of a run this size, the native loop
    at ``native_s`` and the device's kernel at ``device_s``."""
    table = {}
    for W in (8, 16, 32, 64, 128, 256):
        table[(route, "flat", W, W)] = device_s(W)
        table[("native", "flat", W, W)] = native_s(W)
        for mfw in (4, 8, 16, 32):
            table[(route, "forest", W, mfw)] = device_s(W)
            table[("native", "forest", W, mfw)] = native_s(W)
    return table


# -- the pure route function ------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["auto", "accel", "native"])
def test_route_on_a_card_is_never_the_plain_versions(kind, backend):
    """On a card-typed device no table makes the router pick the plain
    versions or, under "auto", the native loop: an uncalibrated and a
    calibrated bucket alike run on the card."""
    assert choose_route({}, "cuda", backend, kind, 64, None) == (
        "native" if backend == "native" and kind in ("flat", "forest")
        else "cuda")
    for cpu_s, cuda_s, nat_s in ((1e-6, 1e-3, 1e-2), (1e-6, 1e-2, 1e-3),
                                 (1e-2, 1e-3, 1e-6)):
        table = {}
        for W in (8, 64, 1024):
            for mfw in (None, 4, 8):
                key_len = mfw or W
                table[("cpu", kind, W, key_len)] = cpu_s
                table[("cuda", kind, W, key_len)] = cuda_s
                table[("native", kind, W, key_len)] = nat_s
        for W in (8, 64, 1024, 4096):
            for mfw in (None, 4, 8, 64):
                route = choose_route(table, "cuda", backend, kind, W, mfw)
                assert route == (
                    "native" if backend == "native"
                    and kind in ("flat", "forest") else "cuda"), (
                    table, W, mfw)


@pytest.mark.parametrize("dev", ["cpu", "cuda"])
def test_route_picks_the_fastest_measured_route(dev):
    """``fastest_route`` names each bucket's measured winner on either
    device; a CPU solver's "auto" routes by it, a card's stays on the
    card."""
    table = {(dev, "flat", 8, 8): 2e-4, ("native", "flat", 8, 8): 1e-4,
             (dev, "flat", 16, 16): 1e-4, ("native", "flat", 16, 16): 2e-4,
             ("native", "flat", 32, 32): 5e-4}
    want = {8: "native", 16: dev, 32: "native"}
    # a native entry alone wins its bucket (W = 32); no entry: the device
    for W, fastest in want.items():
        assert fastest_route(table, dev, "flat", W, None) == fastest
        assert choose_route(table, dev, "auto", "flat", W, None) == (
            fastest if dev == "cpu" else "cuda")
    assert fastest_route(table, dev, "flat", 64, None) == dev
    # a tie goes to the device
    table[(dev, "flat", 8, 8)] = 1e-4
    assert fastest_route(table, dev, "flat", 8, None) == dev
    assert choose_route(table, dev, "auto", "flat", 8, None) == dev
    # preempt scans stay on the device
    table[("native", "preempt", 8, 8)] = 1e-9
    assert choose_route(table, dev, "auto", "preempt", 8, None) == dev


def test_forest_bucket_past_the_ladder_takes_the_slowest_entry():
    """A forest bucket past the warm-up's ladder reads the largest time
    recorded for the route's forest scans at that W (as the JAX
    dispatch's lookup), each route separately."""
    table = {("cpu", "forest", 64, 4): 1e-4, ("cpu", "forest", 64, 8): 4e-4,
             ("native", "forest", 64, 4): 3e-4,
             ("native", "forest", 64, 8): 3e-4}
    assert choose_route(table, "cpu", "auto", "forest", 64, 4) == "cpu"
    assert choose_route(table, "cpu", "auto", "forest", 64, 8) == "native"
    assert choose_route(table, "cpu", "auto", "forest", 64, 32) == "native"
    table[("cpu", "forest", 64, 8)] = 2e-4
    assert choose_route(table, "cpu", "auto", "forest", 64, 32) == "cpu"
    # no entry at that W: the device
    assert choose_route(table, "cpu", "auto", "forest", 128, 32) == "cpu"


def test_forced_backends_route_every_kind():
    table = {(r, k, 8, 8): t for r, t in (("cpu", 1e-3), ("cuda", 1e-3),
                                          ("native", 1e-6)) for k in KINDS}
    for kind in KINDS:
        assert choose_route(table, "cuda", "accel", kind, 8, None) == "cuda"
        assert choose_route(table, "cpu", "accel", kind, 8, None) == "cpu"
    # the device's name is "accel"; "cpu" on a card names no backend
    for name in ("cuda", "cuda:0"):
        assert resolve_backend(name, torch.device("cuda", 0)) == "accel"
    assert resolve_backend("cpu", torch.device("cpu")) == "accel"
    with pytest.raises(ValueError, match="backend"):
        resolve_backend("cpu", torch.device("cuda", 0))


def test_unknown_backend_names_raise():
    from kueue_tpu_torch.controller.driver import Driver
    for bad in ("bogus", "device", "tpu", "cuda"):
        with pytest.raises(ValueError, match="backend"):
            CycleSolver(device="cpu", backend=bad)
        with pytest.raises(ValueError, match="solver_backend"):
            Driver(device="cpu", solver_backend=bad)
    assert CycleSolver(device="cpu").backend == "auto"
    for name in CycleSolver.BACKENDS:
        assert CycleSolver(device="cpu", backend=name).backend == name
    assert CycleSolver(device="cpu", backend="cpu").backend == "accel"


# -- warm-up -----------------------------------------------------------------

@needs_native
def test_warmup_records_native_calibration():
    """warmup() itself writes the ("native", ...) entries the router
    compares, each beside the device's ("cpu" here) entry for the same
    bucket, with no failure counted."""
    d, _, _ = _scenario("kueue_tpu_torch", 34)
    s = d.scheduler.solver
    s.warmup(d.cache.snapshot(), 16)
    assert s.stats["native_calibration_failures"] == 0, s.stats
    assert s.rtt_s is None            # no card: no round trip
    native_keys = [k for k in s.calibration if k[0] == "native"]
    assert native_keys, sorted(s.calibration)
    for k in native_keys:
        assert ("cpu",) + k[1:] in s.calibration, k
    assert {k[1] for k in s.calibration} == {"flat", "preempt"}
    assert {k[2] for k in s.calibration} == {8, 16}


@needs_native
def test_warmup_measures_only_the_forced_route():
    """"accel" measures the device's kernels and not the native loop, as
    the JAX warm-up does for "accel"; "native" leaves its loop untimed."""
    for backend in ("accel", "native"):
        d, _, _ = _scenario("kueue_tpu_torch", 34, backend=backend)
        s = d.scheduler.solver
        s.warmup(d.cache.snapshot(), 16)
        assert s.calibration and {k[0] for k in s.calibration} == {"cpu"}


def test_a_sample_is_the_median_of_its_reps(monkeypatch):
    """One slow repetition cannot decide a bucket: the sample is the
    median wall of the reps, not the last one (the JAX warm-up's)."""
    from kueue_tpu_torch.ops import solver as solver_mod
    ticks = iter([0.0, 1.0, 1.0, 101.0, 101.0, 103.0])   # walls 1, 100, 2
    monkeypatch.setattr(solver_mod.time, "perf_counter",
                        lambda: next(ticks))
    calls = []
    assert solver_mod._median_wall(lambda: calls.append(1), 3) == 2.0
    assert len(calls) == 3


@needs_native
def test_a_failing_native_loop_is_counted(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("no core")
    monkeypatch.setattr(native, "admit_scan_raw", broken)
    d, _, _ = _scenario("kueue_tpu_torch", 34)
    s = d.scheduler.solver
    s.warmup(d.cache.snapshot(), 16)
    assert s.stats["native_calibration_failures"] == 2     # W = 8, 16
    assert not [k for k in s.calibration if k[0] == "native"]


# -- routing a drain -----------------------------------------------------------

@needs_native
def test_auto_routing_prefers_calibrated_native():
    """A table that measured the native loop fastest sends every flat and
    forest cycle there, with the host Driver's decisions; the flipped
    table sends none there."""
    host, hclock, ht = _scenario("kueue_tpu_torch", 33, use_device=False)
    auto, aclock, at = _scenario("kueue_tpu_torch", 33)
    s = auto.scheduler.solver
    s.calibration.update(_table(lambda W: 1e-5, lambda W: 1e-3))
    hlog = _drive(host, hclock, ht)
    alog = _drive(auto, aclock, at)
    assert alog == hlog
    assert auto.events == host.events
    assert s.stats["native_dispatches"] > 0, s.stats
    assert s.stats["cpu_dispatches"] == 0, s.stats

    flip, fclock, ft = _scenario("kueue_tpu_torch", 33)
    s2 = flip.scheduler.solver
    s2.calibration.update(_table(lambda W: 1e-3, lambda W: 1e-5))
    assert _drive(flip, fclock, ft) == hlog
    assert flip.events == host.events
    assert s2.stats["native_dispatches"] == 0, s2.stats
    assert s2.stats["cpu_dispatches"] > 0, s2.stats


@needs_native
def test_both_packages_route_a_hand_set_table_alike():
    """The JAX solver on a CPU-only JAX and the port's on the CPU, given
    one table (native faster at W = 8 and 32, the device at 16 and past
    it), route the same cycles to the same place and decide alike."""
    runs = {}
    for pkg in ("kueue_tpu", "kueue_tpu_torch"):
        d, clock, t = _scenario(pkg, 35, n_cohorts=6, n_wl=240)
        d.scheduler.solver.calibration.update(_table(
            lambda W: 1e-5 if W in (8, 32) else 1e-3, lambda W: 1e-4))
        runs[pkg] = (_drive(d, clock, t), d.events,
                     dict(d.scheduler.solver.stats))
    (jlog, jev, js), (tlog, tev, ts) = runs.values()
    assert tlog == jlog
    assert tev == jev
    for k in ("native_dispatches", "cpu_dispatches", "skipped_dispatches",
              "singleton_dispatches", "full_cycles"):
        assert ts[k] == js[k], (k, ts, js)
    assert ts["native_dispatches"] > 0 and ts["cpu_dispatches"] > 0, ts


@needs_native
@pytest.mark.parametrize("backend", ["auto", "accel", "cpu", "native"])
@pytest.mark.parametrize("seed,preemption", [(41, False), (42, True)])
def test_every_route_decides_as_the_jax_driver(backend, seed, preemption):
    """Calibrated "auto" (warm-up's own table), "accel", "cpu" and
    "native" give the JAX Driver's events on the seeded scenarios (the
    JAX Driver on its device solver, forced to XLA-CPU, whose cycle
    order of Preempted events the port's solver keeps)."""
    wave = 3 if preemption else None
    j, jclock, jt = _scenario("kueue_tpu", seed, backend="cpu",
                              preemption=preemption)
    jlog = _drive(j, jclock, jt, wave_at=wave)
    d, clock, t = _scenario("kueue_tpu_torch", seed, backend=backend,
                            preemption=preemption)
    s = d.scheduler.solver
    if backend == "auto":
        s.warmup(d.cache.snapshot(), 32)
        assert [k for k in s.calibration if k[0] == "native"]
    assert _drive(d, clock, t, wave_at=wave) == jlog
    assert d.events == j.events
    assert s.stats["host_cycles"] == 0, s.stats
    routed = {r: s.stats[f"{r}_dispatches"] for r in ("cpu", "native")}
    assert sum(routed.values()) > 0, s.stats
    if backend in ("accel", "cpu"):
        assert routed["native"] == 0, s.stats
    if preemption:
        assert any(targets for _, _, targets in jlog)
