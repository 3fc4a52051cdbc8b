"""Decision parity of the per-cycle mesh route: the same scenarios through
the port's ``Driver(device="cpu")`` with ``set_mesh`` on its virtual CPU
mesh (``virtual_mesh("cpu", 8)``, set for every test of this file) and
through the JAX package's Driver must give the same ``Driver.events`` and
the same per-cycle admitted / preempted / skipped / inadmissible sets:

- tests/test_sharded_production.py (flat and preempt scans; the hybrid
  layout with 13 quota nodes on cq = 2);
- three fair-sharing rows of tests/test_conformance_fair_preemption.py
  :600-640 in "sharded" mode, and a fair-sharing drain whose cycles run
  ``fs_admit_scan`` through the mesh;
- ``KUEUE_TPU_SHARDS=8`` through the Driver's constructor;
- ``scenarios.dryrun_multichip(8)`` and the drains ``chip_smoke.py``
  runs through the mesh (``shards=``), small, against their serial
  digests.

In process the JAX side runs its serial solver, which its own tests hold
to its mesh route; ``test_the_jax_mesh_drivers_agree`` runs every
scenario through the JAX package's mesh Driver (``set_mesh`` on the
conftest's 8 virtual XLA CPU devices) in a fresh process and requires
equal records, events and ``sharded_*`` counts.  (In one process, a JAX
``sharded_cycle_fn`` after a JAX mesh Driver deadlocks XLA:CPU and
aborts the process; tests/test_torch_mesh.py says more.)"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from kueue_tpu.parallel import sharded as jsh
from kueue_tpu_torch import scenarios
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")
STATS = ("sharded_dispatches", "sharded_preempt_dispatches",
         "sharded_fs_dispatches", "full_cycles", "fs_full_cycles",
         "classify_cycles", "host_cycles", "skipped_dispatches",
         "singleton_dispatches")


@pytest.fixture(autouse=True)
def cpu_mesh():
    with tsh.virtual_mesh("cpu", 8):
        yield


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def types_of(pkg):
    return importlib.import_module(f"{pkg}.api.types")


def make_driver(pkg, clock, mesh=None, **kw):
    """A device-solver Driver of ``pkg`` on ``mesh``: "grid"
    (make_mesh(8)), "hybrid" (make_hybrid_mesh(n_hosts=4)) or None."""
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    if pkg == "kueue_tpu":
        d = Driver(clock=clock, use_device_solver=True, **kw)
        sh = jsh
        mk = {"grid": lambda: sh.make_mesh(8),
              "hybrid": lambda: sh.make_hybrid_mesh(n_hosts=4)}
    else:
        d = Driver(clock=clock, device="cpu", **kw)
        sh = tsh
        mk = {"grid": lambda: sh.make_mesh(8, device="cpu"),
              "hybrid": lambda: sh.make_hybrid_mesh(n_hosts=4,
                                                    device="cpu")}
    if mesh is not None:
        d.scheduler.solver.set_mesh(mk[mesh]())
    return d


def production(t, d):
    """tests/test_sharded_production.py ``build``: 4 cohorts x 2 CQs
    that preempt, 40 workloads."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    pre = t.PreemptionPolicy(
        reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
        within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY)
    for c in range(4):
        for q in range(2):
            name = f"cq-{c}-{q}"
            d.apply_cluster_queue(t.ClusterQueue(
                name=name, cohort=f"co-{c}", preemption=pre,
                resource_groups=[t.ResourceGroup(
                    covered_resources=["cpu"],
                    flavors=[t.FlavorQuotas(name="default", resources={
                        "cpu": t.ResourceQuota(nominal=4000,
                                               borrowing_limit=4000)})])]))
            d.apply_local_queue(t.LocalQueue(name=f"lq-{c}-{q}",
                                             cluster_queue=name))
    n = 0
    for c in range(4):
        for q in range(2):
            for i in range(5):
                n += 1
                d.create_workload(t.Workload(
                    name=f"w-{c}-{q}-{i}", queue_name=f"lq-{c}-{q}",
                    priority=(i % 2) * 10, creation_time=float(n),
                    pod_sets=[t.PodSet(name="main", count=1,
                                       requests={"cpu": 1500})]))


def wave(t, d):
    for c in range(4):
        d.create_workload(t.Workload(
            name=f"boss-{c}", queue_name=f"lq-{c}-0", priority=100,
            creation_time=500.0 + c,
            pod_sets=[t.PodSet(name="main", count=1,
                               requests={"cpu": 4000})]))


def lone(t, d):
    """The extra lone CQ of test_mesh_pad_non_divisible_nodes_and_hybrid
    _layout: 13 quota nodes."""
    d.apply_cluster_queue(t.ClusterQueue(
        name="lone", resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="default", resources={
                "cpu": t.ResourceQuota(nominal=3000)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq-lone", cluster_queue="lone"))
    for i in range(3):
        d.create_workload(t.Workload(
            name=f"lone-{i}", queue_name="lq-lone",
            creation_time=900.0 + i,
            pod_sets=[t.PodSet(name="main", count=1,
                               requests={"cpu": 1500})]))


def record(s):
    return (list(s.admitted), sorted(s.preempted_targets), sorted(s.skipped),
            sorted(s.inadmissible))


def run_production(pkg, mesh, extra=False, cycles=6):
    t = types_of(pkg)
    clock = Clock()
    d = make_driver(pkg, clock, mesh)
    production(t, d)
    if extra:
        lone(t, d)
    log = []
    for cyc in range(cycles):
        if cyc == 2:
            wave(t, d)
        clock.t += 1.0
        log.append(record(d.schedule_once()))
    return d, log


def stats_of(d, sharded=True):
    st = d.scheduler.solver.stats
    return {k: st.get(k, 0) for k in STATS
            if sharded or not k.startswith("sharded")}


# -- fair sharing: the sharded conformance rows, a drain through the mesh -

def _reclaim_from_deeper_borrower(t, w, d):
    tt.fs_preemption_cluster(t, d)
    for n in ("a1", "a2"):
        tt.reserve(t, w, d, n, "a", 1000)
    for n in ("b1", "b2", "b3", "b4", "b5", "b6"):
        tt.reserve(t, w, d, n, "b", 1000)
    tt.reserve(t, w, d, "c1", "c", 1000)
    tt.submit(t, d, "c-incoming", "c", 1000)
    return {"b1"}


def _reclaim_two_from_sole_borrower(t, w, d):
    tt.fs_preemption_cluster(t, d)
    tt.reserve(t, w, d, "a1", "a", 1000)
    for n in ("b1", "b2", "b3", "b4", "b5", "b6"):
        tt.reserve(t, w, d, n, "b", 1000)
    for n in ("c1", "c2"):
        tt.reserve(t, w, d, n, "c", 1000)
    tt.submit(t, d, "a-incoming", "a", 2000)
    return {"b1", "b2"}


def _borrowing_preempts_two_below_threshold(t, w, d):
    tt.fs_preemption_cluster(t, d)
    for n in ("a1", "a2", "a3"):
        tt.reserve(t, w, d, n, "a", 1000)
    tt.reserve(t, w, d, "b1", "b", 1000)
    tt.reserve(t, w, d, "c1", "c", 1000)
    for n in ("p1", "p2", "p3", "p4"):
        tt.reserve(t, w, d, n, "preemptible", 1000, priority=-4)
    tt.submit(t, d, "a-incoming", "a", 2000)
    return {"p1", "p2"}


FS_ROWS = {"reclaim_from_deeper_borrower": _reclaim_from_deeper_borrower,
           "reclaim_two_from_sole_borrower": _reclaim_two_from_sole_borrower,
           "borrowing_preempts_two_below_threshold":
               _borrowing_preempts_two_below_threshold}


def run_fs_row(pkg, mesh, row):
    t = types_of(pkg)
    w = importlib.import_module(f"{pkg}.workload")
    clock = Clock()
    kw = {"solver_backend": "cpu"} if pkg == "kueue_tpu" else {}
    d = make_driver(pkg, clock, mesh, fair_sharing=True, **kw)
    want = FS_ROWS[row](t, w, d)
    clock.t += 1.0
    s = d.schedule_once()
    assert {k.split("/", 1)[1] for k in s.preempted_targets} == want
    return d, [record(s)]


def run_fs_drain(pkg, mesh):
    """The north-star fair-sharing cluster at 20 CQs (4 forests on the
    grid's 2 cq shards), 12 cycles."""
    clock = scenarios.VirtualClock()
    d = make_driver(pkg, clock, mesh, fair_sharing=True)
    scenarios.northstar_fs_spec(types_of(pkg), d, 20, 400)
    return d, scenarios.run_northstar_fs(d, clock, cycles=12)["decisions"]


def run_env(pkg, mesh=None):
    """KUEUE_TPU_SHARDS=8 read by the Driver's constructor (``mesh`` is
    unused: the switch builds it); the production scenario."""
    prev = os.environ.get("KUEUE_TPU_SHARDS")
    os.environ["KUEUE_TPU_SHARDS"] = "8"
    try:
        t = types_of(pkg)
        clock = Clock()
        d = make_driver(pkg, clock)
    finally:
        if prev is None:
            del os.environ["KUEUE_TPU_SHARDS"]
        else:
            os.environ["KUEUE_TPU_SHARDS"] = prev
    assert dict(d.scheduler.solver.mesh.shape) == {"wl": 4, "cq": 2}
    production(t, d)
    log = []
    for cyc in range(6):
        if cyc == 2:
            wave(t, d)
        clock.t += 1.0
        log.append(record(d.schedule_once()))
    return d, log


# every scenario: key → (runner(pkg, mesh), the port's mesh)
SCENARIOS = {
    "production": (lambda pkg, m: run_production(pkg, m), "grid"),
    "production_lone_cq": (lambda pkg, m: run_production(pkg, m, True),
                           "hybrid"),
    **{f"fs_row/{row}": ((lambda r: lambda pkg, m: run_fs_row(pkg, m, r))(
        row), "grid") for row in sorted(FS_ROWS)},
    "fs_drain": (run_fs_drain, "grid"),
    "env": (run_env, None),
    "env_burst": (lambda pkg, m: run_env_burst(pkg), None),
}


def run_env_burst(pkg):
    """tests/test_torch_sharded_burst.py's burst under KUEUE_TPU_SHARDS=8:
    the per-cycle mesh and the sharded burst together."""
    from test_torch_sharded_burst import env_burst
    d, recs = env_burst(pkg)
    return d, recs


def _summary(d, log):
    return json.loads(json.dumps(
        {"log": log, "events": d.events, "stats": stats_of(d)}))


def jax_mesh_driver_oracle(path) -> None:
    """Every scenario through the JAX package's mesh Driver, as JSON at
    ``path`` (run in a fresh process by
    ``test_the_jax_mesh_drivers_agree``)."""
    out = {}
    for key, (run, mesh) in SCENARIOS.items():
        out[key] = _summary(*run("kueue_tpu", mesh or "grid"))
    with open(path, "w") as fh:
        json.dump(out, fh)


def test_the_jax_mesh_drivers_agree(tmp_path):
    """The port's mesh Driver against the JAX package's mesh Driver in
    every scenario: records, events and the sharded_* counts."""
    path = tmp_path / "jax_mesh_drivers.json"
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import test_torch_mesh_driver as m; "
            f"m.jax_mesh_driver_oracle({str(path)!r})")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("KUEUE_TPU_SHARDS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path) as fh:
        want = json.load(fh)
    assert want.keys() == SCENARIOS.keys()
    for key, (run, mesh) in SCENARIOS.items():
        got = _summary(*run("kueue_tpu_torch", mesh))
        assert got == want[key], key
    assert want["production"]["stats"]["sharded_preempt_dispatches"] > 0
    assert want["fs_drain"]["stats"]["sharded_fs_dispatches"] > 0


def assert_same(jrun, trun):
    """The JAX serial run and the port's mesh run decide alike."""
    (jd, jlog), (td, tlog) = jrun, trun
    assert len(jlog) == len(tlog)
    for k, (a, b) in enumerate(zip(jlog, tlog)):
        assert a == b, (k, a, b)
    assert jd.events == td.events
    assert stats_of(jd, False) == stats_of(td, False)


@pytest.mark.parametrize("extra", [False, True], ids=["flat", "lone_cq"])
def test_mesh_routed_production_cycles_match_jax(extra):
    """The port on its mesh (the 13-node case on the hybrid layout, cq =
    2) against the JAX Driver, and equal to the port's serial solver."""
    mesh = "hybrid" if extra else "grid"
    trun = run_production("kueue_tpu_torch", mesh, extra)
    assert_same(run_production("kueue_tpu", None, extra), trun)
    td = trun[0]
    st = td.scheduler.solver.stats
    assert st["sharded_dispatches"] > 0, st
    if not extra:
        assert st["sharded_preempt_dispatches"] > 0, st
    assert td.scheduler.solver.mesh.shape == {"wl": 4, "cq": 2}
    sd, slog = run_production("kueue_tpu_torch", None, extra)
    assert slog == trun[1]
    assert sd.events == td.events


@pytest.mark.parametrize("row", sorted(FS_ROWS))
def test_sharded_fair_preemption_rows_match_jax(row):
    assert_same(run_fs_row("kueue_tpu", None, row),
                run_fs_row("kueue_tpu_torch", "grid", row))


def test_fair_sharing_drain_through_the_mesh_matches_jax():
    """fs_admit_scan per shard and the merged round order decide as the
    JAX package's single-device scan."""
    trun = run_fs_drain("kueue_tpu_torch", "grid")
    assert_same(run_fs_drain("kueue_tpu", None), trun)
    st = trun[0].scheduler.solver.stats
    assert st["sharded_fs_dispatches"] > 0 and st["fs_full_cycles"] > 0, st


def test_env_shards_sets_the_mesh(monkeypatch):
    """KUEUE_TPU_SHARDS=8: both Drivers build make_mesh(8) in their
    constructor; the port routes its cycles through it."""
    monkeypatch.setenv("KUEUE_TPU_SHARDS", "8")
    Driver = importlib.import_module("kueue_tpu.controller.driver").Driver
    jd = Driver(clock=Clock(), use_device_solver=True)
    assert dict(jd.scheduler.solver.mesh.shape) == {"wl": 4, "cq": 2}
    monkeypatch.delenv("KUEUE_TPU_SHARDS")
    trun = run_env("kueue_tpu_torch")
    assert_same(run_production("kueue_tpu", None), trun)
    assert stats_of(trun[0])["sharded_dispatches"] > 0


def test_dryrun_multichip_on_the_cpu_mesh(capsys):
    """scenarios.dryrun_multichip(8): every check of the reference's
    __graft_entry__.dryrun_multichip on the virtual CPU mesh."""
    r = scenarios.dryrun_multichip(8, device="cpu")
    assert r["mesh"] == {"wl": 4, "cq": 2}
    assert r["heads"] >= 64 and r["exact_match"] > 0
    assert min(r["skipped"], r["borrowing"], r["flavor_fallback"]) > 0
    assert r["sharded_dispatches"] > 0 and r["sharded_preempt_dispatches"] > 0
    assert r["preemptions"] > 0 and r["hybrid_dcn_cycles"] == 3
    assert "dryrun_multichip ok" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["bench", "northstar", "northstar_fs"])
def test_mesh_drains_equal_serial(name):
    """The drains chip_smoke.py runs through the mesh (phases 16-16c), at
    a small size: the digest of the serial drain, through the sharded
    routes."""
    digests, stats = {}, {}
    for shards in (0, 4):
        if name == "bench":
            d, clock, total, waves = scenarios.build_bench(
                0.02, device="cpu", shards=shards)
            r = scenarios.run_bench(d, clock, total, waves)
        elif name == "northstar":
            d, clock, total, wave = scenarios.build_northstar(
                40, 800, device="cpu", shards=shards)
            r = scenarios.run_northstar(d, clock, wave, cycles=9)
        else:
            d, clock, total = scenarios.build_northstar_fs(
                40, 800, device="cpu", shards=shards)
            r = scenarios.run_northstar_fs(d, clock, cycles=9)
        digests[shards] = scenarios.decision_digest(d, r["decisions"])
        stats[shards] = d.scheduler.solver.stats
    assert digests[0] == digests[4]
    st = stats[4]
    key = "sharded_fs_dispatches" if name == "northstar_fs" else \
        "sharded_dispatches"
    assert st[key] > 0, st
    if name != "northstar_fs":
        assert st["sharded_preempt_dispatches"] > 0, st
