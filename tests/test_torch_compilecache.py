"""The port's persisted router calibration (``kueue_tpu_torch.
compilecache`` and ``CycleSolver.warmup``) against the JAX package's
(tests/test_compilecache.py, tests/test_burst_pipeline.py:342): the
sidecar round trip, a second solver loading the table and admitting on
it, stale and foreign sidecars rejected and rewritten, a loaded table
still launching every rung, and ``KUEUE_TPU_COMPILE_CACHE``."""

from __future__ import annotations

import importlib
import json
import os

import pytest
import torch

from kueue_tpu_torch import compilecache
from kueue_tpu_torch.ops import solver as solver_mod

torch.set_num_threads(1)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_COMPILE_CACHE", str(tmp_path))
    monkeypatch.setattr(compilecache, "_enabled_dir", None)
    return tmp_path


def _build(pkg="kueue_tpu_torch"):
    """One CQ, one pending workload (tests/test_compilecache.py)."""
    t = importlib.import_module(f"{pkg}.api.types")
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    kw = {} if pkg == "kueue_tpu" else {"device": "cpu"}
    d = Driver(clock=lambda: 1000.0, use_device_solver=True, **kw)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", cohort="co",
        resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="default", resources={
                "cpu": t.ResourceQuota(nominal=4000)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    d.create_workload(t.Workload(
        name="w", queue_name="lq",
        pod_sets=[t.PodSet(name="main", count=1, requests={"cpu": 1000})]))
    return d


def _sidecars(path):
    return [f for f in os.listdir(path) if f.startswith("calibration-")]


def test_sidecar_json_round_trip(tmp_path):
    d = str(tmp_path)
    obj = {"calibration": [[["cpu", "flat", 8, 8], 0.001]]}
    assert compilecache.save_json("t.json", obj, cache_dir=d)
    assert compilecache.load_json("t.json", cache_dir=d) == obj
    assert compilecache.load_json("missing.json", cache_dir=d) is None
    # the write is a rename: no temporary file stays behind
    assert sorted(os.listdir(d)) == ["t.json"]


def test_warmup_reloads_persisted_calibration(cache):
    """A second solver with the same fingerprint loads the persisted
    router table, skips the measurement, and routes a real cycle."""
    d1 = _build()
    d1.scheduler.solver.warmup(d1.cache.snapshot(), 8)
    assert d1.scheduler.solver.stats["calibration_loaded"] == 0
    assert d1.scheduler.solver.calibration
    assert _sidecars(cache), "warmup must persist the router table"

    d2 = _build()
    d2.scheduler.solver.warmup(d2.cache.snapshot(), 8)
    assert d2.scheduler.solver.stats["calibration_loaded"] == 1
    assert d2.scheduler.solver.calibration == d1.scheduler.solver.calibration
    s = d2.schedule_once()
    assert s.admitted == ["default/w"]


def test_both_packages_calibrate_the_same_buckets(cache, monkeypatch):
    """On the CPU both packages' tables hold the same keys: the device
    ("cpu": XLA on one side, the plain versions on the other) and the
    native loop, for the same kinds and buckets."""
    from kueue_tpu import compilecache as jax_cache
    # the JAX package's sidecars beside the port's, its XLA cache
    # settings untouched
    monkeypatch.setattr(jax_cache, "_enabled_dir", str(cache))
    keys = {}
    for pkg in ("kueue_tpu", "kueue_tpu_torch"):
        d = _build(pkg)
        d.scheduler.solver.warmup(d.cache.snapshot(), 8)
        keys[pkg] = {tuple(k) for k in d.scheduler.solver.calibration}
    assert keys["kueue_tpu"] == keys["kueue_tpu_torch"]
    assert {k[0] for k in keys["kueue_tpu_torch"]} == {"cpu", "native"}


def test_calibration_sidecar_schema_and_eager_walk(cache, monkeypatch):
    """The sidecar carries a schema; a stale one is rejected (measured
    and written again), a valid one still runs the launch walk after
    loading, and one of another fingerprint is rejected too."""
    launched = []
    real = solver_mod.admit_scan_preempt

    def counting(*a, **kw):
        launched.append(a[-1].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(solver_mod, "admit_scan_preempt", counting)

    def warm():
        d = _build()
        s = d.scheduler.solver
        s.warmup(d.cache.snapshot(), 2)
        return s

    s1 = warm()                      # cold: measures, writes the sidecar
    files = _sidecars(cache)
    assert len(files) == 1
    path = cache / files[0]
    data = json.loads(path.read_text())
    assert data["schema"] == solver_mod.CALIB_SCHEMA
    assert data["fingerprint"]
    assert s1.stats["calibration_loaded"] == 0
    cold = len(launched)
    assert cold > 0

    data["schema"] = -1              # a stale build's sidecar
    path.write_text(json.dumps(data))
    s2 = warm()
    assert s2.stats["calibration_rejected"] == 1
    assert s2.stats["calibration_loaded"] == 0
    assert json.loads(path.read_text())["schema"] == solver_mod.CALIB_SCHEMA

    launched.clear()
    s3 = warm()                      # valid: loads, still launches
    assert s3.stats["calibration_loaded"] == 1
    assert s3.stats["calibration_rejected"] == 0
    assert set(s3.calibration) == set(s2.calibration)
    # every preempt rung once, where measuring ran the timed one 2 times
    assert 0 < len(launched) < cold

    data = json.loads(path.read_text())
    data["fingerprint"] = "someone else's machine"
    path.write_text(json.dumps(data))
    s4 = warm()
    assert s4.stats["calibration_rejected"] == 1
    assert json.loads(path.read_text())["fingerprint"] != data["fingerprint"]


def test_fingerprint_names_what_was_measured(cache):
    """The fingerprint carries the torch build, the device, the kernel
    sources and the backend: a sidecar of "accel" is not "auto"'s."""
    from kueue_tpu_torch import kernels
    d = _build()
    s = d.scheduler.solver
    fp = s._fingerprint(s._structure_for(d.cache.snapshot(), []), 8)
    assert torch.__version__ in fp
    assert kernels.source_digest() in fp
    assert "'auto'" in fp
    s.warmup(d.cache.snapshot(), 8)
    accel = solver_mod.CycleSolver(device="cpu", backend="accel")
    accel.warmup(d.cache.snapshot(), 8)
    assert accel.stats["calibration_loaded"] == 0
    assert len(_sidecars(cache)) == 2


def test_compile_cache_zero_disables(tmp_path, monkeypatch):
    monkeypatch.setenv("KUEUE_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(compilecache, "_enabled_dir", None)
    assert compilecache.enable() is None
    assert compilecache.enable(str(tmp_path)) is None
    assert not compilecache.save_json("t.json", {"a": 1})
    assert compilecache.load_json("t.json") is None
    d1 = _build()
    d1.scheduler.solver.warmup(d1.cache.snapshot(), 8)
    assert d1.scheduler.solver.calibration      # measured, not persisted
    d2 = _build()
    d2.scheduler.solver.warmup(d2.cache.snapshot(), 8)
    assert d2.scheduler.solver.stats["calibration_loaded"] == 0
    assert os.listdir(tmp_path) == []


def test_compile_cache_default_and_override(tmp_path, monkeypatch):
    """Empty means ~/.cache/kueue_tpu_torch (not the JAX package's
    ~/.cache/kueue_tpu/xla); a path overrides it; the first answer is
    kept for the process."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("KUEUE_TPU_COMPILE_CACHE", "")
    monkeypatch.setattr(compilecache, "_enabled_dir", None)
    want = os.path.join(str(tmp_path), ".cache", "kueue_tpu_torch")
    assert compilecache.enable() == want
    assert os.path.isdir(want)
    monkeypatch.setenv("KUEUE_TPU_COMPILE_CACHE", str(tmp_path / "other"))
    assert compilecache.enable() == want          # memoized
    monkeypatch.setattr(compilecache, "_enabled_dir", None)
    assert compilecache.enable() == str(tmp_path / "other")
