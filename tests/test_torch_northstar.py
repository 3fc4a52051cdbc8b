"""The port's north-star twin (``python -m kueue_tpu_torch.northstar``)
against the JAX package's ``scripts/northstar_e2e.py`` on the CPU, at
the ``--quick`` size (12 CQs, 240 workloads, 12 cycles, 1 trial):

- the mixed fleet (4 flavors x 3 resources, the fungibility matrix) and
  smaller fleets: the per-cycle device arm, the host walk and the fused
  burst give the script's per-cycle decisions and counters;
- the fill-then-trickle phase's pack counters, delta and full pack;
- the ``--ab-hetero`` tail passes ``validate_artifacts.validate``;
- ``--crossover``, ``--ab-pipeline`` and ``--fair-sharing`` give the
  script's tail keys and stable decisions;
- without a GPU and without ``--torch-device cpu`` the twin raises.

Tolerance 0: everything compared is an integer, a key or a record.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from kueue_tpu_torch import compilecache
from kueue_tpu_torch import northstar as tns
from kueue_tpu_torch import scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = ["--quick"]
COUNTS = ("admitted", "preempted", "skipped", "workloads", "cycles_run")
FALLBACKS = ("resume_heads", "walk_stop_heads", "scalar_heads",
             "host_cycles")
TRICKLE = ("burst_packs", "burst_full_packs", "burst_delta_packs",
           "rows_reused", "rows_repacked", "admitted", "rounds")


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """scripts/northstar_e2e.py as a module (nothing in scripts/ runs
    differently for it)."""
    return _load("northstar_e2e_under_test", "scripts/northstar_e2e.py")


@pytest.fixture(autouse=True)
def env(monkeypatch, tmp_path):
    """Both scripts write KUEUE_BURST_DELTA_PACK; the test restores it,
    and KUEUE_TPU_SHARDS stays unset.  The twin's warm-ups keep their
    router sidecars in the test's own directory, so that no run loads a
    table an earlier one left."""
    monkeypatch.setenv("KUEUE_BURST_DELTA_PACK", "1")
    monkeypatch.delenv("KUEUE_TPU_SHARDS", raising=False)
    monkeypatch.setattr(compilecache, "_enabled_dir", str(tmp_path))


def _json(x):
    return json.loads(json.dumps(x))


@contextlib.contextmanager
def recorded(ref):
    """The script's Drivers record each applied cycle's
    ``scenarios.cycle_record`` (the per-cycle path and the burst's
    ``on_cycle``; the burst's own fallback cycles reach ``on_cycle``
    too) → the list of each built Driver's records."""
    drivers = []

    class Recording(ref.Driver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.cycle_records = []
            self._in_burst = False
            drivers.append(self.cycle_records)

        def schedule_once(self):
            stats = super().schedule_once()
            if not self._in_burst:
                self.cycle_records.append(
                    scenarios.cycle_record(self, stats))
            return stats

        def schedule_burst(self, *a, on_cycle=None, **kw):
            def hook(k, stats):
                self.cycle_records.append(
                    scenarios.cycle_record(self, stats))
                if on_cycle is not None:
                    on_cycle(k, stats)
            self._in_burst = True
            try:
                return super().schedule_burst(*a, on_cycle=hook, **kw)
            finally:
                self._in_burst = False

    base = ref.Driver
    ref.Driver = Recording
    try:
        yield drivers
    finally:
        ref.Driver = base


def _args(flags, size=QUICK):
    return tns.parse_args(size + flags + ["--torch-device", "cpu"])


@pytest.mark.parametrize("flavors,resources", [(4, 3), (2, 1), (1, 1)])
def test_mixed_fleet_matches_the_script(ref, flavors, resources):
    """Per-cycle device arm, host walk and the burst on the CPU: the
    script's per-cycle decisions and counts; at 4 x 3 also its resume,
    walk-stop, scalar and host-cycle counters, with resumes."""
    flags = ["--flavors", str(flavors), "--resources", str(resources)]
    arms = (("device", lambda m, a, r: m.run_path(a, True, **r)),
            ("host", lambda m, a, r: m.run_path(a, False, **r)),
            ("burst", lambda m, a, r: m.run_burst_path(a, "cpu", **r)))
    for label, call in arms:
        with recorded(ref) as drivers:
            want = call(ref, _args(flags), {})
        scenarios.release()
        rec = []
        got = call(tns, _args(flags), dict(record=rec))
        scenarios.release()
        assert len(drivers) == 1 and len(rec) == 1, label
        assert _json(rec[0]["decisions"]) == _json(drivers[0]), label
        assert rec[0]["digest"] == scenarios.records_digest(
            _json(drivers[0])), label
        assert got["path"] == want["path"], label
        for k in COUNTS:
            assert got[k] == want[k], (label, k, got[k], want[k])
        if label == "burst":
            assert got["path"] == "burst-cpu"
            assert got["burst_stats"]["burst_cycles_decided"] > 0
        if (flavors, resources) == (4, 3) and label == "device":
            for k in FALLBACKS:
                assert got["solver_stats"][k] == want["solver_stats"][k], k
            assert got["solver_stats"]["resume_heads"] > 0
        if label != "host":
            assert got["preempted"] > 0 and got["skipped"] > 0, label


# the trickle touches 10 CQs a round: at --quick's 12 that is past the
# delta pack's half-dirty limit and every boundary repacks in full, so the
# trickle runs at 30 CQs with 10 workloads each (the backlog drains before
# the fill); with 100 a CQ ("backlog", 21 CQs) every CQ's inadmissible
# backlog dirties its journal each cycle and every trickle boundary
# repacks in full, in both packages
TRICKLE_SIZES = {
    "drained": ["--cqs", "30", "--wl", "300", "--cycles", "12",
                "--trials", "1"],
    "backlog": ["--cqs", "21", "--wl", "2100", "--cycles", "6",
                "--trials", "1"],
}


@pytest.mark.parametrize("size,no_delta_pack", [
    ("drained", False), ("drained", True), ("backlog", False)])
def test_trickle_counters_match_the_script(ref, size, no_delta_pack):
    """The fill, then 6 sparse-boundary rounds on the serial burst: the
    script's trickle pack counters and per-cycle decisions; delta packs
    on the delta arm after a drained backlog, none on the full-pack arm
    and none while every CQ keeps a backlog."""
    flags = ["--trickle", "6", "--no-pipeline"] + (
        ["--no-delta-pack"] if no_delta_pack else [])
    with recorded(ref) as drivers:
        want = ref.run_burst_path(_args(flags, TRICKLE_SIZES[size]),
                                  backend="cpu")
    scenarios.release()
    assert os.environ["KUEUE_BURST_DELTA_PACK"] == (
        "0" if no_delta_pack else "1")
    rec = []
    got = tns.run_burst_path(_args(flags, TRICKLE_SIZES[size]), "cpu",
                             record=rec)
    scenarios.release()
    assert _json(rec[0]["decisions"]) == _json(drivers[0])
    for k in TRICKLE:
        assert got["trickle"][k] == want["trickle"][k], (k, got["trickle"],
                                                         want["trickle"])
    assert got["path"] == want["path"]
    tr = got["trickle"]
    if no_delta_pack:
        assert tr["burst_delta_packs"] == 0
        assert got["path"] == "burst-cpu-serial-fullpack"
    elif size == "backlog":
        assert tr["burst_delta_packs"] == 0
        assert tr["burst_full_packs"] == tr["burst_packs"] == 6
    else:
        assert tr["burst_delta_packs"] > 0 and tr["rows_reused"] > 0


def test_hetero_tail_passes_the_validator(tmp_path, capsys):
    """The twin's quick ``--burst --ab-hetero --flavors 4 --resources 3
    --ab-shards 2 --burst-backend cpu`` run (the 2-shard arm on a virtual
    mesh of the CPU): one digest over the four arms, no host fallback,
    and a tail that scripts/validate_artifacts.py accepts."""
    out = str(tmp_path / "NORTHSTAR_r99.json")
    rc = tns.main(QUICK + ["--burst", "--ab-hetero", "--flavors", "4",
                           "--resources", "3", "--ab-shards", "2",
                           "--burst-backend", "cpu", "--torch-device",
                           "cpu", "--out", out])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    with open(out) as f:
        d = json.load(f)
    assert json.loads(last) == d
    assert d["quick"] is True
    h = d["hetero"]
    assert h["decisions_identical_across_arms"] is True
    assert h["zero_host_fallbacks"] is True
    assert h["fallbacks"]["burst_dirty_scalar"] == 0
    assert h["resume_heads"] > 0 and h["walk_stop_heads"] > 0
    assert h["shard_arm"]["shards"] == 2
    assert d["mesh"]["virtual"] is True and d["mesh"]["shards"] == 2
    assert d["burst-cpu-shard2"]["burst_stats"][
        "burst_sharded_dispatches"] > 0
    assert h["drift"]["environment_drift"]["interleaved"] is True
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    assert validator.validate(out) == []


def _script_tail(ref, argv, monkeypatch, capsys, tmp_path) -> dict:
    """The script's JSON tail.  A run with shards builds a JAX mesh: it
    runs in its own process, as tests/test_soak_quick.py runs the script
    (a JAX mesh run in a test worker deadlocks a later sharded_cycle_fn
    there, ROADMAP Queue 3)."""
    if "--crossover" in argv:
        out = str(tmp_path / "tail.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "northstar_e2e.py"),
             *argv, "--out", out], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out) as f:
            return json.load(f)
    monkeypatch.setattr(sys, "argv", ["northstar_e2e.py"] + argv)
    capsys.readouterr()
    ref.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--burst", "--crossover", "1,2", "--burst-backend", "cpu"],
    ["--burst", "--ab-pipeline", "--burst-backend", "cpu"],
    ["--fair-sharing"],
], ids=["crossover", "ab-pipeline", "fair-sharing"])
def test_other_arms_give_the_scripts_tail(ref, monkeypatch, capsys,
                                          tmp_path, flags):
    """The twin's tail has the script's keys (and each arm's), equal
    decision counts arm by arm, and stable decisions across its arms."""
    want = _script_tail(ref, QUICK + flags, monkeypatch, capsys, tmp_path)
    scenarios.release()
    got = tns.run(_args(flags))
    scenarios.release()
    assert set(got) == set(want)
    arms = [k for k, v in want.items()
            if isinstance(v, dict) and "admitted" in v]
    assert arms
    for k in arms:
        assert set(got[k]) == set(want[k]), k
        for c in ("admitted", "preempted", "skipped", "workloads"):
            assert got[k][c] == want[k][c], (k, c)
        assert got[k].get("decisions_stable", True) is True, k
    if "crossover" in flags:
        assert got["crossover"]["decisions_identical_across_arms"] is True
        assert got["crossover"]["arms"] == [1, 2]
        assert set(got["mesh"]) - {"virtual"} == set(want["mesh"])
    if "--fair-sharing" in flags:
        assert got["hard_paths_exercised"] == want["hard_paths_exercised"]
        assert got["fs-device"]["fs_full_cycles"] > 0


def test_main_raises_without_a_gpu():
    """No CPU fallback: without a GPU the default ``--torch-device cuda``
    raises before any arm runs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tns.main(QUICK + ["--burst"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(RuntimeError):
        tns.main(QUICK + ["--fair-sharing", "--torch-device", "cuda"])
    assert buf.getvalue() == ""
