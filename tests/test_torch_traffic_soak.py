"""The port's traffic soak (``python -m kueue_tpu_torch.traffic_soak``)
against the JAX package's ``scripts/traffic_soak.py`` on the CPU, at the
script's ``--quick`` size (16 CQs, the 3-rung ladder, 2 search steps):

- the script runs in a process of its own (its sharded arm needs 8
  forced XLA host devices, and a JAX mesh Driver in a test worker
  deadlocks a later ``sharded_cycle_fn``: ROADMAP Queue 3); the twin
  runs here with its sharded arm on a virtual mesh of 8 CPU copies;
- every arm's curve gives the script's submitted / admitted / end depth
  (and the rest of what a probe decides) at each rate, the same
  sustainable rates, ``replay_identical`` and
  ``serial_shard_decisions_match``, the same snapshot counters, storm
  and remote probes;
- a serial probe past the quota ceiling at 128 and 512 CQs (the script
  loaded here) gives the script's per-cycle decisions;
- the twin's helpers are the script's, its tail passes
  ``validate_artifacts.validate`` and the port's copy of its checks;
- without a GPU and without ``--torch-device cpu`` the twin raises, and
  it writes no file unless given ``--out``.

Tolerance 0: everything compared is an integer, a flag, a virtual-time
latency or a digest; no wall time is compared.
"""

from __future__ import annotations

import contextlib
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from kueue_tpu_torch import scenarios
from kueue_tpu_torch import traffic_soak as tts
from kueue_tpu_torch.parallel import sharded
from kueue_tpu_torch.perf.validate import validate_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, rel: str):
    """A file of the repo as a module; its import-time edit of XLA_FLAGS
    (read from this process's argv) is undone."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, *rel.split("/")))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


@pytest.fixture(scope="module")
def script_tail(tmp_path_factory):
    """scripts/traffic_soak.py --quick in a fresh process on 8 forced CPU
    devices → its tail."""
    out = str(tmp_path_factory.mktemp("script") / "TRAFFIC_r98.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "traffic_soak.py"),
         "--quick", "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The twin's ``main`` at --quick on the CPU, run from an empty
    directory without ``--out`` → (tail, printed lines, directory)."""
    cwd = tmp_path_factory.mktemp("port")
    here = os.getcwd()
    buf = io.StringIO()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tts.main(["--quick", "--torch-device", "cpu"])
    finally:
        os.chdir(here)
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines, cwd


def test_helpers_are_the_scripts():
    """The capacity, the stream seed, the arrival marks and the curve
    entry are the script's."""
    ref = _load("traffic_soak_under_test", "scripts/traffic_soak.py")
    for n in (16, 1000):
        assert scenarios.traffic_capacity(n) == ref.capacity_estimate(n)
        for frac in (0.25, 0.5, 1.5):
            rate = round(scenarios.traffic_capacity(n) * frac, 1)
            assert scenarios.rate_seed(1109, rate) == ref.rate_seed(1109,
                                                                    rate)
        for remote in (0.0, 0.25):
            assert vars(scenarios.traffic_marks(n, remote)) == vars(
                ref.spec_for(n, remote_fraction=remote))
    assert inspect.getsource(tts.curve_entry) == inspect.getsource(
        ref.curve_entry)


@pytest.mark.parametrize("cqs,frac", [(128, 1.2), (512, 1.5), (1000, 1.5)])
def test_probe_past_saturation_matches_the_script(cqs, frac):
    """One serial probe past the quota ceiling at a wider cluster, 30
    virtual s with no wall budget: the script's per-cycle decisions, bit
    for bit, and its counters.  At 1,000 CQs and 1,000/s (seed 9,109)
    both give 23,343 admitted and an end depth of 5,101, where
    TRAFFIC_r11.json, written by an older script, has 23,344 and 5,099."""
    ref = _load("traffic_soak_under_test", "scripts/traffic_soak.py")
    rate = round(ref.capacity_estimate(cqs) * frac, 1)
    cfg = dict(cqs=cqs, duration_s=30.0, slo_p99_s=8.0, wall_budget_s=None)
    seed = ref.rate_seed(1109, rate)
    want = ref.probe(cfg, rate, 0, seed=seed)
    got = tts.probe(cfg, rate, 0, seed=seed, device="cpu")
    assert got.decisions == want.decisions
    assert (got.submitted, got.admitted, got.end_depth, got.max_depth) == (
        want.submitted, want.admitted, want.end_depth, want.max_depth)
    assert got.latency_hist == want.latency_hist
    assert got.end_depth > 0   # past the ceiling: a backlog is left
    if cqs == 1000:
        assert (seed, got.submitted, got.admitted, got.end_depth) == (
            9109, 28789, 23343, 5101)


@pytest.mark.parametrize("arm", ["serial", "shards_8"])
def test_curve_matches_the_script(script_tail, port_run, arm):
    """One arm: at each rate of the ladder and of the search, the
    script's submitted / admitted / end depth, and everything else a
    probe decides; the same sustainable rate and bracket."""
    tail = port_run[0]
    want, got = script_tail["arms"][arm], tail["arms"][arm]
    assert [e["rate_per_s"] for e in got["curve"]] == \
        [e["rate_per_s"] for e in want["curve"]]
    assert len(got["curve"]) == 3 + 2   # the ladder and the search
    for e_got, e_want in zip(got["curve"], want["curve"]):
        for k in ("submitted", "admitted", "end_depth"):
            assert e_got[k] == e_want[k], (e_got["rate_per_s"], k)
    assert tts.decided(tail)["arms"][arm] == \
        tts.decided(script_tail)["arms"][arm]
    assert got["sustainable_rate_per_s"] == want["sustainable_rate_per_s"]


def test_replay_snapshot_and_probes_match_the_script(script_tail, port_run):
    """The replay is bit-identical, the sharded arm decides as the serial
    one, and the snapshot counters, the storm and the remote probes are
    the script's."""
    tail = port_run[0]
    assert tail["replay_identical"] is True
    assert tail["serial_shard_decisions_match"] is True
    assert tts.decided(tail) == tts.decided(script_tail)
    assert tail["remote_probe"]["remote_submitted"] > 0
    assert tail["snapshot_counters"]["probes"]["low_rate_full_rebuild"][
        "snap_full_rebuilds"] > tail["snapshot_counters"]["probes"][
        "low_rate"]["snap_full_rebuilds"]


def test_sharded_arm_on_a_virtual_mesh(port_run):
    """The script forces 8 XLA host devices; the twin runs its sharded
    arm on a virtual mesh of 8 copies of the torch device (``"virtual":
    true``), through the per-cycle mesh: the replay rate's sharded run
    dispatches every cycle with heads over the shards, and its decisions
    are the serial run's."""
    tail = port_run[0]
    assert tail["mesh"]["virtual"] is True
    assert tail["mesh"]["shards"] == 8 and tail["mesh"]["n_devices"] == 1
    rate = tail["value"]
    cfg = dict(cqs=16, duration_s=10.0, slo_p99_s=8.0, wall_budget_s=20.0)
    record: dict = {}
    with sharded.virtual_mesh("cpu", 8):
        live = tts.probe(cfg, rate, 0, seed=scenarios.rate_seed(1109, rate),
                         device="cpu", record=record, tag="serial")
        d, clock = tts.build(16, 8, "cpu")
        r = scenarios.open_loop(d, clock, scenarios.traffic_stream(
            16, rate, 0, events=live.events), duration_s=10.0)
    stats = d.scheduler.solver.stats
    assert stats["sharded_dispatches"] > 0
    assert tts.decisions_digest(r.decisions) == record["serial"]
    assert "KUEUE_TPU_SHARDS" not in os.environ


def test_tail_passes_the_validator(port_run, tmp_path):
    tail, lines, cwd = port_run
    assert os.listdir(cwd) == []   # no --out, no file
    assert tail["cqs"] == 16 and tail["quick"] is True
    assert tail["arrival"]["seed"] == 1109
    assert tail["obs"] is not None
    out = tmp_path / "TRAFFIC_r99.json"
    out.write_text(json.dumps(tail))
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    assert validator.validate(str(out)) == []
    assert validate_tail(tail, str(out)) == []


def test_main_raises_without_a_gpu():
    """No CPU fallback, and no file unless asked."""
    assert tts.parser().get_default("out") is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="no CUDA GPU"):
        tts.main(["--quick"])
    assert buf.getvalue() == ""
