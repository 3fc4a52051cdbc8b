"""The port's chaos soak (``python -m kueue_tpu_torch.chaos_soak``) against
the JAX package's ``scripts/chaos_soak.py`` on the CPU, at the script's
``--quick`` size (16 CQs):

- each of the seven scenarios, seeded as the script seeds it, gives the
  script's verdict, counters and control / faulted state digests (the
  script's shard cascade runs in a process of its own: it needs an
  8-device JAX mesh, which a test worker's JAX cannot take);
- the twin's tail passes ``validate_artifacts.validate`` and the port's
  copy of its checks;
- without a GPU and without ``--torch-device cpu`` the twin raises, and
  it writes no file unless given ``--out``.

Tolerance 0: everything compared is an integer, a flag or a digest.
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

from kueue_tpu_torch import chaos_soak as tcs
from kueue_tpu_torch.parallel import sharded
from kueue_tpu_torch.perf.validate import validate_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1009
COUNTERS = ("crashed_after_cycles", "wal_tail_replayed", "tail_admits",
            "burst_dispatches", "divergences_forced", "degradations",
            "serial_fallbacks", "final_shards", "mirrored_workloads",
            "total_admissions", "cycles", "fired", "admitted_per_arm")
NAMES = [name for name, _ in tcs.SCENARIOS]


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """scripts/chaos_soak.py as a module; its import-time edit of
    XLA_FLAGS (read from this process's argv) is undone."""
    prev = os.environ.get("XLA_FLAGS")
    try:
        return _load("chaos_soak_under_test", "scripts/chaos_soak.py")
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev


def _script_cascade(tmp_path) -> dict:
    """The script's cascade at --quick in a fresh process on an 8-device
    CPU mesh."""
    out = str(tmp_path / "CHAOS_r98.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "chaos_soak.py"),
         "--quick", "--only", "shard_cascade_8_4_1", "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)["scenarios"]["shard_cascade_8_4_1"]


def _scenario(mod, name: str, wal_path: str, **kw) -> dict:
    i = NAMES.index(name)
    fn = dict(mod.SCENARIOS)[name]
    cfg = dict(mod.config(16)) if hasattr(mod, "config") else dict(
        cqs=16, runtime=2, drain_per_cq=4, drain_cycles=12,
        sustained_per_cq=40, sustained_cycles=72)
    try:
        return fn(cfg, SEED + i, wal_path, **kw)
    finally:
        mod.chaos.clear()


def test_config_is_the_scripts():
    """The twin's drain and sustained sizes are the script's (its main's
    ``cfg`` literal)."""
    src = open(os.path.join(ROOT, "scripts", "chaos_soak.py")).read()
    for k, v in tcs.config(16).items():
        if k != "cqs":
            assert f'"{k}": {v},' in src, k


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_the_script(ref, tmp_path, name):
    """One scenario on both packages: the same verdict, counters and
    state digests, and both bit-identical to their control."""
    if name == "shard_cascade_8_4_1":
        want = _script_cascade(tmp_path)
        del want["wall_s"], want["seed"]   # main's additions
        with sharded.virtual_mesh("cpu", 8):
            got = _scenario(tcs, name, str(tmp_path / "port.wal.jsonl"),
                            device="cpu")
    else:
        want = _scenario(ref, name, str(tmp_path / "ref.wal.jsonl"))
        got = _scenario(tcs, name, str(tmp_path / "port.wal.jsonl"),
                        device="cpu")
    assert not want.get("skipped") and not got.get("skipped"), (want, got)
    assert want["decisions_stable"] is True, want["failures"]
    assert got["decisions_stable"] is True, got["failures"]
    assert set(got) == set(want)
    for k in COUNTERS:
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))
    assert got["state_digest"] == want["state_digest"]
    assert len(set(got["state_digest"].values())) == 1
    if name == "shard_cascade_8_4_1":
        assert (got["degradations"], got["serial_fallbacks"],
                got["final_shards"]) == (2, 1, 1)
    if name in ("boundary_crash", "mid_admit_crash", "mid_burst_crash"):
        assert got["crashed_after_cycles"] > 0
    if name == "mid_admit_crash":
        assert got["tail_admits"] > 0 and got["wal_tail_replayed"] > 0


def test_cascade_skips_without_eight_devices(tmp_path):
    """As the script skips on fewer than 8 JAX devices: a 4-wide mesh
    skips the cascade with its reason."""
    with sharded.virtual_mesh("cpu", 4):
        got = tcs.scenario_shard_cascade(tcs.config(16), SEED,
                                         str(tmp_path / "w.jsonl"),
                                         device="cpu")
    assert got == {"skipped": True,
                   "reason": "needs 8 devices, have 4 (run with "
                             "--devices 8)"}


def test_tail_passes_the_validator(tmp_path, capsys):
    """The twin's quick run: 7 of 7 stable, the cascade on a virtual
    mesh, a tail that validate_artifacts and the port's copy accept."""
    out = str(tmp_path / "CHAOS_r99.json")
    rc = tcs.main(["--quick", "--torch-device", "cpu", "--out", out])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    with open(out) as f:
        d = json.load(f)
    assert json.loads(last) == d
    assert (d["scenarios_total"], d["scenarios_stable"]) == (7, 7)
    assert d["all_stable"] is True and d["cqs"] == 16
    assert list(d["scenarios"]) == NAMES
    assert d["mesh"]["virtual"] is True and d["mesh"]["shards"] == 8
    assert d["hard_paths_exercised"] == tcs.HARD_PATHS
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    assert validator.validate(out) == []
    assert validate_tail(d, out) == []


def test_a_scenario_error_is_a_failed_scenario(monkeypatch, capsys):
    """A scenario that raises is recorded failed, never skipped or
    stable, and the run exits 1."""
    def boom(cfg, seed, wal_path, device="cuda"):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(tcs, "SCENARIOS",
                        [("boundary_crash", boom)] + tcs.SCENARIOS[1:2])
    rc = tcs.main(["--quick", "--torch-device", "cpu"])
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and tail["all_stable"] is False
    assert tail["scenarios"]["boundary_crash"]["failures"] == [
        "RuntimeError: launch failed"]
    assert tail["scenarios_stable"] == 1


def test_main_raises_without_a_gpu():
    """No CPU fallback, and no file unless asked."""
    assert tcs.parser().get_default("out") is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="no CUDA GPU"):
        tcs.main(["--quick"])
    assert buf.getvalue() == ""
