"""The port's OBS soak (``python -m kueue_tpu_torch.obs_soak``) against the
JAX package's ``scripts/obs_soak.py`` on the CPU:

- ``run_pair`` at 8 cycles (the script's default shape, 4 x 4 CQs, 24 a
  LocalQueue): the untraced and traced arms of both packages give the
  same per-cycle decision digests and admitted sets;
- the one difference, pinned: the script's Drivers take the host path
  (no device solver, ``cycle.order`` in the roster), the twin's the
  device solver (``cycle.nominate`` holds the solve, no ``cycle.order``);
  the six host phases the validator requires are in both rosters;
- the twin's quick tail: the dumps and the validator's schema checks
  (the 1.05 overhead ratio is a timing gate and not asserted here).

Tolerance 0: digests, keys and counts.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from kueue_tpu_torch import obs_soak as tos
from kueue_tpu_torch.obs import trace as port_trace
from kueue_tpu_torch.perf.validate import _OBS_HOST_PHASES, validate_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 4, 24)


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load("obs_soak_under_test", "scripts/obs_soak.py")


@pytest.fixture(scope="module")
def pairs(ref):
    """One lockstep rep of 8 cycles on each package."""
    try:
        want = ref.run_pair(8, 2, SHAPE)
    finally:
        ref.obs_trace.clear()
    try:
        got = tos.run_pair(8, 2, SHAPE, "cpu")
    finally:
        port_trace.clear()
    return want, got


def test_run_pair_matches_the_script(pairs):
    want, got = pairs
    for arm in ("untraced", "traced"):
        assert len(got["digests"][arm]) == 8
        assert got["digests"][arm] == want["digests"][arm], arm
        assert got["admitted"][arm] == want["admitted"][arm], arm
    assert got["digests"]["traced"] == got["digests"]["untraced"]
    assert got["admitted"]["untraced"]


def test_device_solver_difference(pairs):
    """The script's arms run the host walk, the twin's the device solver;
    both rosters hold the validator's six host phases, and only the
    host walk enters ``cycle.order``."""
    want, got = pairs
    assert want["traced_driver"].scheduler.solver is None
    assert got["traced_driver"].scheduler.solver is not None
    assert got["traced_driver"].device == "cpu"
    r_want = want["tracer"].roster()
    r_got = got["tracer"].roster()
    assert set(_OBS_HOST_PHASES) <= set(r_want)
    assert set(_OBS_HOST_PHASES) <= set(r_got)
    assert "cycle.order" in r_want and "cycle.order" not in r_got
    for p in _OBS_HOST_PHASES:
        assert r_got[p]["count"] == r_want[p]["count"], p


def test_quick_tail_passes_the_schema(tmp_path, capsys):
    """``--quick --cycles 8``: identical decisions over every rep, no
    host phase missing, the three dumps, and the validator's checks
    (all but the overhead-ratio timing gate)."""
    out = str(tmp_path / "OBS_r99.json")
    rc = tos.main(["--quick", "--cycles", "8", "--torch-device", "cpu",
                   "--out", out])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    with open(out) as f:
        d = json.load(f)
    assert json.loads(last) == d
    assert d["decisions_identical"] is True
    assert d["spans_missing_host_phases"] == []
    assert d["dumps"]["flightrecorder_ok"] and d["dumps"]["sigusr2_ok"]
    assert d["dumps"]["chrome_trace_events"] > 0
    assert d["reps"] == 8 and d["quick"] is True and d["cqs"] == 16
    assert rc == (0 if d["overhead"]["ratio"] <= 1.05 else 1)
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    timing = "'overhead.ratio'="
    assert [e for e in validator.validate(out) if timing not in e] == []
    assert [e for e in validate_tail(d, out) if timing not in e] == []


def test_main_raises_without_a_gpu():
    assert tos.parser().get_default("out") is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="no CUDA GPU"):
        tos.main(["--quick"])
    assert buf.getvalue() == ""
