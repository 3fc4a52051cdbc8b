"""The port's federation soak (``python -m kueue_tpu_torch.federation_soak``)
against the JAX package's ``scripts/federation_soak.py`` on the CPU, at
the script's ``--quick`` size (16 CQs, 4 remote, 4 workers, 80 events):

- each of the four scenarios, seeded as the script seeds it, gives the
  script's verdict, parity mode, double admissions, ingested and
  finished counts, spread, counters, chaos record and control / faulted
  global digests;
- the twin's configuration is the script's, its tail passes
  ``validate_artifacts.validate`` and the port's copy of its checks;
- without a GPU and without ``--torch-device cpu`` the twin raises, it
  refuses fewer than 2 workers, and it writes no file unless given
  ``--out``.

Tolerance 0: everything compared is an integer, a flag or a digest.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from kueue_tpu_torch import federation_soak as tfs
from kueue_tpu_torch import scenarios
from kueue_tpu_torch.perf.validate import validate_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1511          # KUEUE_TPU_FED_SEED's default
NAMES = [name for name, _ in tfs.SCENARIOS]


def _load(name: str, rel: str):
    """A file of the repo as a module (XLA_FLAGS restored after)."""
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
def ref():
    return _load("federation_soak_under_test", "scripts/federation_soak.py")


@pytest.mark.parametrize("cqs,workers", [(16, 4), (1000, 4), (16, 2)])
def test_config_is_the_scripts(cqs, workers):
    """The twin's configuration is the script's main's ``cfg`` literal."""
    src = open(os.path.join(ROOT, "scripts", "federation_soak.py")).read()
    node = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "cfg")
    args = type("Args", (), {"workers": workers})()
    want = eval(compile(ast.Expression(node.value), "cfg", "eval"),
                {"cqs": cqs, "args": args})
    assert tfs.config(cqs, workers) == want


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_the_script(ref, tmp_path, name):
    """One scenario on both packages: the same verdict, counters, chaos
    record and digests; strict scenarios bit-identical to control."""
    i = NAMES.index(name)
    cfg = tfs.config(16, 4)
    want = dict(ref.SCENARIOS)[name](cfg, SEED + i, str(tmp_path / "ref"))
    got = dict(tfs.SCENARIOS)[name](cfg, SEED + i, str(tmp_path / "port"),
                                    scenarios.serving_modules("cpu"))
    assert want["decisions_stable"] is True, want["failures"]
    assert got["decisions_stable"] is True, got["failures"]
    assert set(got) == set(want)
    for k in got:
        if k != "obs":
            assert got[k] == want[k], k
    assert got["double_admissions"] == 0
    if got["parity"] == "strict":
        assert len(set(got["state_digest"].values())) == 1
    assert got["chaos"]["fired"], got["chaos"]


def test_tail_passes_the_validator(tmp_path):
    """The twin's quick run from an empty directory: 4 of 4 converged,
    no double admission, no file without --out, a tail the validator
    accepts."""
    here = os.getcwd()
    buf = io.StringIO()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tfs.main(["--quick", "--torch-device", "cpu"])
    finally:
        os.chdir(here)
    assert os.listdir(tmp_path) == []
    tail = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0
    assert (tail["scenarios_total"], tail["scenarios_stable"]) == (4, 4)
    assert tail["double_admissions_total"] == 0
    assert (tail["cqs"], tail["workers"], tail["events"]) == (16, 4, 80)
    assert list(tail["scenarios"]) == NAMES
    assert tail["hard_paths_exercised"] == tfs.HARD_PATHS
    out = tmp_path / "FED_r99.json"
    out.write_text(json.dumps(tail))
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    assert validator.validate(str(out)) == []
    assert validate_tail(tail, str(out)) == []


def test_a_scenario_error_is_a_failed_scenario(monkeypatch, capsys):
    """A scenario that raises is recorded failed, and the run exits 1."""
    def boom(cfg, seed, td, m):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(tfs, "SCENARIOS",
                        [("partition_during_nominate", boom)])
    rc = tfs.main(["--quick", "--torch-device", "cpu"])
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and tail["all_stable"] is False
    assert tail["scenarios"]["partition_during_nominate"]["failures"] == [
        "RuntimeError: launch failed"]


def test_main_raises_without_a_gpu():
    """No CPU fallback, at least two workers, and no file unless asked."""
    assert tfs.parser().get_default("out") is None
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(
            SystemExit):
        tfs.main(["--quick", "--workers", "1", "--torch-device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="no CUDA GPU"):
        tfs.main(["--quick"])
    assert buf.getvalue() == ""
