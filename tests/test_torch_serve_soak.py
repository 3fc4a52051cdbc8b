"""The port's serving soak (``python -m kueue_tpu_torch.serve_soak``)
against the JAX package's ``scripts/serve_soak.py`` on the CPU, at the
script's ``--quick`` size (8 CQs):

- the parity arm, the kill / restart arm and the SIGTERM drain arm of
  both, seeded as the script's ``main`` seeds them: the same events,
  admitted counts and verdicts; the same control digest, per-kill
  digests, cycles, lost and duplicated counts; the same drain counts
  (the wall arm runs on the wall clock, so only its schedule is
  compared);
- the twin's whole quick run: every arm ok, a tail that
  ``validate_artifacts.validate`` and the port's copy of its checks
  accept, the service thread on the builder's device and stream;
- without a GPU and without ``--torch-device cpu`` the twin raises, and
  it writes no file unless given ``--out``.

Tolerance 0: everything compared is an integer, a flag or a digest.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import importlib.util
import io
import json
import os
import signal

import pytest
import torch

from kueue_tpu_torch import scenarios
from kueue_tpu_torch import serve_soak as tss
from kueue_tpu_torch.perf.validate import validate_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1709          # KUEUE_TPU_SVC_SEED's default


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
    return _load("serve_soak_under_test", "scripts/serve_soak.py")


@pytest.fixture(scope="module")
def cfg():
    return tss.config(argparse.Namespace(quick=True, cqs=16))


@pytest.fixture(scope="module")
def m():
    return scenarios.serving_modules("cpu")


@pytest.mark.parametrize("quick", [True, False])
def test_config_is_the_scripts(ref, quick):
    """The twin's configuration is the script's main's ``cfg`` literal,
    quick and full."""
    src = open(os.path.join(ROOT, "scripts", "serve_soak.py")).read()
    node = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "cfg")
    args = argparse.Namespace(quick=quick, cqs=16)
    want = eval(compile(ast.Expression(node.value), "cfg", "eval"),
                {"args": args, "env_int": ref.env_int})
    assert tss.config(args) == want


def test_parity_arm_matches_the_script(ref, m, cfg):
    """The service loop (K = 1) against the open-loop runner, on both
    packages: the same events, the same admitted counts, bit-identical
    decisions and equal state digests."""
    want = ref.arm_parity(cfg, SEED)
    got = tss.arm_parity(m, cfg, SEED)
    assert got == want
    assert got["decisions_identical"] and got["state_digests_match"]
    assert got["service_admitted"] > 0


def test_kill_restart_arm_matches_the_script(ref, m, cfg, tmp_path):
    """Both crash sites: the script's control digest, per-kill digests,
    cycles, zero lost and zero duplicated, resubmitted tokens."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = ref.arm_kill_restart(cfg, SEED + 1, str(tmp_path / "ref"))
    got = tss.arm_kill_restart(m, cfg, SEED + 1, str(tmp_path / "port"))
    assert got == want
    assert got["lost_accepted_submissions"] == 0
    assert got["duplicated_admissions"] == 0
    assert got["digests_match"] and got["decisions_identical"]
    for s in got["scenarios"].values():
        assert s["crashed"] and s["digest"] == got["control_digest"]


def test_drain_arm_matches_the_script(ref, m, cfg, tmp_path):
    """SIGTERM to this process drains both services clean: the same
    accepted, applied and rejected-after-drain counts, the WAL flushed;
    the twin puts the previous SIGTERM handler back."""
    before = signal.getsignal(signal.SIGTERM)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    try:
        want = ref.arm_drain(cfg, SEED + 2, str(tmp_path / "ref"))
    finally:
        signal.signal(signal.SIGTERM, before)
    got = tss.arm_drain(m, cfg, SEED + 2, str(tmp_path / "port"), "cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    for k in ("clean", "wal_flushed", "accepted", "applied_in_store",
              "zero_lost", "rejected_after_drain", "journal"):
        assert got[k] == want[k], k
    assert got["clean"] and got["zero_lost"] and got["rejected_after_drain"]


def test_wall_schedule_is_the_scripts(ref, cfg):
    """The wall arm's diurnal schedule (replayed at wall pace) is the
    script's."""
    assert scenarios.serve_wall_schedule(cfg, SEED + 3) == \
        ref.gen_wall_schedule(cfg, SEED + 3)


def test_tail_passes_the_validator(tmp_path):
    """The twin's whole quick run from an empty directory: every arm ok,
    no file without --out, a tail the validator accepts."""
    here = os.getcwd()
    buf = io.StringIO()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tss.main(["--quick", "--torch-device", "cpu"])
    finally:
        os.chdir(here)
    assert os.listdir(tmp_path) == []
    tail = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and tail["all_ok"] is True, tail
    assert tail["wall"]["wall_clock"] is True
    assert tail["wall"]["slo"]["k_adapted"] is True
    assert len(tail["wall"]["slo"]["windows"]) == 6
    assert tail["kill_restart"]["lost_accepted_submissions"] == 0
    assert tail["kill_restart"]["duplicated_admissions"] == 0
    out = tmp_path / "SERVE_r99.json"
    out.write_text(json.dumps(tail))
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    assert validator.validate(str(out)) == []
    assert validate_tail(tail, str(out)) == []


def test_service_thread_runs_on_the_builders_stream():
    """``scenarios.thread_target`` hands a service thread the builder's
    device and stream; off the card it is the function itself."""
    def fn(x):
        return x + 1
    assert scenarios.thread_target(fn, "cpu") is fn
    if not torch.cuda.is_available():
        return
    import threading
    s = torch.cuda.Stream()
    seen = []
    with torch.cuda.stream(s):
        t = threading.Thread(target=scenarios.thread_target(
            lambda: seen.append(torch.cuda.current_stream()), "cuda"))
    t.start()
    t.join()
    assert seen == [s]


def test_main_raises_without_a_gpu():
    """No CPU fallback, and no file unless asked."""
    assert tss.parser().get_default("out") is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="no CUDA GPU"):
        tss.main(["--quick"])
    assert buf.getvalue() == ""
