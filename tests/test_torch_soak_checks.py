"""``kueue_tpu_torch.perf.validate``, the port's copy of the checks of
``scripts/validate_artifacts.py`` that the chip smoke run applies to the
soak twins' tails, stays the script's: each copied function is the
script's line for line, and ``validate_tail`` gives ``validate``'s
verdict on the repo's CHAOS / OBS / SCALE / TRAFFIC / FED / SERVE /
DIST records and on broken copies of them."""

from __future__ import annotations

import copy
import importlib.util
import inspect
import json
import os

import pytest

from kueue_tpu_torch.perf import validate as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ("_err", "_check_common", "_check_chaos", "_check_metric_value",
          "_check_scale", "_check_scale_r18", "_check_scale_r19",
          "_check_obs_block", "_check_obs", "_check_traffic", "_check_fed",
          "_check_serve", "_check_dist")
RECORDS = ("CHAOS_r09.json", "OBS_r16.json", "SCALE_r13.json",
           "SCALE_r18.json", "SCALE_r20.json", "TRAFFIC_r11.json",
           "FED_r15.json", "SERVE_r17.json", "DIST_r20.json")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "validate_artifacts_under_test",
        os.path.join(ROOT, "scripts", "validate_artifacts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", COPIED)
def test_copied_check_is_the_scripts(ref, name):
    assert inspect.getsource(getattr(port, name)) == inspect.getsource(
        getattr(ref, name))


def test_obs_host_phases_are_the_scripts(ref):
    assert port._OBS_HOST_PHASES == ref._OBS_HOST_PHASES


def _broken(d: dict) -> dict:
    """A copy with one check of its kind broken."""
    d = copy.deepcopy(d)
    if "double_admissions_total" in d:
        d["double_admissions_total"] += 1
    elif "arms" in d:
        d["replay_identical"] = None
    elif "kills" in d:
        d["kills"]["submitter"]["lost"] = 1
    elif "kill_restart" in d:
        d["kill_restart"]["duplicated_admissions"] = 1
    elif "scenarios" in d:
        d["scenarios_stable"] += 1
    elif "overhead" in d:
        d["overhead"]["ratio"] = 1.5
    else:
        d["parity"]["planes_identical_all"] = not d["parity"][
            "planes_identical_all"]
    return d


@pytest.mark.parametrize("record", RECORDS)
def test_validate_tail_is_validate(ref, tmp_path, record):
    with open(os.path.join(ROOT, record)) as f:
        d = json.load(f)
    for tail in (d, _broken(d)):
        path = tmp_path / record
        path.write_text(json.dumps(tail))
        assert port.validate_tail(tail, str(path)) == ref.validate(str(path))
    assert port.validate_tail(_broken(d), record)
