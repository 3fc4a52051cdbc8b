"""``python -m kueue_tpu_torch.dist_soak``, the port's twin of
``scripts/dist_soak.py``, on the CPU: the shard control decides as the
JAX package's on the script's full schedule (tolerance 0), the kill and
socket arms at the script's full configuration give ``DIST_r20.json``'s
deterministic fields, and the twin's ``--quick`` exits 0 with a tail that
passes the script's ``validate`` and the port's copy, every child the
port's ``python -m kueue_tpu_torch.dist.child`` (shards and workers on
``--device cpu``, submitters without a device).  Children start in ~2-3
s here; the quick run takes ~40 s."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch

from kueue_tpu_torch import dist_soak, scenarios
from kueue_tpu_torch.chaos import injector as chaos
from kueue_tpu_torch.dist.serving import step_payloads
from kueue_tpu_torch.perf.validate import validate_tail

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    os.environ.get("KUEUE_TPU_SKIP_PROC_TESTS") == "1",
    reason="process spawning disabled")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _chaos_off():
    from kueue_tpu.chaos import injector as jax_chaos
    chaos.clear()
    jax_chaos.clear()
    yield
    chaos.clear()
    jax_chaos.clear()


@pytest.fixture(scope="module")
def record20():
    with open(os.path.join(ROOT, "DIST_r20.json")) as fh:
        return json.load(fh)


def _full_cfg():
    """The script's ``cfg`` without ``--quick``, as DIST_r20.json ran."""
    return dist_soak.config(dist_soak.parser().parse_args(
        ["--torch-device", "cpu"]))


def test_full_config_is_the_records(record20):
    assert _full_cfg() == record20["config"]
    assert dist_soak.parser().parse_args([]).seed == record20["seed"]


def test_dist_control_decides_as_the_jax_control(tmp_path):
    """The script's full lockstep schedule (8 steps, 4 a submitter a
    step, 2 submitters, 8 CQs) into the JAX package's shard service and
    the port's ``scenarios._dist_control`` on "cpu": the same admission
    keys at every step."""
    from kueue_tpu.dist.serving import build_shard_service
    cfg = _full_cfg()
    os.makedirs(tmp_path / "jax")
    ref, _clock = build_shard_service(0, cfg["cqs"], str(tmp_path / "jax"))
    port = scenarios._dist_control(str(tmp_path / "port"), cfg["cqs"],
                                   "cpu")
    n_sub = cfg["submitters"]
    steps = []
    for step in range(cfg["kill_steps"]):
        for j in range(n_sub):
            for b in step_payloads(step, j, n_sub, cfg["per_step"],
                                   cfg["cqs"]):
                ref.submit(name=b["name"], queue_name=b["queue_name"],
                           requests=b["requests"], priority=b["priority"],
                           namespace=b["namespace"],
                           runtime_s=b["runtime_s"], count=b["count"],
                           token=b["token"])
        scenarios._ctl_submit(port, step, n_sub, cfg["per_step"],
                              cfg["cqs"])
        want = sorted(k for dec in ref.step()["decisions"] for k in dec)
        got = sorted(k for dec in port.step()["decisions"] for k in dec)
        assert got == want, step
        steps.append(len(got))
    assert sum(steps) == 64    # DIST_r20.json's kill arms' admissions


ARM_FIELDS = {
    "front_end_shard": ("admissions", "dedupe", "decisions_identical",
                        "lost", "duplicated", "killed", "same_port",
                        "restarts", "steps"),
    "submitter": ("admissions", "dedupe", "decisions_identical", "lost",
                  "duplicated", "killed", "restarts", "steps"),
    "service_mid_cycle": ("admissions", "crashes", "crash_exit",
                          "decisions_identical", "lost", "duplicated",
                          "restarts", "steps"),
}


@pytest.mark.parametrize("arm", sorted(ARM_FIELDS))
def test_kill_arm_at_full_config_matches_the_record(arm, tmp_path,
                                                    record20):
    """The arm at the script's full configuration and seed (2003 + its
    offset) on "cpu": DIST_r20.json's admissions, dedupe counts, crash
    and verdicts."""
    i = [name for name, _ in dist_soak.ARMS].index(arm)
    rec: dict = {}
    block, report = dist_soak.run_arm(arm, _full_cfg(),
                                      record20["seed"] + i,
                                      str(tmp_path), "cpu", rec)
    want = record20["kills"][arm]
    assert {k: block[k] for k in ARM_FIELDS[arm]} == {
        k: want[k] for k in ARM_FIELDS[arm]}
    assert block["ok"] and block["parity"]
    assert report["by_role"] == record20["dist"]["per_arm"][arm]["by_role"]
    assert dist_soak.check(rec) == []


def test_socket_arm_at_full_config_matches_the_record(tmp_path, record20):
    """The socket arm (seed 2003 + 5) on "cpu": one reset, truncation,
    latency and blackhole at the proxy, and the client's requests,
    retries, mid-body and refused retries of DIST_r20.json."""
    rec: dict = {}
    block, _report = dist_soak.run_arm("socket_faults", _full_cfg(),
                                       record20["seed"] + 5, str(tmp_path),
                                       "cpu", rec)
    want = record20["socket_faults"]
    for k in ("resets", "truncations", "latencies", "blackholes"):
        assert block["proxy"][k] == want["proxy"][k] == 1, k
    for k in ("requests", "retries", "midbody_retries", "refused_retries"):
        assert block["client"][k] == want["client"][k], k
    assert block["refused_kind"] == want["refused_kind"] == "refused"
    assert block["refused_retries"] == want["refused_retries"] == 2
    assert block["ok"]
    # the worker never steps here: no --stats-file report
    assert rec["socket_faults"]["child_stats"] == {"w0": None}


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    args = dist_soak.parser().parse_args(["--quick", "--torch-device",
                                          "cpu"])
    rec: dict = {}
    return dist_soak.run(args, rec), rec


def test_quick_run_passes_both_validators(quick, tmp_path):
    tail, _rec = quick
    assert tail["all_ok"] is True
    assert tail["config"]["kill_steps"] == 4 and tail["quick"] is True
    spec = importlib.util.spec_from_file_location(
        "validate_artifacts_under_test",
        os.path.join(ROOT, "scripts", "validate_artifacts.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    path = tmp_path / "DIST_r22.json"
    path.write_text(json.dumps(tail))
    assert ref.validate(str(path)) == []
    assert validate_tail(tail, "DIST_r22.json") == []


def test_quick_tail_has_the_scripts_keys(quick, record20):
    tail, _rec = quick
    assert sorted(tail) == sorted(record20)
    for arm, block in tail["kills"].items():
        assert sorted(block) == sorted(record20["kills"][arm]), arm
    for part in ("saturation", "socket_faults", "metrics", "dist"):
        assert sorted(tail[part]) == sorted(record20[part]), part
    assert tail["dist"]["kill_log"] == record20["dist"]["kill_log"]
    assert sorted(tail["dist"]["per_arm"]) == sorted(
        record20["dist"]["per_arm"])


def test_children_take_the_torch_device(quick):
    """Every child is the port's module; shards and workers carry
    ``--device cpu`` and a ``--stats-file``, submitters neither, and each
    shard reported its steps without a CUDA context or a launch (the
    device-solver Drivers on the plain versions)."""
    _tail, rec = quick
    assert dist_soak.check(rec) == []
    roles = set()
    for arm, r in rec.items():
        for argv in r["argvs"]:
            assert argv[1:3] == ["-m", "kueue_tpu_torch.dist.child"], argv
            assert not any(a == "kueue_tpu" or a.startswith("kueue_tpu.")
                           for a in argv)
            role = argv[argv.index("--role") + 1]
            roles.add(role)
            if role == "submitter":
                assert "--device" not in argv and "--stats-file" not in argv
            else:
                assert argv[argv.index("--device") + 1] == "cpu"
                assert "--stats-file" in argv
        for name, st in r["child_stats"].items():
            if name.startswith("shard"):
                assert st["cuda_initialized"] is False, (arm, name)
                assert sum(st["launches"].values()) == 0
    assert roles == {"shard", "submitter", "worker"}


def test_decided_drops_the_walls(quick):
    tail, rec = quick
    d = dist_soak.decided(tail)
    assert "saturation" not in d
    assert d["kills"]["service_mid_cycle"]["crash_exit"] == 17
    assert "bytes_up" not in d["socket_faults"]["proxy"]
    assert "proxy" not in d["kills"]["federation_worker"]
    kids = dist_soak.children(tail, rec)
    assert set(kids) == {name for name, _ in dist_soak.ARMS}
    assert kids["service_mid_cycle"]["shard0 restart"]["start_s"] > 0
