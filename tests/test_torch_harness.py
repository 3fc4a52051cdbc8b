"""The port's perf harness (``kueue_tpu_torch.perf.harness``) against
the JAX package's (``kueue_tpu.perf.harness``): the generator-config
replay of tests/test_perf_harness.py's ``SMALL_CONFIG`` on the CPU (the
port's kernels' plain versions) against the JAX replay, with every
virtual-time field equal; the rangespec checker, the A/B block, the
chaos block and the two burst reports on the same inputs; ``main``'s
JSON and exit code; the accelerator check.  Tolerance 0 throughout."""

import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
import torch
import yaml

import kueue_tpu.perf.harness as jh
import kueue_tpu_torch.perf.harness as ph
from kueue_tpu.chaos.injector import ChaosInjector as JChaos
from kueue_tpu_torch import scenarios
from kueue_tpu_torch.chaos.injector import ChaosInjector as PChaos
from kueue_tpu_torch.parallel.sharded import virtual_mesh
from tests.test_perf_harness import SMALL_CONFIG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGESPEC = os.path.join(ROOT, "perf", "default_rangespec.yaml")
# PerfStats fields decided by the virtual timeline alone
VIRTUAL_FIELDS = ("total_workloads", "admitted", "finished", "virtual_ms",
                  "avg_time_to_admission_ms", "min_avg_usage_pct")


def _virtual(stats) -> dict:
    return {k: getattr(stats, k) for k in VIRTUAL_FIELDS}


@pytest.fixture(scope="module")
def replays():
    return jh.run_scenario(SMALL_CONFIG), ph.run_scenario(SMALL_CONFIG,
                                                          device="cpu")


def test_small_config_replays_identically(replays):
    j, p = replays
    assert _virtual(p) == _virtual(j)
    assert p.finished == p.total_workloads == 2 * 2 * (30 + 10 + 5)
    tta = p.avg_time_to_admission_ms
    assert tta["large"] < tta["medium"] < tta["small"]


def test_cut_generator_config_replays_identically():
    """The reference generator config cut to 1 cohort x 2 CQs and a
    tenth of each workload set: the same shape as perf-15k, preemption
    included."""
    with open(os.path.join(ROOT, "perf",
                           "default_generator_config.yaml")) as f:
        config = yaml.safe_load(f)
    config[0]["count"] = 1
    qs = config[0]["queuesSets"][0]
    qs["count"] = 2
    for ws in qs["workloadsSets"]:
        ws["count"] = max(1, ws["count"] // 10)
    j = jh.run_scenario(config)
    p = ph.run_scenario(config, device="cpu")
    assert _virtual(p) == _virtual(j)
    assert p.finished == p.total_workloads


def _stats_pair(**fields):
    return jh.PerfStats(**fields), ph.PerfStats(**fields)


RANGESPECS = [
    {"cmd": {"maxWallMs": 10 * 60 * 1000},
     "wlClassesMaxAvgTimeToAdmissionMs": {"large": 5000}},
    {"cmd": {"maxWallMs": 0.001, "mCPU": 1, "maxrss": 10},
     "clusterQueueClassesMinUsage": {"cq": 101},
     "wlClassesMaxAvgTimeToAdmissionMs": {"large": -1, "missing": 1}},
    {},
]


@pytest.mark.parametrize("spec", RANGESPECS + ["default"])
def test_check_rangespec_same_failures(spec, replays):
    if spec == "default":
        with open(RANGESPEC) as f:
            spec = yaml.safe_load(f)
    j, p = replays

    def decided(failures):   # those of the virtual timeline
        return [f for f in failures
                if not f.startswith(("wall ", "cpu ", "rss "))]
    assert decided(ph.check_rangespec(p, spec)) == decided(
        jh.check_rangespec(j, spec))
    # on equal stats, equal lists in the same order
    fields = dict(wall_ms=1234.5, cpu_mcpu=600.0, maxrss_kb=2e6,
                  avg_time_to_admission_ms={"large": 10.0, "small": 9e5},
                  min_avg_usage_pct={"cq": 40.0})
    js, ps = _stats_pair(**fields)
    assert ph.check_rangespec(ps, spec) == jh.check_rangespec(js, spec)


AB_CASES = [
    ({"arm": "burst", "p99_ms": 12.0,
      "solver_stats": {"host_cycles": 0, "scalar_heads": 0,
                       "native_ff_fallbacks": 2},
      "burst_stats": {"burst_dirty_cycles": 0, "burst_dispatches": 9}},
     {"arm": "host", "p99_ms": 40.0, "interleaved": True,
      "host_cycles": 30}, {}),
    ({"arm": "shards_8", "p99_ms": 12.0, "pack": {"stream_packs": 3}},
     {"arm": "serial", "interleaved": True},
     dict(treatment_label="sharded", control_label="serial_control")),
    ({"arm": "x"}, None, {}),
    ({"arm": "x"}, {}, {}),
    ({"arm": "x"}, {"arm": "serial", "p99_ms": 15.0}, {}),
]


@pytest.mark.parametrize("treatment,control,kw", AB_CASES)
def test_ab_block_same(treatment, control, kw):
    try:
        want = jh.ab_block(treatment, control, **kw)
    except jh.MissingControlArm as e:
        with pytest.raises(ph.MissingControlArm) as got:
            ph.ab_block(treatment, control, **kw)
        assert str(got.value) == str(e)
        assert issubclass(ph.MissingControlArm, ValueError)
        return
    assert ph.ab_block(treatment, control, **kw) == want


def _injectors():
    out = []
    for cls in (JChaos, PChaos):
        inj = cls(seed=7)
        inj.arm("cycle.start", at=2, action="crash")
        inj.arm("shard.device_loss", prob=0.5, times=3, payload=4)
        for _ in range(4):
            inj.hit("cycle.start")
            inj.hit("shard.device_loss")
        out.append(inj)
    return out


@pytest.fixture(scope="module")
def burst_stats():
    """``BurstSolver.stats`` of a serial and of an 8-shard sustained
    drain of the port on the CPU, and of one that loses 4 devices."""
    serial = scenarios.sustained_drain(device="cpu")["stats"]
    with virtual_mesh("cpu", 8):
        sharded = scenarios.sustained_drain(device="cpu", shards=8)["stats"]
        lost = scenarios.sustained_drain(device="cpu", shards=8,
                                         lose=4)["stats"]
    return {"serial": serial, "sharded": sharded, "lost": lost}


def test_the_boundary_report_is_the_references(burst_stats):
    """The repair: the port's burst boundary report is the JAX
    harness's function, with the same keys and values on the stats of a
    sharded and a serial run (the deleted scenarios twin lacked
    journal_dirty_ranges, dropped the resident counters the stats
    lacked and added two shard counters)."""
    assert not hasattr(scenarios, "burst_boundary_report")
    sharded = burst_stats["sharded"]
    assert sharded["burst_sharded_dispatches"] > 0
    assert sharded["burst_resident_hits"] > 0
    for name, st in burst_stats.items():
        got = ph.burst_boundary_report(st)
        assert got == jh.burst_boundary_report(st), name
        assert "journal_dirty_ranges" in got
        assert "sharded_dispatches" not in got
        assert "shard_degradations" not in got
    report = ph.burst_boundary_report(burst_stats["serial"])
    for key in ("resident_hits", "resident_misses", "resident_scatter_rows",
                "resident_scatter_ranges", "boundary_bytes_h2d",
                "boundary_bytes_equiv"):
        assert report[key] == 0, key


@pytest.mark.parametrize("run", ["serial", "sharded", "lost"])
def test_shard_and_chaos_reports_same(burst_stats, run):
    st = burst_stats[run]
    assert ph.shard_imbalance_report(st) == jh.shard_imbalance_report(st)
    wal = SimpleNamespace(batches=[1, 2], tail=[3], path="wal.jsonl")
    j_inj, p_inj = _injectors()
    assert ph.chaos_report(p_inj, st, wal) == jh.chaos_report(j_inj, st,
                                                              wal)
    assert ph.chaos_report(None, st) == jh.chaos_report(None, st)
    assert ph.chaos_report() == jh.chaos_report() == {}


def test_main_prints_the_references_json(tmp_path, monkeypatch, replays):
    """``main`` on the same generator file and rangespec: the same JSON
    (but for the host's wall, CPU and memory figures), the same
    ``RANGESPEC FAIL`` lines and the same exit code.  The port's main
    runs on the card; here its replay is pointed at the CPU."""
    config = tmp_path / "small.yaml"
    config.write_text(yaml.safe_dump(SMALL_CONFIG))
    spec = tmp_path / "spec.yaml"
    spec.write_text(yaml.safe_dump({
        "clusterQueueClassesMinUsage": {"cq": 101},
        "wlClassesMaxAvgTimeToAdmissionMs": {"large": -1, "medium": 1e9,
                                             "missing": 1}}))
    cpu_replay = ph.run_scenario
    monkeypatch.setattr(ph, "run_scenario",
                        lambda cfg: cpu_replay(cfg, device="cpu"))
    outs = []
    for mod in (jh, ph):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = mod.main([str(config), str(spec)])
        body = json.loads(out.getvalue())
        for k in ("wall_ms", "cpu_mcpu", "cpu_mcpu_replay", "maxrss_kb"):
            assert isinstance(body.pop(k), (int, float)), k
        outs.append((rc, body, err.getvalue().splitlines()))
    assert outs[1] == outs[0]
    rc, body, fails = outs[1]
    assert rc == 1 and len(fails) == 3
    assert all(f.startswith("RANGESPEC FAIL: ") for f in fails)
    assert body["finished"] == body["workloads"] == 180


def test_require_accel_or_die(monkeypatch):
    """Without a card the check exits as the JAX one does; with one it
    passes.  Either way it exports KUEUE_TPU_REQUIRE_ACCEL=1 (restored
    here)."""
    monkeypatch.setenv("KUEUE_TPU_REQUIRE_ACCEL", "0")
    if torch.cuda.is_available():
        ph.require_accel_or_die()
    else:
        with pytest.raises(SystemExit) as got:
            ph.require_accel_or_die()
        with pytest.raises(SystemExit) as want:
            jh.require_accel_or_die()
        prefix = "--require-accel: no accelerator platform reachable"
        assert str(got.value).startswith(prefix)
        assert str(want.value).startswith(prefix)
    assert os.environ["KUEUE_TPU_REQUIRE_ACCEL"] == "1"


# the edits JAX and the device force, as (reference text, port text)
HARNESS_EDITS = [
    ("Run: ``python -m kueue_tpu.perf.harness <generator.yaml> "
     "[rangespec.yaml]``\n",
     "Run: ``python -m kueue_tpu_torch.perf.harness <generator.yaml> "
     "[rangespec.yaml]``\n(on the CUDA card; ``run_scenario(..., "
     "device=\"cpu\")`` replays on the\nCPU with the kernels' plain "
     "versions)\n"),
    ("def run_scenario(config: list[dict], driver: Driver | None = None)"
     " -> PerfStats:\n",
     "def run_scenario(config: list[dict], driver: Driver | None = None, "
     "*,\n                 device: str = \"cuda\") -> PerfStats:\n"),
    ("    d = driver or Driver(clock=clock)\n",
     "    d = driver or Driver(clock=clock, device=device)\n"),
    ("    import jax\n"
     "    accel = [dev for dev in jax.devices() if dev.platform != "
     "\"cpu\"]\n",
     "    import torch\n"
     "    accel = torch.cuda.device_count() if torch.cuda.is_available() "
     "else 0\n"),
    ("            f\"(devices: {[dev.platform for dev in jax.devices()]})\")"
     "\n    print(f\"require-accel: {len(accel)} {accel[0].platform} "
     "device(s)\",\n",
     "            \"(devices: ['cpu'])\")\n"
     "    print(f\"require-accel: {accel} cuda device(s)\",\n"),
]


def test_harness_differs_only_in_the_listed_edits():
    with open(os.path.join(ROOT, "kueue_tpu", "perf", "harness.py")) as f:
        ref = f.read()
    with open(os.path.join(ROOT, "kueue_tpu_torch", "perf",
                           "harness.py")) as f:
        port = f.read()
    for jax_text, port_text in HARNESS_EDITS:
        assert ref.count(jax_text) == 1 and port.count(port_text) == 1
        port = port.replace(port_text, jax_text)
    assert port == ref
    assert not re.search(r"\bjax\b", port.replace(
        "kueue_tpu.perf", "").replace("import jax", "").replace(
        "jax.devices", ""))


def test_harness_in_a_fresh_process():
    """The harness's CPU replay loads neither jax nor kueue_tpu; its
    command line runs on the card, so without one it fails."""
    code = (
        "import json, sys\n"
        "from kueue_tpu_torch.perf import run_scenario\n"
        f"s = run_scenario(json.loads({json.dumps(SMALL_CONFIG)!r}), "
        "device='cpu')\n"
        "assert s.finished == s.total_workloads == 180, s\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kueue_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "kueue_tpu_torch.perf.harness",
             os.path.join(ROOT, "perf", "default_generator_config.yaml")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "no CUDA GPU" in out.stderr
