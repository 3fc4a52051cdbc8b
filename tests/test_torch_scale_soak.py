"""The port's scale soak (``python -m kueue_tpu_torch.scale_soak``) against
the JAX package's ``scripts/scale_soak.py`` on the CPU, at small sizes:

- ``pack_curve_point`` at 32 CQs: the same rows, live and row-backed
  rows, streaming pack counters, bytes to the device, and byte-identical
  stream / rebuild planes;
- ``e2e_arm`` at 32 CQs, each of the four arms (stream, rebuild, nobulk,
  classic): the script's per-cycle decisions, identical across the
  port's arms, and its pack counters;
- ``ceiling_probe`` at 128 CQs with 2 preempting cohorts: the same live,
  budget, grid and row-backed rows and the round's admissions;
- ``host_pool_arm`` serial and with 4 workers at 32 CQs, and ``soak`` of
  2,000 workloads at 128 CQs: the same decisions and counts;
- the twin's tail passes the validator's checks (the host-pool speedup
  gate is a timing gate and not asserted here).

Tolerance 0: counts, flags and decision lists; no timing field is
compared.  ``burst_launch_bytes_h2d`` is not compared for equality: the
port uploads a plan's static planes once per plan (a chained window
reuses them) where the JAX package counts them at every launch, so the
port's count is at most the script's.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from kueue_tpu_torch import scale_soak as tss
from kueue_tpu_torch.perf.validate import validate_tail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1307
N = 32
ARMS = ("stream", "rebuild", "nobulk", "classic")
CURVE_KEYS = ("cqs", "rows", "live_rows", "rows_row_backed",
              "agg_rows_compressed", "agg_max_res_ts_equal", "boundaries",
              "planes_identical", "bytes_to_device_raw", "bytes_to_device",
              "stream_packs", "stream_full_packs", "pack_rank_patches",
              "arena_bytes")
CEILING_KEYS = ("cqs", "active_cqs_pending", "preempt_cohorts", "row_budget",
                "live_rows", "rows_packed", "rows_grid", "rows_row_backed",
                "rows_budget_row_backed", "packed_under_budget",
                "row_backed_over_budget")
SOAK_KEYS = ("cqs", "target_workloads", "created", "admitted", "finished",
             "rounds", "completed")
POOL_GATE = "'host_pool.apply_pack_speedup'="


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load("scale_soak_under_test", "scripts/scale_soak.py")


def _pack_counts(block: dict) -> dict:
    """The pack counters that count (no seconds, no bytes uploaded)."""
    return {k: v for k, v in block.items() if isinstance(v, int)
            and not isinstance(v, bool) and k != "burst_launch_bytes_h2d"}


def test_pack_curve_point_matches_the_script(ref):
    want = ref.pack_curve_point(N, 3, 8, SEED)
    got = tss.pack_curve_point(N, 3, 8, SEED, device="cpu")
    for k in CURVE_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["planes_identical"] is True
    assert got["agg_max_res_ts_equal"] is True
    assert got["stream_packs"] > 0


@pytest.fixture(scope="module")
def stream_arm():
    return tss.e2e_arm("stream", N, 2, N, SEED, per_cq=4, device="cpu")


@pytest.mark.parametrize("arm", ARMS)
def test_e2e_arm_matches_the_script(ref, stream_arm, arm):
    """One end-to-end arm on both packages: the script's decisions cycle
    by cycle, the port's stream arm's decisions, the same pack counters."""
    want = ref.e2e_arm(arm, N, 2, N, SEED, per_cq=4)
    got = (stream_arm if arm == "stream"
           else tss.e2e_arm(arm, N, 2, N, SEED, per_cq=4, device="cpu"))
    assert got["arm"] == arm
    assert got["n_cycles"] == want["n_cycles"] > 0
    assert got["decisions"] == [tuple(c) for c in want["decisions"]]
    assert got["decisions"] == stream_arm["decisions"]
    assert any(c[0] for c in got["decisions"])
    assert _pack_counts(got["pack"]) == _pack_counts(want["pack"])
    assert 0 < got["bytes_h2d"] <= want["bytes_h2d"]


def test_ceiling_probe_matches_the_script(ref):
    want = ref.ceiling_probe(4 * N, 2, SEED)
    got = tss.ceiling_probe(4 * N, 2, SEED, device="cpu")
    for k in CEILING_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert {k: got["round"][k] for k in ("arrivals", "admitted", "retired")} \
        == {k: want["round"][k] for k in ("arrivals", "admitted", "retired")}
    # the head pack charges only the preempting cohorts' rows
    assert got["rows_packed"] < got["rows_grid"] <= got["rows_row_backed"]


@pytest.mark.parametrize("workers", [0, 4])
def test_host_pool_arm_matches_the_script(ref, tmp_path, workers):
    want = ref.host_pool_arm(workers, N, 2, SEED, str(tmp_path / "ref"))
    got = tss.host_pool_arm(workers, N, 2, SEED, str(tmp_path / "port"),
                            device="cpu")
    assert got["decisions"] == [tuple(c) for c in want["decisions"]]
    for k in ("workers", "n_cycles", "wal_appenders", "wal_commits"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["pool_stats"] == want["pool_stats"]


def test_soak_matches_the_script(ref, tmp_path):
    want = ref.soak(4 * N, 2000, SEED, str(tmp_path / "ref.jsonl"), 64, 4)
    got = tss.soak(4 * N, 2000, SEED, str(tmp_path / "port.jsonl"), 64, 4,
                   device="cpu")
    for k in SOAK_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["completed"] is True and got["admitted"] == 2000
    for k in ("wal_commits", "wal_compactions", "layout", "commit_every"):
        assert got["wal"].get(k) == want["wal"].get(k), k
    assert _pack_counts(got["pack_counters"]) == _pack_counts(
        want["pack_counters"])


def test_tail_passes_the_validator(tmp_path, capsys, monkeypatch):
    """A small whole run: the script's tail keys, parity at every size,
    and the SCALE_r19 checks (all but the host-pool speedup gate, a
    timing gate); the four arms' and the pool arms' digests recorded."""
    out = str(tmp_path / "SCALE_r99.json")
    record = {}
    run = tss.run
    monkeypatch.setattr(tss, "run", lambda args: run(args, record))
    rc = tss.main(["--quick", "--sizes", "16", "--ceiling-cqs", "32",
                   "--preempt-cohorts", "2", "--soak-workloads", "200",
                   "--rounds", "1", "--pool-rounds", "1",
                   "--torch-device", "cpu", "--out", out])
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        d = json.load(f)
    assert last == d
    keys = {"metric", "unit", "value", "cqs", "host_apply_speedup_at_max_cqs",
            "pack_speedup_at_max_cqs", "seed", "quick", "mesh", "sizes",
            "curve", "parity", "ceiling", "head_pack", "host_pool",
            "aggregate", "heap", "wal_shard", "soak", "residues", "control",
            "environment_drift", "wall_s_total"}
    assert set(d) == keys
    assert all(d["parity"].values()), d["parity"]
    assert d["soak"]["completed"] and d["ceiling"]["packed_under_budget"]
    assert set(record) == {(16, a) for a in ARMS} | {("pool", 0),
                                                     ("pool", 4)}
    assert len({record[(16, a)] for a in ARMS}) == 1
    assert record[("pool", 0)] == record[("pool", 4)]
    validator = _load("validate_artifacts_under_test",
                      "scripts/validate_artifacts.py")
    assert [e for e in validator.validate(out) if POOL_GATE not in e] == []
    assert [e for e in validate_tail(d, "SCALE_r19.json")
            if POOL_GATE not in e] == []


def test_main_raises_without_a_gpu():
    assert tss.parser().get_default("out") is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match="no CUDA GPU"):
        tss.main(["--quick"])
    assert buf.getvalue() == ""
