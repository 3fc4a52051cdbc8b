"""``python -m kueue_tpu_torch.accel_roofline``, the port's twin of
``scripts/accel_roofline.py``, on the CPU: its ``--quick`` tail has the
script's keys with no ``accel`` column, no ``tunnel`` and no
``crossover``; its scan fixture is the script's; the outputs it measures
equal the JAX ``admit_scan`` / ``admit_scan_forests`` / ``burst_probe``
outputs (tolerance 0), the native loop's equal the plain version's; the
crossover's conclusion follows from the numbers it is given.  No timing
is compared.  The quick run takes ~25 s here, most of it the plain
versions."""

from __future__ import annotations

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from kueue_tpu_torch import accel_roofline as twin

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NORTHSTAR = ("northstar_100k_x_1k", 1000, 128, 1)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "accel_roofline_under_test",
        os.path.join(ROOT, "scripts", "accel_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quick():
    rec: dict = {}
    tail = twin.run(twin.parser().parse_args(["--quick", "--torch-device",
                                              "cpu"]), rec)
    return tail, rec


def test_quick_tail_has_the_scripts_keys(quick):
    tail, rec = quick
    assert sorted(tail) == ["accel_platform", "fused_burst", "metric",
                            "note", "per_dispatch_admit_scan"]
    assert tail["metric"] == "accel_roofline"
    assert tail["accel_platform"] is None
    assert [r["heads"] for r in tail["per_dispatch_admit_scan"]] == [1024,
                                                                     8192]
    for r in tail["per_dispatch_admit_scan"]:
        assert sorted(r) == ["cpu_flat_ms", "cpu_forest_ms", "heads",
                             "native_flat_ms"]
    b, = tail["fused_burst"]
    assert sorted(b) == sorted([
        "shape", "cqs", "pending_per_cq", "resources", "workloads",
        "cpu_total_k64_ms", "cpu_per_cycle_incremental_ms",
        "cpu_per_cycle_amortized_k64_ms"])
    assert (b["shape"], b["cqs"], b["workloads"]) == (
        "northstar_100k_x_1k", 1000, 128_000)
    assert twin.decided(tail) == {"accel_platform": None,
                                  "heads": [1024, 8192],
                                  "shapes": ["northstar_100k_x_1k"],
                                  "crossover": False}
    assert len(rec) == 2 * 3 + 2


def test_native_column_equals_the_plain_version(quick):
    """The roofline's CPU column is the plain versions; the native loop
    (``native.admit_scan_raw``) beside it decides the same heads."""
    _tail, rec = quick
    assert twin.check(rec) == []
    for W in (1024, 8192):
        assert rec[f"native:flat:{W}"] == rec[f"cpu:flat:{W}"]


@pytest.mark.parametrize("W", [1024, 8192, 65536])
def test_scan_fixture_is_the_scripts(script, W):
    args, fon, cohorts = twin._scan_fixture(W)
    ref_args, ref_fon, ref_cohorts = script._scan_fixture(W)
    assert list(args) == list(ref_args) and cohorts == ref_cohorts
    for k in args:
        assert args[k].dtype == ref_args[k].dtype, k
        np.testing.assert_array_equal(args[k], ref_args[k], err_msg=k)
    np.testing.assert_array_equal(fon, ref_fon)


def test_scans_equal_the_jax_scans(script, quick):
    """W = 1,024: the flat and forest scans of the twin on "cpu" against
    the JAX functions on the script's fixture, array and digest."""
    from kueue_tpu.ops.cycle import admit_scan, admit_scan_forests
    _tail, rec = quick
    args, fon, n_forests = script._scan_fixture(1024)
    a = tuple(args.values())
    want = {
        "flat": np.asarray(admit_scan(*a, depth=2)),
        "forest": np.asarray(admit_scan_forests(
            *a, fon, depth=2, n_forests=n_forests,
            max_forest_wl=max(4, 1024 // n_forests * 2))),
    }
    for part, fn in twin.scan_calls(1024, CPU).items():
        got = twin._fetch(fn())
        assert got.dtype == want[part].dtype == np.bool_
        np.testing.assert_array_equal(got, want[part], err_msg=part)
        assert rec[f"cpu:{part}:1024"] == twin.outputs_digest(want[part])


def test_burst_equals_the_jax_burst(quick):
    """The north-star burst shape at K = 16: every output of the port's
    ``burst_probe`` on "cpu" equals the JAX one's (its uint32 word plane
    as the int32 the port carries), and the run's digest is theirs."""
    from kueue_tpu.ops.burst import burst_probe as jax_burst_probe

    from kueue_tpu_torch.ops.burst import burst_probe
    _tail, rec = quick
    _label, C, M, R = NORTHSTAR
    want = jax.device_get(jax_burst_probe(C, M, R, 16))
    got = twin._fetch(burst_probe(C, M, R, 16, device="cpu"))

    def flat(x):
        return ([a for y in x for a in flat(y)]
                if isinstance(x, (tuple, list)) else [np.asarray(x)])
    w, g = flat(want), flat(got)
    assert len(w) == len(g) == 16
    for i, (a, b) in enumerate(zip(w, g)):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert rec["cpu:burst_k16:northstar_100k_x_1k"] == \
        twin.outputs_digest(want)


def test_round_trip_keeps_four_decimals():
    """The tail's ms carry 4 decimals where the script's carry 2: a
    round trip of microseconds stays nonzero."""
    assert twin._ms(4.3e-6) == 0.0043
    assert round(4.3e-6 * 1e3, 2) == 0.0
    t = twin.measure_rtt(CPU, 3)
    assert sorted(t) == ["dispatch_4mb_ms", "effective_upload_mbps",
                         "rtt_ms"]
    assert t["rtt_ms"] > 0


def _out(c_accel, c_cpu, native, flat, forest, rtt=0.05):
    return {
        "tunnel": {"rtt_ms": rtt},
        "per_dispatch_admit_scan": [
            {"heads": W, "native_flat_ms": n, "accel_flat_ms": f,
             "accel_forest_ms": fo}
            for W, n, f, fo in zip((1024, 8192), native, flat, forest)],
        "fused_burst": [{"shape": "northstar_100k_x_1k",
                         "accel_per_cycle_incremental_ms": c_accel,
                         "cpu_per_cycle_incremental_ms": c_cpu}],
    }


def test_crossover_conclusion_follows_the_numbers():
    """The script's model on given numbers: min K = ceil(RTT / (c_cpu -
    c_accel)); the conclusion names the numbers and the native loop's
    verdict at each W, and none of the script's XLA / MXU / tunnel
    text."""
    c = twin.crossover(_out(0.01, 26.0, (0.08, 0.15), (0.3, 0.1),
                            (0.4, 0.2)))
    assert c["accel_can_win_at_any_K"] is True
    assert c["min_K_if_winnable"] == 1
    assert c["native"][0]["accel_flat_wins"] is False
    assert c["native"][1]["accel_flat_wins"] is True
    assert "W = [8192]" in c["conclusion"]
    assert "loses to it at W = [1024]" in c["conclusion"]
    assert "K >= 1" in c["conclusion"]
    c = twin.crossover(_out(30.0, 26.0, (0.08, 0.15), (0.3, 0.4),
                            (0.4, 0.5)))
    assert c["accel_can_win_at_any_K"] is False
    assert c["min_K_if_winnable"] is None
    assert "no K makes a launch pay" in c["conclusion"]
    assert "loses to the compiled host loop at W = [1024, 8192]" in \
        c["conclusion"]
    for word in ("XLA", "MXU", "tunnel", "router"):
        assert word not in c["conclusion"]
    assert twin.crossover(_out(1.0, 1.5, (1, 1), (1, 1), (1, 1),
                               rtt=2.0))["min_K_if_winnable"] == 4
