"""The forest-sharded fused burst of the port against the JAX package, on
the CPU.  The JAX side shards over the conftest's 8 virtual XLA CPU
devices; the port shards over its virtual CPU mesh
(``kueue_tpu_torch.parallel.sharded.virtual_mesh("cpu", 8)``, set here
for every test of this file), one plain ``burst_cycles`` per shard and
the plain dirty-flag reduction.

- ``BurstShardLayout``: equal fields on the same plan for 2, 3 and 8
  shards, with and without a measured forest cost;
- the two kernels' plain versions: ``scatter_rows_plain`` against the
  JAX ``_scatter_rows_fn`` (padded duplicate rows included) and
  ``reduce_dflags_plain`` against a ``psum`` under ``shard_map``;
- one sharded window against the JAX sharded window on the same plan;
- twins of tests/test_multichip_parity.py (8 shards against serial,
  admit and preempt; resident multi-window; 8 → 4 degradation; cost
  rebalance; the mesh below two devices; the env switch) and of
  tests/test_sharded_parity.py (2-shard resident; the kill switch):
  every record of the port's sharded burst equal to the JAX package's
  serial burst and host drain.

Tolerance: exact, dtypes asserted (every value is an integer or a
bool)."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kueue_tpu.ops import burst as jburst
from kueue_tpu.parallel import sharded as jsh
from kueue_tpu_torch import scenarios
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import burst as tburst
from kueue_tpu_torch.parallel import sharded as tsh

from test_torch_burst import _packed
from test_torch_burst_driver import (Clock, cluster, make_driver, mk,
                                     pre_any, records, types_of)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_mesh():
    with tsh.virtual_mesh("cpu", 8):
        yield


def _same(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (label, a.dtype, b.dtype)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    assert np.array_equal(a, b), label


# -- the layout ---------------------------------------------------------

@pytest.mark.parametrize("cost", [False, True], ids=["count", "cost"])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
@pytest.mark.parametrize("name", ["wave", "drain"])
def test_layout_fields_match_jax(name, n_shards, cost):
    """Both packages' layouts of the same plan (the JAX package's)."""
    plan, _ = _packed("kueue_tpu", name)
    fc = (np.arange(plan.G, dtype=np.float64)[::-1] * 1.5 + 0.25
          if cost else None)
    jl = jsh.BurstShardLayout(plan, n_shards, forest_cost=fc)
    tl = tsh.BurstShardLayout(plan, n_shards, forest_cost=fc)
    jf = tt.layout_fields(jl, plan)
    tf = tt.layout_fields(tl, plan)
    assert jf.keys() == tf.keys()
    for k in jf:
        if isinstance(jf[k], np.ndarray):
            _same(jf[k], tf[k], k)
        else:
            assert jf[k] == tf[k], k
    assert tf["cost_balanced"] == cost


# -- the two kernels' plain versions ------------------------------------

@pytest.mark.parametrize("seed,D", [(0, 1), (1, 3), (2, 9), (3, 12)])
def test_scatter_rows_plain_matches_jax(seed, D):
    planes, rows, vals = tt.scatter_case(seed, D=D)
    assert len(rows) > D, len(rows)      # padded duplicate rows
    fn = jburst.BurstSolver(backend="cpu")._scatter_rows_fn()
    want = jax.device_get(fn(tuple(jnp.asarray(p) for p in planes),
                             jnp.asarray(rows),
                             tuple(jnp.asarray(v) for v in vals)))
    got = tsh.scatter_rows(
        [torch.from_numpy(p.copy()) for p in planes],
        torch.from_numpy(rows), [torch.from_numpy(v) for v in vals])
    assert len(got) == len(want) == 13
    for name, w, g in zip(tsh.SCATTER_PLANES, want, got):
        _same(w, g.numpy(), name)


@pytest.mark.parametrize("S,K", [(2, 32), (3, 8), (8, 32)])
def test_reduce_dflags_plain_matches_jax(S, K):
    try:
        from jax import shard_map
    except ImportError:     # older JAX
        from jax.experimental.shard_map import shard_map
    blocks = tt.dflags_blocks(S, K)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("cq",))
    psum = jax.jit(shard_map(lambda x: jax.lax.psum(x, "cq"), mesh=mesh,
                             in_specs=P("cq"), out_specs=P()))
    want = np.asarray(psum(jnp.asarray(blocks.reshape(S * K, 4))))
    got = tsh.reduce_dflags(torch.from_numpy(blocks))
    _same(want, got.numpy(), "dflags")
    dirty, reason = tburst.dirty_flags(got)
    _same(want[:, 0] > 0, dirty.numpy(), "dirty")
    assert reason.dtype == torch.int32


# -- one sharded window on the same plan ---------------------------------

@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("name", ["wave", "sustained"])
def test_sharded_window_matches_jax(name, n_shards):
    """BurstSolver.run over the same packed plan (the JAX package's, its
    numpy arrays read by both): the JAX solver on its mesh of virtual
    XLA devices, the port on its virtual CPU mesh — the seven decision
    planes and the final u_cq, in global layout."""
    jplan, runtime = _packed("kueue_tpu", name)
    tplan, _ = _packed("kueue_tpu", name)
    js = jburst.BurstSolver(backend="cpu")
    js.set_shards(n_shards)
    ts = tburst.BurstSolver(device="cpu")
    ts.set_shards(n_shards)
    assert js.n_shards == ts.n_shards == n_shards
    K = 32
    F = jplan.arrays["u_cq0"].shape[1]
    extr = np.zeros((K, jplan.C, F), np.int32)
    extu = np.zeros((K, jplan.G), bool)
    want = js.run(jplan, K, runtime, extr, extu)
    got = ts.run(tplan, K, runtime, extr, extu)
    for i, (w, g) in enumerate(zip(want, got)):
        _same(w, g, i)
    assert ts.stats["burst_sharded_dispatches"] == 1
    assert len(ts.stats["burst_shard_fetch_s"]) == n_shards


# -- driver twins ----------------------------------------------------------

def _arrive(d, inject, k):
    """Create the workloads that ``inject`` puts at cycle ``k`` (one, or
    a list)."""
    if inject and k in inject:
        wl = inject[k](types_of(type(d).__module__.split(".")[0]))
        for w in wl if isinstance(wl, list) else [wl]:
            d.create_workload(w)


def _burst(d, clock, cycles, runtime, inject=None, pipeline=True):
    def on_cycle_start(k):
        _arrive(d, inject, k)
        clock.t += 1.0
    return d.schedule_burst(cycles, runtime=runtime,
                            on_cycle_start=on_cycle_start,
                            pipeline=pipeline)


def _host(d, clock, cycles, runtime, inject=None):
    out = []
    for c in range(cycles):
        _arrive(d, inject, c)
        clock.t += 1.0
        out.append(d.schedule_once())
        if runtime > 0 and c - runtime >= 0:
            for key in out[c - runtime].admitted:
                wl = d.workloads.get(key)
                if wl is not None and wl.has_quota_reservation:
                    d.finish_workload(key)
    return out


def sc_sustained(per_cq=36):
    return lambda t, d, clock: scenarios.sustained_spec(t, d, per_cq)


def sc_preempt(t, d, clock):
    cluster(t, d, n_cohorts=2, cqs=2, nominal=4000, borrowing=4000,
            preemption=pre_any(t))
    n = 0
    for c in range(2):
        for q in range(2):
            for i in range(6):
                n += 1
                d.create_workload(mk(t, f"w-{c}-{q}-{i}", f"lq-{c}-{q}",
                                     2000, prio=10, ts=float(n)))


def sc_four_cohorts(t, d, clock):
    cluster(t, d, n_cohorts=4, cqs=2, nominal=4000)
    n = 0
    for c in range(4):
        for q in range(2):
            for i in range(8):
                n += 1
                d.create_workload(mk(t, f"w-{c}-{q}-{i}", f"lq-{c}-{q}",
                                     2000, prio=(i % 3) * 10,
                                     ts=float(n)))


def sc_wide(t, d, clock):
    scenarios.northstar_resident_spec(t, d, n_cqs=50)


BOSS = {36: lambda t: mk(t, "boss", "lq-0-0", 4000, prio=100, ts=500.0)}
HI = {6: lambda t: mk(t, "hi-a", "lq-0-0", 4000, prio=100, ts=100.0),
      9: lambda t: mk(t, "hi-b", "lq-1-1", 4000, prio=100, ts=101.0)}
WIDE = {36: lambda t: scenarios.northstar_arrivals(t, 50, 2)}


def _drivers(scenario):
    out = {}
    for label, pkg in (("host", "kueue_tpu"), ("serial", "kueue_tpu"),
                       ("shard", "kueue_tpu_torch")):
        clock = Clock()
        d = make_driver(pkg, clock)
        scenario(types_of(pkg), d, clock)
        out[label] = (d, clock)
    return out


def _port_shards(d, n):
    bs = tburst.BurstSolver(device="cpu")
    if n > 1:
        bs.set_shards(n)
        assert bs.n_shards == n, bs.n_shards
    d._burst_solver = bs
    return bs


def _assert_parity(runs, results):
    host, serial, shard = (results[k] for k in ("host", "serial", "shard"))
    assert len(serial) == len(shard)
    assert records(shard) == records(serial)
    assert records(shard) == records(host[:len(shard)])
    keys = {k: sorted(runs[k][0].admitted_keys()) for k in runs}
    assert keys["shard"] == keys["serial"] == keys["host"]


CASES = {
    # name: (scenario, cycles, runtime, inject, shards)
    "admit-8": (sc_sustained(), 80, 2, None, 8),
    "preempt-8": (sc_preempt, 40, 3, HI, 8),
    "resident-8": (sc_sustained(), 80, 2, BOSS, 8),
    "resident-2": (sc_sustained(), 80, 2, BOSS, 2),
    # the north-star-width drain of chip_smoke at 50 CQs: every window
    # boundary after the first is a delta pack served by the resident
    # copy, the arrivals reclaim quota (preemption)
    "resident-wide-4": (sc_wide, 80, 30, WIDE, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_burst_matches_jax_serial_and_host(case, monkeypatch):
    """tests/test_multichip_parity.py :45 (admit), :66 (preempt), :148
    (resident multi-window, 8 shards) and tests/test_sharded_parity.py
    :180 (resident, 2 shards), on the port; and chip_smoke's resident
    drain at north-star width, cut to 50 CQs."""
    scenario, cycles, runtime, inject, n = CASES[case]
    if case.startswith("resident"):
        monkeypatch.setenv("KUEUE_TPU_RESIDENT_VERIFY", "1")
    runs = _drivers(scenario)
    (dh, ch), (ds, cs), (dp, cp) = (runs[k] for k in ("host", "serial",
                                                      "shard"))
    bs = _port_shards(dp, n)
    results = {"host": _host(dh, ch, cycles, runtime, inject),
               "serial": _burst(ds, cs, cycles, runtime, inject),
               "shard": _burst(dp, cp, cycles, runtime, inject)}
    _assert_parity(runs, results)
    st = bs.stats
    assert st["burst_sharded_dispatches"] >= 1, st
    assert len(st["burst_shard_pack_s"]) == n
    assert len(st["burst_shard_fetch_s"]) == n
    if case in ("preempt-8", "resident-wide-4"):
        assert any(s.preempted_targets for s in results["shard"])
    if case.startswith("resident"):
        assert st["burst_resident_hits"] >= 1, st
        assert st["burst_resident_scatter_rows"] >= 1, st
        assert 1 <= st["burst_resident_scatter_ranges"] \
            <= st["burst_resident_scatter_rows"], st
        assert st["burst_boundary_bytes_h2d"] \
            < st["burst_boundary_bytes_equiv"], st


def test_old_plan_relaunch_after_resident_hit(monkeypatch):
    """The resident scatter writes the planes in place; the plan that
    owned them launches again after a hit from its own rows (as the JAX
    package's functional ``.at[].set`` leaves them), not the next
    plan's — its decisions equal a serial solver's on that plan."""
    monkeypatch.setenv("KUEUE_TPU_RESIDENT_VERIFY", "1")
    runs = _drivers(sc_sustained())
    dp, cp = runs["shard"]
    bs = _port_shards(dp, 8)
    fresh = []
    dispatch = bs.dispatch

    def recording(plan, K, runtime, extr, extu):
        fresh.append((plan, K, runtime, extr.copy(), extu.copy()))
        return dispatch(plan, K, runtime, extr, extu)
    monkeypatch.setattr(bs, "dispatch", recording)
    _burst(dp, cp, 80, 2, BOSS)
    assert bs.stats["burst_resident_hits"] >= 1, bs.stats
    hits = [i for i in range(1, len(fresh))
            if fresh[i][0].prev_token is not None
            and fresh[i][0].prev_token == fresh[i - 1][0].pack_token
            and fresh[i][0].dirty_cqs is not None
            and len(fresh[i][0].dirty_cqs)]
    assert hits, [(p.prev_token, p.pack_token) for p, *_ in fresh]
    old = fresh[hits[0] - 1]
    assert getattr(old[0], "_resident_args", None) is None
    want = tburst.BurstSolver(device="cpu").run(*old)
    got = bs.run(*old)
    for i, (w, g) in enumerate(zip(want, got)):
        _same(w, g, i)


def test_degradation_8_to_4_matches_jax(monkeypatch):
    """tests/test_multichip_parity.py :182: lose_devices(4) mid-run drops
    the resident copy; the next fresh pack re-gathers over 4 shards."""
    monkeypatch.setenv("KUEUE_TPU_RESIDENT_VERIFY", "1")
    runs = _drivers(sc_sustained())
    (dh, ch), (ds, cs), (dp, cp) = (runs[k] for k in ("host", "serial",
                                                      "shard"))
    bs = _port_shards(dp, 8)
    host = _host(dh, ch, 40, 2) + _host(dh, ch, 40, 2)
    serial = _burst(ds, cs, 40, 2) + _burst(ds, cs, 40, 2)
    first = _burst(dp, cp, 40, 2)
    assert bs.lose_devices(4) == 4
    assert bs._resident is None
    shard = first + _burst(dp, cp, 40, 2)
    _assert_parity(runs, {"host": host, "serial": serial, "shard": shard})
    st = bs.stats
    assert st["burst_shard_degradations"] == 1, st
    assert bs.n_shards == 4
    assert len(st["burst_shard_fetch_s"]) == 4
    assert st["burst_resident_misses"] >= 1, st


def test_cost_rebalance_matches_jax(monkeypatch):
    """tests/test_multichip_parity.py :217: a seeded cycle-cost EWMA
    drives the LPT; decisions stay equal to the count-based serial run."""
    monkeypatch.setenv("KUEUE_TPU_RESIDENT_VERIFY", "1")
    runs = _drivers(sc_four_cohorts)
    (dh, ch), (ds, cs), (dp, cp) = (runs[k] for k in ("host", "serial",
                                                      "shard"))
    bs = _port_shards(dp, 8)
    bs._forest_cost = {"generation": dp.cache.structure_generation,
                       "ewma": np.array([8.0, 1.0, 1.0, 1.0]),
                       "windows": 5}
    results = {"host": _host(dh, ch, 60, 2), "serial": _burst(ds, cs, 60, 2),
               "shard": _burst(dp, cp, 60, 2)}
    _assert_parity(runs, results)
    st = bs.stats
    assert st["burst_layout_cost_balanced"] >= 1, st
    assert st["burst_shard_cost_ratio"] >= 1.0, st
    assert len(st.get("burst_shard_cost", [])) == 8, st


def test_kill_switch_matches_jax(monkeypatch):
    """tests/test_sharded_parity.py :210: KUEUE_TPU_RESIDENT=0 keeps the
    host-permute boundary: no hits, no misses, decisions unchanged."""
    monkeypatch.setenv("KUEUE_TPU_RESIDENT", "0")
    runs = _drivers(sc_sustained(per_cq=20))
    (dh, ch), (ds, cs), (dp, cp) = (runs[k] for k in ("host", "serial",
                                                      "shard"))
    bs = _port_shards(dp, 2)
    results = {"host": _host(dh, ch, 60, 2), "serial": _burst(ds, cs, 60, 2),
               "shard": _burst(dp, cp, 60, 2)}
    _assert_parity(runs, results)
    st = bs.stats
    assert st["burst_sharded_dispatches"] >= 1, st
    assert st["burst_resident_hits"] == 0, st
    assert st["burst_resident_misses"] == 0, st


def env_burst(pkg):
    """The sustained drain (18 per CQ, 40 cycles of the burst) on a Driver
    of ``pkg`` built under KUEUE_TPU_SHARDS=8 → (driver, records)."""
    prev = os.environ.get("KUEUE_TPU_SHARDS")
    os.environ["KUEUE_TPU_SHARDS"] = "8"     # read again by schedule_burst
    try:
        clock = Clock()
        d = make_driver(pkg, clock)
        sc_sustained(per_cq=18)(types_of(pkg), d, clock)
        return d, records(_burst(d, clock, 40, 2))
    finally:
        if prev is None:
            del os.environ["KUEUE_TPU_SHARDS"]
        else:
            os.environ["KUEUE_TPU_SHARDS"] = prev


def test_env_switch_shards_the_burst():
    """KUEUE_TPU_SHARDS=8: the port's Driver constructs with its
    per-cycle mesh set ({"wl": 4, "cq": 2}), schedule_burst shards over
    the burst mesh, and the records (per-cycle fallbacks on the mesh)
    equal the JAX package's serial burst here, and the JAX mesh Driver's
    under the same switch in a fresh process
    (tests/test_torch_mesh_driver.py, scenario "env_burst": a JAX mesh
    program can deadlock XLA:CPU for the programs after it in one
    process)."""
    de, env = env_burst("kueue_tpu_torch")
    clock_s = Clock()
    ds = make_driver("kueue_tpu", clock_s)
    sc_sustained(per_cq=18)(types_of("kueue_tpu"), ds, clock_s)
    assert env == records(_burst(ds, clock_s, 40, 2))
    assert de._burst_solver.n_shards == 8
    assert de._burst_solver.stats["burst_sharded_dispatches"] >= 1
    assert de.scheduler.solver.mesh.shape == {"wl": 4, "cq": 2}


def test_mesh_degrades_below_two_devices():
    """tests/test_multichip_parity.py :257: make_burst_mesh(1) is None
    and set_shards(1) keeps the serial path; more shards than (virtual)
    devices stay serial too."""
    assert tsh.make_burst_mesh(1) is None
    assert tsh.make_burst_mesh(0) is None
    bs = tburst.BurstSolver(device="cpu")
    bs.set_shards(1)
    assert bs.n_shards == 1
    assert bs._shard_mesh is None
    bs.set_shards(10 ** 6)
    assert bs.n_shards == 1
    mesh = tsh.make_burst_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.axis_names == ("cq",)
    assert set(mesh.devices) == {torch.device("cpu")}


def test_chaos_device_loss_cascade_matches_jax():
    """tests/test_chaos_recovery.py :405 on the port: chaos drops 4
    devices at the first fresh window and 3 more at the second
    (``shard.device_loss``); the burst re-partitions over the survivors,
    then runs serial — records equal to the JAX serial burst and host
    drain throughout."""
    from kueue_tpu_torch import chaos
    runs = _drivers(sc_sustained())
    (dh, ch), (ds, cs), (dp, cp) = (runs[k] for k in ("host", "serial",
                                                      "shard"))
    bs = _port_shards(dp, 8)
    inj = chaos.install(chaos.ChaosInjector(seed=11))
    inj.arm("shard.device_loss", at=1, action="degrade", payload=4)
    inj.arm("shard.device_loss", at=2, action="degrade", payload=3)
    try:
        shard = _burst(dp, cp, 80, 2, pipeline=False)
    finally:
        chaos.clear()
    results = {"host": _host(dh, ch, 80, 2),
               "serial": _burst(ds, cs, 80, 2, pipeline=False),
               "shard": shard}
    _assert_parity(runs, results)
    assert bs.stats["burst_shard_degradations"] == 2, bs.stats
    assert bs.stats["burst_shard_serial_fallbacks"] == 1, bs.stats
    assert bs.n_shards == 1
