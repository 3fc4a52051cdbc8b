"""The per-cycle mesh of the port against the JAX package, on the CPU.

The port partitions whole cohort forests over the ``cq`` axis of its
virtual CPU mesh (``kueue_tpu_torch.parallel.sharded.
virtual_mesh("cpu", 8)``, set for every test of this file) and runs the
plain kernels per shard and the plain head gather and round merge.

- ``make_mesh`` factors and ``make_hybrid_mesh`` shapes and rows
  (tests/test_parallel.py);
- ``test_the_jax_mesh_programs_agree``: ``sharded_cycle_fn``, the three
  ``admit_scan_fns`` routes and ``fs_scan_fn`` (``order`` included)
  against the JAX package's on the conftest's 8 virtual XLA CPU devices,
  which run in a fresh process (see "the cases" below);
- the same programs over more seeds, against the JAX package's
  unsharded programs: cycles with several forests per shard, empty
  shards (5 forests on a cq = 8 mesh) and padded heads;
- ``gather_heads_plain`` and ``fs_merge_order_plain`` against numpy;
- heads that tie on every key across two shards, and a preemption
  target outside its head's forest (``ValueError``).

Tolerance: exact, dtypes asserted (every output is bool or int32)."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from kueue_tpu.ops import cycle as jcycle
from kueue_tpu.ops import fs_scan as jfs
from kueue_tpu.parallel import sharded as jsh
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import cycle as tcycle
from kueue_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def cpu_mesh():
    with tsh.virtual_mesh("cpu", 8):
        yield


def jax_mesh(kind):
    """"grid" = make_mesh(8) (4 x 2), "host" = make_hybrid_mesh() (one
    host: 1 x 8), "hybrid" = 4 hosts (4 x 2)."""
    return {"grid": lambda: jsh.make_mesh(8),
            "host": lambda: jsh.make_hybrid_mesh(),
            "hybrid": lambda: jsh.make_hybrid_mesh(n_hosts=4)}[kind]()


def port_mesh(kind):
    """The port's mesh of the same shape on the virtual CPU mesh."""
    return {"grid": lambda: tsh.make_mesh(8, device="cpu"),
            "host": lambda: tsh.make_hybrid_mesh(device="cpu"),
            "hybrid": lambda: tsh.make_hybrid_mesh(n_hosts=4,
                                                   device="cpu")}[kind]()


def _same(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (label, a.dtype, b.dtype)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    assert np.array_equal(a, b), (label, a, b)


def _same_all(jout, tout, label):
    jout = jout if isinstance(jout, tuple | list) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout), label
    for k, (a, b) in enumerate(zip(jout, tout)):
        _same(np.asarray(a), b.numpy(), f"{label}[{k}]")


# -- the meshes -----------------------------------------------------------

def test_make_mesh_factors_as_jax():
    for n in (8, 4, 3, 1):
        mesh = tsh.make_mesh(n, device="cpu")
        assert mesh.shape == dict(jsh.make_mesh(n).shape), n
        assert mesh.axis_names == ("wl", "cq")
        assert mesh.size == n
    assert tsh.make_mesh(8, device="cpu").shape == {"wl": 4, "cq": 2}
    assert tsh.make_mesh(9, device="cpu") is None      # 8 virtual devices


def test_hybrid_mesh_rows_are_hosts():
    """tests/test_parallel.py :50-70: each grid row is one host's
    devices; one process is one host; an uneven split raises."""
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = tsh.make_hybrid_mesh(n_hosts=4, devices=devices)
    jmesh = jsh.make_hybrid_mesh(n_hosts=4)
    assert mesh.shape == dict(jmesh.shape) == {"wl": 4, "cq": 2}
    jrows = np.asarray(jmesh.devices)
    for host in range(4):
        assert mesh.grid[host] == tuple(devices[2 * host:2 * host + 2])
        assert [d.id for d in jrows[host]] == [2 * host, 2 * host + 1]
    auto = tsh.make_hybrid_mesh(devices=devices)
    assert auto.shape == dict(jsh.make_hybrid_mesh().shape) == {
        "wl": 1, "cq": 8}
    with pytest.raises(ValueError):
        tsh.make_hybrid_mesh(n_hosts=3, devices=devices)
    with pytest.raises(ValueError):
        jsh.make_hybrid_mesh(n_hosts=3)


# -- the cases ------------------------------------------------------------
#
# In-process tests hold the port's mesh programs to the JAX package's
# unsharded programs, which its own tests (tests/test_parallel.py,
# tests/test_sharded_production.py) hold to its mesh programs.  The JAX
# mesh programs themselves run only in a fresh process
# (``test_the_jax_mesh_programs_agree``): in one process, after a JAX
# Driver has run the mesh admit scans, XLA:CPU deadlocks in a later
# ``sharded_cycle_fn`` (a collective permute of 8 devices against an
# all-gather of 2; the rendezvous times out after 40 s and the process
# aborts), which would take a test worker down with it.

def _entry_packed():
    import __graft_entry__ as ge
    return ge._packed_cycle()[3]


def _cycle_case(seed):
    """5 cohort forests (3 nested cohorts) over 24 CQs, 48 heads of which
    40 valid: on the cq = 8 mesh three shards hold no forest."""
    return tt.solve_cycle_planes(np.random.default_rng(seed), n_cqs=24,
                                 n_cohorts=8, depth=3, W=48, n_valid=40,
                                 roots=5, fungibility=False)


def _admit_case(seed, route):
    rng = np.random.default_rng(seed)
    kw = dict(n_cqs=24, n_cohorts=8, depth=3, F=3, W=48, R=2, n_valid=41,
              roots=5)
    if route == "preempt":
        return tt.preempt_cycle(rng, T=64, MT=4, n_targets=20,
                                in_forest=True, **kw)
    return tt.admit_cycle(rng, **kw)


def _admit_call(fns, route, c):
    if route == "preempt":
        return fns["preempt"](*tt.preempt_args(c))
    if route == "forest":
        return fns["forest"](*tt.admit_args(c),
                             forest_of_node=c["forest_of_node"],
                             n_forests=c["n_forests"],
                             max_forest_wl=c["max_forest_wl"])
    return fns["flat"](*tt.admit_args(c))


def _fs_case(seed):
    return tt.fs_cycle(np.random.default_rng(seed), n_cqs=24, n_cohorts=8,
                       depth=3, F=2, R=2, W=32, n_valid=20, roots=5,
                       ties=bool(seed % 2))


def _tie_cases():
    """Heads that tie on borrowing, priority and timestamp (solve_cycle)
    or on priority and timestamp rank (fair sharing), alternating
    between the two shards of the grid mesh."""
    c = tt.solve_cycle_planes(np.random.default_rng(7), n_cqs=24,
                              n_cohorts=8, depth=3, W=48, n_valid=48,
                              roots=5, fungibility=False, big=False)
    c["wl_priority"][:] = 5
    c["wl_timestamp"][:] = 1e9
    shard = tsh.CycleShardLayout(c["parent"], 24, 2,
                                 c["forest_of_node"]).shard_of_cq
    c["wl_cq"][0::2] = np.resize(np.flatnonzero(shard == 0), 24)
    c["wl_cq"][1::2] = np.resize(np.flatnonzero(shard == 1), 24)
    f = tt.fs_cycle(np.random.default_rng(8), n_cqs=24, n_cohorts=8,
                    depth=3, W=24, n_valid=24, roots=5)
    f["prio"][:] = 10
    f["ts_rank"][:] = 0
    return c, f


def mesh_outputs(sh, mesh_of) -> dict:
    """Every mesh program of the cases through ``sh`` (either package's
    ``parallel.sharded``) on ``mesh_of(kind)``, as numpy arrays by key:
    the one-call solvers first, then the admit scans, then fair
    sharing."""
    out = {}

    def put(key, o):
        o = o if isinstance(o, tuple | list) else (o,)
        out[key] = [np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                               else x) for x in o]

    packed = _entry_packed()
    for kind in ("grid", "hybrid"):
        put(f"entry/{kind}", sh.sharded_cycle_fn(
            mesh_of(kind), depth=packed.depth)(*jsh.cycle_args(packed)))
    for kind, run_scan in (("grid", True), ("host", False)):
        c = _cycle_case(0)
        put(f"cycle/{kind}/{run_scan}", sh.sharded_cycle_fn(
            mesh_of(kind), c["depth"], run_scan)(*tt.solve_args(c)))
    c, f = _tie_cases()
    put("ties/solve", sh.sharded_cycle_fn(mesh_of("grid"), c["depth"])(
        *tt.solve_args(c)))
    for kind in ("grid", "host"):
        for route in ("flat", "forest", "preempt"):
            c = _admit_case(0, route)
            put(f"admit/{route}/{kind}", _admit_call(
                sh.admit_scan_fns(mesh_of(kind), c["depth"]), route, c))
    for kind in ("grid", "host"):
        c = _fs_case(1)
        put(f"fs/{kind}", sh.fs_scan_fn(mesh_of(kind), c["depth"],
                                        c["n_levels"])(*tt.fs_args(c)[:18]))
    put("ties/fs", sh.fs_scan_fn(mesh_of("grid"), f["depth"],
                                 f["n_levels"])(*tt.fs_args(f)[:18]))
    return out


def jax_mesh_oracle(path) -> None:
    """``mesh_outputs`` of the JAX package, pickled to ``path`` (run in a
    fresh process by ``test_the_jax_mesh_programs_agree``)."""
    with open(path, "wb") as fh:
        pickle.dump(mesh_outputs(jsh, jax_mesh), fh)


# -- the JAX mesh programs, in a fresh process -------------------------------

def test_the_jax_mesh_programs_agree(tmp_path):
    """sharded_cycle_fn (both meshes, with and without the scan, on the
    entry cycle and on seeded and tied planes), the three admit_scan_fns
    routes and fs_scan_fn (order included) of the port equal the JAX
    package's on 8 virtual XLA CPU devices."""
    path = tmp_path / "jax_mesh.pkl"
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import test_torch_mesh as m; m.jax_mesh_oracle({str(path)!r})")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as fh:
        want = pickle.load(fh)
    got = mesh_outputs(tsh, port_mesh)
    assert want.keys() == got.keys()
    for key in want:
        assert len(want[key]) == len(got[key]), key
        for k, (w, g) in enumerate(zip(want[key], got[key])):
            _same(w, g, f"{key}[{k}]")


# -- the port's mesh programs against the unsharded JAX programs -----------

@pytest.mark.parametrize("kind", ["grid", "hybrid"])
def test_sharded_cycle_matches_jax_on_the_entry_cycle(kind):
    """tests/test_parallel.py :36 on the port: the entry scenario's
    packed first cycle (the JAX package's), six outputs."""
    packed = _entry_packed()
    args = jsh.cycle_args(packed)
    ref = jcycle.solve_cycle(*args, depth=packed.depth)
    tout = tsh.sharded_cycle_fn(port_mesh(kind), depth=packed.depth)(
        *tsh.cycle_args(packed, device="cpu"))
    _same_all(ref, tout, kind)
    assert tout[0].any()


@pytest.mark.parametrize("run_scan", [True, False], ids=["scan", "classify"])
@pytest.mark.parametrize("kind", ["grid", "host"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_cycle_matches_jax_on_seeded_planes(seed, kind, run_scan):
    c = _cycle_case(seed)
    args = tt.solve_args(c)
    tout = tsh.sharded_cycle_fn(port_mesh(kind), c["depth"], run_scan)(
        *args)
    ref = jcycle.solve_cycle(*args, depth=c["depth"], run_scan=run_scan)
    _same_all(ref, tout, (seed, kind))


@pytest.mark.parametrize("kind", ["grid", "host"])
@pytest.mark.parametrize("route", ["flat", "forest", "preempt"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admit_scan_fns_match_jax(seed, route, kind):
    c = _admit_case(seed, route)
    tout = _admit_call(tsh.admit_scan_fns(port_mesh(kind), c["depth"]),
                       route, c)
    if route == "preempt":
        assert c["preempt_mask"].any() and (c["tgt_mat"] >= 0).any()
        assert tout[1].any(), "no head preempted"
        ref = jcycle.admit_scan_preempt(*tt.preempt_args(c),
                                        depth=c["depth"])
    elif route == "forest":
        ref = jcycle.admit_scan_forests(
            *tt.admit_args(c), c["forest_of_node"], depth=c["depth"],
            n_forests=c["n_forests"], max_forest_wl=c["max_forest_wl"])
    else:
        ref = jcycle.admit_scan(*tt.admit_args(c), depth=c["depth"])
    _same_all(ref, tout, (seed, route, kind))
    assert c["n_forests"] == 5


@pytest.mark.parametrize("kind", ["grid", "host"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fs_scan_fn_matches_jax(seed, kind):
    """order (the winner of each round) included: the shards' sequences
    merged back into the reference's round order."""
    c = _fs_case(seed)
    args = tt.fs_args(c)
    tout = tsh.fs_scan_fn(port_mesh(kind), c["depth"], c["n_levels"])(
        *args)
    ref = jfs.fs_admit_scan(*args[:18], depth=c["depth"],
                            n_levels=c["n_levels"])
    _same_all(ref, tout, (seed, kind))
    assert (tout[0] >= 0).sum() == 20


def test_empty_shards_launch_nothing(monkeypatch):
    """5 forests on 8 cq shards: the layout leaves 3 shards without a
    forest (and a forest may have no head this cycle); a shard with no
    head runs no scan, and the gather takes the others' blocks."""
    c = _admit_case(0, "flat")
    calls = []
    real = tcycle.admit_scan

    def counted(*a, **kw):
        calls.append(a[8].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(tcycle, "admit_scan", counted)
    layout = tsh.CycleShardLayout(c["parent"], 24, 8, c["forest_of_node"])
    out = tsh.admit_scan_fns(port_mesh("host"), c["depth"])["flat"](
        *tt.admit_args(c), layout=layout)
    valid = c["wl_cq"] >= 0
    busy = len(set(c["forest_of_node"][c["wl_cq"][valid]].tolist()))
    assert layout.empty_shards == 8 - busy >= 3
    assert len(calls) == busy and sum(calls) == 41 and min(calls) > 0
    ref = jcycle.admit_scan(*tt.admit_args(c), depth=c["depth"])
    _same(np.asarray(ref), out.numpy(), "flat")


def test_layout_keeps_forests_whole():
    c = _admit_case(1, "flat")
    layout = tsh.CycleShardLayout(c["parent"], 24, 2, c["forest_of_node"])
    part = layout.part
    for s in range(2):
        nodes = part.node_perm[s][part.node_perm[s] >= 0]
        forests = set(c["forest_of_node"][nodes].tolist())
        assert forests == set(part.forests_of[s])
        # local parents name the same nodes as the global ones
        for k, nd in enumerate(part.node_perm[s]):
            if nd < 0:
                assert layout.parent_local[s][k] == -1
                continue
            gp = c["parent"][nd]
            lp = layout.parent_local[s][k]
            assert (gp < 0 and lp < 0) or part.node_perm[s][lp] == gp
    heads = layout.heads(c["wl_cq"])
    assert sorted(np.concatenate(heads).tolist()) == np.flatnonzero(
        c["wl_cq"] >= 0).tolist()
    assert all(np.all(np.diff(h) > 0) for h in heads)
    np.testing.assert_array_equal(
        tsh.forests_of_parent(c["parent"]), c["forest_of_node"])


# -- the two kernels' plain versions --------------------------------------

def _np_gather(planes, head_of, W, fills):
    out = []
    for blocks, fill in zip(planes, fills):
        o = np.full(W, fill, dtype=np.asarray(blocks[0]).dtype)
        for b, h in zip(blocks, head_of):
            for i, w in enumerate(h):
                o[w] = b[i]
        out.append(o)
    return out


def _np_merge(winners, head_of, W):
    """The reference's rule, directly: each round serves the shard of the
    lowest remaining head; that shard's next winner (a local id, -1:
    the shard is spent) leaves."""
    shard_of = {int(w): s for s, h in enumerate(head_of) for w in h}
    remaining = set(shard_of)
    nxt = [0] * len(head_of)
    order = []
    while remaining and len(order) < W:
        s = shard_of[min(remaining)]
        seq = winners[s]
        loc = int(seq[nxt[s]]) if nxt[s] < len(seq) else -1
        if loc < 0:
            remaining -= {int(w) for w in head_of[s]}
            continue
        nxt[s] += 1
        order.append(int(head_of[s][loc]))
        remaining.discard(int(head_of[s][loc]))
    return np.array(order + [-1] * (W - len(order)), dtype=np.int32)


CASES = [   # (W, S, n_valid, empty shards)
    (1, 1, 1, ()), (16, 1, 16, ()), (16, 2, 12, ()), (40, 8, 33, (2, 5)),
    (64, 4, 3, ()), (1000, 8, 1000, ()), (33, 32, 30, (0, 31)),
]


@pytest.mark.parametrize("W,S,n_valid,empty", CASES)
def test_gather_heads_plain_matches_numpy(W, S, n_valid, empty):
    planes, head_of, fills = tt.gather_case(
        np.random.default_rng(W + S), W=W, S=S, n_valid=n_valid,
        empty=empty)
    got = tsh.gather_heads_plain(
        tuple(tuple(torch.from_numpy(b) for b in p) for p in planes),
        tuple(torch.from_numpy(h) for h in head_of), W, fills)
    for g, w in zip(got, _np_gather(planes, head_of, W, fills)):
        _same(w, g.numpy(), "gather")


@pytest.mark.parametrize("short", [False, True], ids=["full", "short"])
@pytest.mark.parametrize("W,S,n_valid,empty", CASES[2:])
def test_fs_merge_order_plain_matches_numpy(W, S, n_valid, empty, short):
    rng = np.random.default_rng(W * S)
    winners, head_of = tt.merge_case(rng, W=W, S=S, n_valid=n_valid,
                                     empty=empty, short=short)
    got = tsh.fs_merge_order_plain(
        tuple(torch.from_numpy(w) for w in winners),
        tuple(torch.from_numpy(h) for h in head_of), W)
    _same(_np_merge(winners, head_of, W), got.numpy(), "merge")


# -- trouble spots ----------------------------------------------------------

def test_ties_across_two_shards():
    """Heads tie on every key of the cycle order (and of the tournament)
    and alternate between the two shards: only the global index breaks
    the ties, and each shard keeps its heads in ascending global index
    (``torch.argsort`` is not stable; JAX's sort is)."""
    c, f = _tie_cases()
    layout = tsh.CycleShardLayout(c["parent"], 24, 2, c["forest_of_node"])
    heads = layout.heads(c["wl_cq"])
    assert heads[0].tolist() == list(range(0, 48, 2))
    assert heads[1].tolist() == list(range(1, 48, 2))
    args = tt.solve_args(c)
    ref = jcycle.solve_cycle(*args, depth=c["depth"])
    _same_all(ref, tsh.sharded_cycle_fn(port_mesh("grid"), c["depth"])(
        *args), "solve")
    fl = tsh.CycleShardLayout(f["parent"], None, 2, f["forest_of_node"])
    sh = fl.shard_of_cq[f["wl_cq"]]
    assert (sh[:-1] != sh[1:]).any() and len(set(sh.tolist())) == 2
    args = tt.fs_args(f)
    ref = jfs.fs_admit_scan(*args[:18], depth=f["depth"],
                            n_levels=f["n_levels"])
    _same_all(ref, tsh.fs_scan_fn(port_mesh("grid"), f["depth"],
                                  f["n_levels"])(*args), "fs")


def test_cross_forest_target_raises():
    """The reference replicates the target universe; the port sends each
    target with its forest, so a target in another forest than its head
    — which a Kueue cycle never has, since preemption stays within the
    preemptor's cohort tree — raises instead of deciding wrongly."""
    c = tt.cross_forest_case()
    fn = tsh.admit_scan_fns(port_mesh("grid"), c["depth"])["preempt"]
    with pytest.raises(ValueError, match="cohort forest"):
        fn(*tt.preempt_args(c))
    c["tu_cq"][1] = 1      # the same target in the head's own forest
    out = fn(*tt.preempt_args(c))
    ref = jcycle.admit_scan_preempt(*tt.preempt_args(c), depth=c["depth"])
    _same_all(ref, out, "in forest")
