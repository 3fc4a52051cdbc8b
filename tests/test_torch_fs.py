"""Fair sharing, kernel by kernel: kueue_tpu_torch.ops.fs_scan and
ops.fairsharing_kernel against the JAX package's kueue_tpu.ops.fs_scan
and ops.fairsharing_kernel on the same seeded inputs — exact equality of
values and dtypes.

- ``fs_admit_scan_plain`` against the jitted ``fs_admit_scan`` on
  synthetic cycles (flat and nested cohorts, N on both sides of the
  dense/chain ``available_at`` switch at 64, zero weights, ties on DRS,
  priority and timestamp, NoFit heads, padded rows, borrowing with zero
  lendable capacity at weights of 3,000 and 4,000 milli) and on a
  handmade cycle that only floor division orders;
- ``drs_components_plain`` against ``drs_components``, with and without
  ``wl_req``;
- the host modules (``compute_all_drs``, ``build_fs_statics``,
  ``fs_bounds_ok``, ``TournamentDRS.drs_for``) on snapshots of
  fair-sharing clusters driven by each package.

Each CUDA kernel is held against its plain version in
tests/test_torch_kernels_gpu.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.ops import fairsharing_kernel as jfk
from kueue_tpu.ops import fs_scan as jfs
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import fairsharing_kernel as tfk
from kueue_tpu_torch.ops import fs_scan as tfs

torch.set_num_threads(1)

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _same(jax_out, torch_out):
    assert len(jax_out) == len(torch_out)
    for a, b in zip(jax_out, torch_out):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        assert np.array_equal(a, b), (a.astype(int), b.astype(int))


def _scan_both(case):
    args = tt.fs_args(case)
    kw = dict(depth=case["depth"], n_levels=case["n_levels"])
    # the JAX scan takes every argument but forest_of_node (the port's
    # per-forest restriction)
    j = jfs.fs_admit_scan(*[jnp.asarray(a) for a in args[:-1]], **kw)
    t = tfs.fs_admit_scan(*_t(args), **kw)
    assert t[0].dtype == torch.int32
    assert t[1].dtype == t[2].dtype == torch.bool
    _same(j, t)
    return t


# the sweep of testing.fs_cases without its north-star-width cycle
FS_CASES = tt.FS_SHAPES[:-1]


@pytest.mark.parametrize("shape", FS_CASES,
                         ids=lambda s: "x".join(map(str, s[:8])))
@pytest.mark.parametrize("seed", [0, 1])
def test_fs_admit_scan_matches_jax(shape, seed):
    c = tt.fs_shape_cycle(np.random.default_rng(seed), shape)
    order, admitted, processed = _scan_both(c)
    assert int(processed.sum()) == int(c["valid"].sum())
    assert (order[int(c["valid"].sum()):] == -1).all()


def test_fs_cycles_reach_every_branch():
    """The synthetic sweep is not vacuous: across it some heads admit,
    some skip on capacity, NoFit heads are discarded, winners differ from
    the first remaining head, and nested trees (3 levels) occur."""
    admitted = skipped = reordered = nested = 0
    for seed in (0, 1):
        for shape in FS_CASES:
            c = tt.fs_shape_cycle(np.random.default_rng(seed), shape)
            order, adm, proc = tfs.fs_admit_scan(
                *_t(tt.fs_args(c)), depth=c["depth"],
                n_levels=c["n_levels"])
            admitted += int(adm.sum())
            skipped += int((proc & ~adm & ~torch.from_numpy(c["nofit"]))
                           .sum())
            live = order[order >= 0].numpy()
            reordered += int((live != np.sort(live)).any())
            nested += int(c["n_levels"] >= 3)
    assert min(admitted, skipped, reordered, nested) > 0, (
        admitted, skipped, reordered, nested)


def test_floor_division_decides_the_order():
    """-1000 // 4000 is -1 (floor), not 0 (truncation): the borrowing
    entry with no lendable capacity beats the higher-priority entry that
    does not borrow.  Both packages floor; a truncating scan would put
    the other entry first."""
    c = tt.fs_floor_case()
    order, admitted, _ = _scan_both(c)
    assert order.tolist() == [1, 0, -1, -1]
    assert admitted.tolist() == [True, True, False, False]
    trunc = tfs._floordiv
    try:
        tfs._floordiv = lambda a, b: torch.div(a, b, rounding_mode="trunc")
        t_order, _, _ = tfs.fs_admit_scan(*_t(tt.fs_args(c)),
                                          depth=c["depth"],
                                          n_levels=c["n_levels"])
    finally:
        tfs._floordiv = trunc
    assert t_order.tolist() == [0, 1, -1, -1]


@pytest.mark.parametrize("shape", tt.DRS_SHAPES[:4],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", [0, 1])
def test_drs_components_matches_jax(shape, seed):
    n_cqs, n_coh, depth, F, R, wl_req = shape
    args, kw = tt.drs_case(np.random.default_rng(seed), n_cqs=n_cqs,
                           n_cohorts=n_coh, depth=depth, F=F, R=R,
                           wl_req=wl_req)
    j = jfk.drs_components(*[jnp.asarray(a) for a in args], **kw)
    t = tfk.drs_components(*_t(args), **kw)
    _same(j, t)
    assert (t[0] > 0).any() and (t[1] > 0).any()


# -- host modules on driven snapshots -----------------------------------

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _fs_snapshot(pkg, nested):
    """``testing.fs_borrowing_cluster`` driven on the host path of
    package ``pkg`` → (snapshot, heads of the next cycle)."""
    t = importlib.import_module(f"{pkg}.api.types")
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    clock = Clock()
    d = Driver(clock=clock, fair_sharing=True, use_device_solver=False)
    tt.fs_borrowing_cluster(t, d, clock, nested)
    heads = d.queues.heads_nonblocking()
    assert heads
    return d.cache.snapshot(), heads


@pytest.mark.parametrize("nested", [False, True])
def test_compute_all_drs_matches_jax_and_host(nested):
    snaps = {p: _fs_snapshot(p, nested)[0] for p in PACKAGES}
    jd = jfk.compute_all_drs(snaps["kueue_tpu"])
    td = tfk.compute_all_drs(snaps["kueue_tpu_torch"], device="cpu")
    assert jd == td
    snap = snaps["kueue_tpu_torch"]
    borrowing = 0
    for name, v in td.items():
        node = snap.cq(name)
        if node is None:
            continue
        host, _ = node.dominant_resource_share()
        assert v == host, (name, v, host)
        borrowing += host > 0
    assert borrowing > 0


@pytest.mark.parametrize("nested", [False, True])
def test_fs_statics_and_bounds_match_jax(nested):
    out = {}
    for p in PACKAGES:
        snap, heads = _fs_snapshot(p, nested)
        packing = importlib.import_module(f"{p}.ops.packing")
        fs = importlib.import_module(f"{p}.ops.fs_scan")
        st = packing.pack_structure(snap, heads)
        packed = packing.pack_cycle(snap, heads, structure=st)
        statics = fs.build_fs_statics(snap, st)
        assert statics is not None
        u_e = np.ones((packed.wl_cq.shape[0], packed.usage0.shape[1]),
                      np.int32)
        out[p] = (statics, fs.fs_bounds_ok(statics, packed.usage0, u_e),
                  fs.fs_bounds_ok(statics, packed.usage0, u_e * 2**30))
    (js, jok, jbig), (ts, tok, tbig) = out["kueue_tpu"], out[
        "kueue_tpu_torch"]
    for name in ("sq_mask", "lendable_r", "onehot", "node_level",
                 "child_order"):
        a, b = getattr(js, name), getattr(ts, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (js.n_levels, js.drs_bound_base) == (ts.n_levels,
                                                ts.drs_bound_base)
    assert (jok, jbig) == (tok, tbig) == (True, False)
    assert ts.n_levels == (3 if nested else 2)
    planes = tfs.fs_statics_to_torch(js, "cpu")
    for name, v in planes.items():
        assert np.array_equal(v.numpy(), getattr(ts, name)), name


@pytest.mark.parametrize("nested", [False, True])
def test_tournament_drs_matches_jax(nested):
    res = {}
    for p in PACKAGES:
        snap, _ = _fs_snapshot(p, nested)
        fk = importlib.import_module(f"{p}.ops.fairsharing_kernel")
        fr = importlib.import_module(f"{p}.resources").FlavorResource
        tr = fk.TournamentDRS(snap)
        cq_is = np.array(sorted(tr.cq_index.values()))
        u_es = np.random.default_rng(3).integers(
            0, 3000, (len(cq_is), tr.F)).astype(np.int64)
        paths, drs = tr.drs_for(cq_is, u_es)
        tr.note_add("cq-0-1",
                    {fr("default", "cpu"): 2500, fr("default", "memory"): 700})
        res[p] = (paths, drs, tr.drs_for(cq_is, u_es)[1], tr.u)
    for a, b in zip(res["kueue_tpu"], res["kueue_tpu_torch"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (res["kueue_tpu_torch"][1] > 0).any()
