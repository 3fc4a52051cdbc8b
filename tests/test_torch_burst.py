"""The fused burst kernel: the port's ``burst_cycles_plain`` against the
JAX package's ``burst_cycles`` (XLA on the CPU, as tests/test_burst.py
runs it) on the same inputs — exact equality of the seven outputs and
the nine carry planes, dtypes asserted (every output is int32, uint32
bits or bool, so the tolerance is 0).

Inputs: the seeded synthetic windows of ``kueue_tpu_torch.testing``
(multi-flavor resume, two resources, runtime 0, equal ordering keys, a
deeper forest, finishes and external release / unpark events), the
``burst_probe`` shapes, and plans packed by both packages' ``pack_burst``
from the same driver states (tests/test_torch_burst_driver.py)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kueue_tpu.ops import burst as jburst
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import burst as tburst
from kueue_tpu_torch.ops.packing import plan_to_torch

from test_torch_burst_driver import build

torch.set_num_threads(1)

OUTS = ("head_row", "kind", "slot", "borrows", "tgt_words", "dirty",
        "dirty_reason")
CARRY = ("elig", "parked", "resume", "adm", "adm_seq", "adm_usage",
         "adm_uses", "death", "u_cq")


def to_torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a))
            if isinstance(a, np.ndarray) else a for a in args]


def port_numpy(out):
    """The port's outputs as numpy, tgt_words as its uint32 bits."""
    dec = [t.numpy() for t in out[:7]]
    assert dec[4].dtype == np.int32
    dec[4] = dec[4].view(np.uint32)
    return dec, [t.numpy() for t in out[7]]


def assert_same(ref, out, label=""):
    dec, carry = port_numpy(out)
    ref = jax.device_get(ref)
    for name, r, o in zip(OUTS, ref[:7], dec):
        r = np.asarray(r)
        assert o.dtype == r.dtype, (label, name, o.dtype, r.dtype)
        assert o.shape == r.shape, (label, name)
        assert np.array_equal(o, r), (label, name)
    for name, r, o in zip(CARRY, ref[7], carry):
        r = np.asarray(r)
        assert o.dtype == r.dtype, (label, name, o.dtype, r.dtype)
        assert np.array_equal(o, r), (label, name)
    return dec


@pytest.mark.parametrize("label", ["base", "flavors", "two-res", "ties",
                                   "deep", "wide", "mixed-fleet", "probe"])
def test_synthetic_windows(label):
    cases = {lb: (a, kw) for lb, a, kw in tt.burst_cases(0)}
    args, kw = cases[label]
    if label == "mixed-fleet":
        # 4 slots x 3 resources, resumes mid-list, both policies mixed
        names = dict(zip(tburst.ARG_NAMES, args))
        assert names["slot_fr"].shape[1:] == (4, 3)
        assert names["resume0"].max() > 0
        for k in ("cq_wcb_borrow", "cq_wcp_preempt"):
            assert 0 < names[k].sum() < len(names[k]), k
    ref = jburst.burst_cycles(*args, **kw)
    dec = assert_same(ref, tburst.burst_cycles(*to_torch(args), **kw), label)
    if label in ("base", "two-res"):
        # these windows preempt in-kernel
        assert (dec[1] == tburst.KIND_PREEMPT).any()


@pytest.mark.parametrize("shape", [(10, 16, 1, 8), (15, 8, 2, 6)])
def test_probe_shapes(shape):
    args, kw = tburst.burst_probe_args(*shape)
    ref = jburst.burst_cycles(*args, **kw)
    assert_same(ref, tburst.burst_cycles(*to_torch(args), **kw), shape)
    out = tburst.burst_probe(*shape, device="cpu")
    assert torch.equal(out[1], tburst.burst_cycles(*to_torch(args),
                                                   **kw)[1])


def test_stable_sorts_decide_ties():
    """Equal candidate keys and equal head cycle ranks: only the stable
    index order of jnp.lexsort / jnp.argsort separates them, and the
    port's plain version (torch.sort / torch.argsort with stable=True)
    must pick the same order — over several seeds, with the tie cases
    actually reaching the searches."""
    searched = 0
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        args, kw = tt.burst_synthetic(rng, ties=True, C=8, per=4)
        ref = jburst.burst_cycles(*args, **kw)
        dec = assert_same(ref, tburst.burst_cycles(*to_torch(args), **kw),
                          seed)
        searched += int(np.isin(dec[1], (tburst.KIND_PREEMPT,
                                         tburst.KIND_RESERVE)).sum())
    assert searched > 0


def _packed(pkg, name):
    """The plan ``pack_burst`` builds from a scenario's state, and the
    events of the first window (K = 32)."""
    d, clock, _, runtime = build(pkg, name)
    pb = __import__(f"{pkg}.ops.burst", fromlist=["pack_burst"])
    st = d.scheduler.solver._structure_for(d.cache.snapshot(), [])
    plan = pb.pack_burst(st, d.queues, d.cache, d.scheduler, clock)
    assert plan is not None
    return plan, runtime


@pytest.mark.parametrize("name", ["wave", "staged", "reclaim_overlap",
                                  "drain"])
def test_plans_packed_by_both_packages(name):
    """Both packers build identical plans from the same driver state, and
    both kernels decide them identically — including the wave, whose
    preempting lanes walk different numbers of candidates and one of
    which exhausts (the per-lane loop exit)."""
    jplan, runtime = _packed("kueue_tpu", name)
    tplan, _ = _packed("kueue_tpu_torch", name)
    assert jplan.arrays.keys() == tplan.arrays.keys()
    for k, v in jplan.arrays.items():
        assert v.dtype == tplan.arrays[k].dtype, k
        assert np.array_equal(v, tplan.arrays[k]), k
    K = 32
    F = jplan.arrays["u_cq0"].shape[1]
    ext_release = np.zeros((K, jplan.C, F), np.int32)
    ext_unpark = np.zeros((K, jplan.G), bool)
    kw = dict(K=K, depth=jplan.structure.depth, L=jplan.L,
              S=int(jplan.structure.slot_fr.shape[1]), KC=jplan.KC,
              n_levels=jplan.n_levels, G=jplan.G, runtime=runtime)
    names = [n for n in tburst.ARG_NAMES
             if n not in ("seq_base", "ext_release", "ext_unpark")]
    jargs = [jplan.arrays[n] if n in jplan.arrays else None
             for n in tburst.ARG_NAMES]
    jargs[tburst.ARG_NAMES.index("seq_base")] = np.int32(jplan.seq_base)
    jargs[-2], jargs[-1] = ext_release, ext_unpark
    ref = jburst.burst_cycles(*jargs, **kw)
    planes = plan_to_torch(tplan, "cpu")
    assert all(planes[n].dtype == torch.from_numpy(tplan.arrays[n]).dtype
               for n in names)
    targs = [planes.get(n) for n in tburst.ARG_NAMES]
    targs[tburst.ARG_NAMES.index("seq_base")] = tplan.seq_base
    targs[-2] = torch.from_numpy(ext_release)
    targs[-1] = torch.from_numpy(ext_unpark)
    dec = assert_same(ref, tburst.burst_cycles(*targs, **kw), name)
    if name == "wave":
        pre = dec[1][0] == tburst.KIND_PREEMPT
        n_targets = [int(np.unpackbits(
            dec[4][0, c].view(np.uint8)).sum()) for c in np.nonzero(pre)[0]]
        assert len(set(n_targets)) > 1, n_targets      # different walks
        assert (dec[1][0] == tburst.KIND_RESERVE).any()  # one exhausted


def test_dispatch_next_chain_matches():
    """BurstSolver dispatch → fetch → dispatch_next → fetch on both
    packages: equal decisions and equal final carries of both windows
    (death rebased by -K, seq_base advanced)."""
    jplan, runtime = _packed("kueue_tpu", "sustained")
    tplan, _ = _packed("kueue_tpu_torch", "sustained")
    js = jburst.BurstSolver(backend="cpu")
    ts = tburst.BurstSolver(device="cpu")
    K = 32
    F = jplan.arrays["u_cq0"].shape[1]
    extr = np.zeros((K, jplan.C, F), np.int32)
    extu = np.zeros((K, jplan.G), bool)
    hj = js.dispatch(jplan, K, runtime, extr, extu)
    ht = ts.dispatch(tplan, K, runtime, extr, extu)
    for h, s in ((hj, js), (ht, ts)):
        s.fetch_flags(h)
    nj = js.dispatch_next(hj, extr, extu)
    nt = ts.dispatch_next(ht, extr, extu)
    assert nj is not None and nt is not None
    for a, b in ((hj, ht), (nj, nt)):
        dj = js.fetch(a)
        dt = ts.fetch(b)
        for name, x, y in zip(OUTS, dj, dt):
            x = np.asarray(x)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        for name, x, y in zip(CARRY, a.carry, b.carry):
            x = np.asarray(jax.device_get(x))
            assert np.array_equal(x, y.numpy()), name
    assert ts.stats["burst_spec_dispatches"] == 1
    assert ts.stats["burst_dispatches"] == 2


def test_cuda_solver_never_selects_the_cpu():
    """BurstSolver on "cuda" raises without a GPU instead of running the
    plain version; "cpu" runs it and launches nothing."""
    from kueue_tpu_torch import kernels
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tburst.BurstSolver(device="cuda")
    before = dict(kernels.LAUNCHES)
    args, kw = tburst.burst_probe_args(10, 16, 1, 4)
    tburst.burst_cycles(*to_torch(args), **kw)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.burst_cycles(*to_torch(args), **kw)
    # set_shards(2) shards on a 2-device virtual mesh, and stays serial
    # on the CPU's one device without one
    from kueue_tpu_torch.parallel import sharded
    bs = tburst.BurstSolver(device="cpu")
    bs.set_shards(2)
    assert bs.n_shards == 1 and bs._shard_mesh is None
    with sharded.virtual_mesh("cpu", 2):
        bs.set_shards(2)
    assert bs.n_shards == 2 and bs._shard_mesh.size == 2
