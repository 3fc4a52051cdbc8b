"""Each CUDA kernel of kueue_tpu_torch against its plain PyTorch version
on the same seeded inputs (kueue_tpu_torch.testing.kernel_cases,
burst_cases, fs_cases, tas_cases, solve_cycle_cases, shape_cases,
scatter_case, dflags_blocks, gather_case and merge_case), the
forest-sharded burst on a virtual mesh of the card against the serial
burst, and the per-cycle mesh route on a virtual mesh of the card
against the unsharded plain versions: exact equality, as
every output is bool or int32.  Needs a CUDA GPU — the kernels have no CPU mode —
and skips without one.  This file imports no JAX, so it
also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import (burst, cycle, fairsharing_kernel, fs_scan,
                                 preemption_kernel)

PLAIN = {
    "admit_scan": cycle.admit_scan_plain,
    "admit_scan_forests": cycle.admit_scan_forests_plain,
    "admit_scan_preempt": cycle.admit_scan_preempt_plain,
    "minimal_preemptions_batch":
        preemption_kernel.minimal_preemptions_batch_plain,
}
ROUTED = {
    "admit_scan": cycle.admit_scan,
    "admit_scan_forests": cycle.admit_scan_forests,
    "admit_scan_preempt": cycle.admit_scan_preempt,
    "minimal_preemptions_batch": preemption_kernel.minimal_preemptions_batch,
}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_kernels_match_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    seen = set()
    for name, args, kw in tt.kernel_cases(seed):
        before = kernels.LAUNCHES[name]
        plain = PLAIN[name](*[torch.from_numpy(a) for a in args], **kw)
        cuda = ROUTED[name](*[torch.from_numpy(a).cuda() for a in args],
                            **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        plain = plain if isinstance(plain, tuple) else (plain,)
        cuda = cuda if isinstance(cuda, tuple) else (cuda,)
        for p, c in zip(plain, cuda):
            assert c.dtype == p.dtype and c.shape == p.shape, name
            assert np.array_equal(c.cpu().numpy(), p.numpy()), name
        seen.add(name)
    assert seen == set(PLAIN)


@pytest.mark.gpu
def test_cuda_launcher_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    name, args, kw = next(tt.kernel_cases(0))
    good = [torch.from_numpy(a).cuda() for a in args]
    bad = list(good)
    bad[0] = bad[0].to(torch.int64)             # usage0 must be int32
    with pytest.raises(TypeError):
        kernels.admit_scan(*bad, **kw)
    bad = list(good)
    bad[4] = bad[4].cpu()                       # has_blim on the wrong device
    with pytest.raises(ValueError):
        kernels.admit_scan(*bad, **kw)
    with pytest.raises(ValueError):
        kernels.admit_scan(*good, depth=0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_burst_matches_plain(seed):
    """burst_cycles on the card against burst_cycles_plain on the CPU:
    the seven outputs and the nine carry planes, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    for label, args, kw in tt.burst_cases(seed):
        cpu = [torch.from_numpy(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else int(a) for a in args]
        before = kernels.LAUNCHES["burst_cycles"]
        plain = burst.burst_cycles_plain(*cpu, **kw)
        cuda = burst.burst_cycles(*[a.cuda() if isinstance(a, torch.Tensor)
                                    else a for a in cpu], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["burst_cycles"] == before + 1, label
        flat_p = list(plain[:7]) + list(plain[7])
        flat_c = list(cuda[:7]) + list(cuda[7])
        for i, (p, c) in enumerate(zip(flat_p, flat_c)):
            assert c.dtype == p.dtype and c.shape == p.shape, (label, i)
            assert torch.equal(c.cpu(), p), (label, i)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_fair_sharing_kernels_match_plain(seed):
    """fs_admit_scan and drs_components on the card against their plain
    versions on the CPU (kueue_tpu_torch.testing.fs_cases: nested
    cohorts, N on both sides of 64, ties, zero weights, NoFit heads,
    padding, the floor-division cycle, the north-star width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    plain = {"fs_admit_scan": fs_scan.fs_admit_scan_plain,
             "drs_components": fairsharing_kernel.drs_components_plain}
    routed = {"fs_admit_scan": fs_scan.fs_admit_scan,
              "drs_components": fairsharing_kernel.drs_components}
    seen = set()
    for name, args, kw in tt.fs_cases(seed):
        before = kernels.LAUNCHES[name]
        p = plain[name](*[torch.from_numpy(a) for a in args], **kw)
        c = routed[name](*[torch.from_numpy(a).cuda() for a in args], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and y.shape == x.shape, name
            assert torch.equal(y.cpu(), x), name
        seen.add(name)
    assert seen == set(plain)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_tas_kernels_match_plain(seed):
    """fill_counts, best_fit_descend and split_across_roots on the card
    against their plain versions on the CPU
    (kueue_tpu_torch.testing.tas_cases: 1-3 levels, ragged trees, ties,
    every profile and Mixed's unconstrained variant, every request
    shape, counts 0 to above the total, a wrapping sum, a flat level of
    4,096 roots and a tree at the tas-4k shape): values and dtypes
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops import tas_kernel

    def on(args, device):
        return [tuple(torch.from_numpy(p).to(device) for p in a)
                if isinstance(a, tuple) else
                torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
                else a for a in args]

    seen = set()
    for name, args, kw in tt.tas_cases(seed, tt.TAS_PARTS + ("tas4k",),
                                       flat=4096):
        before = kernels.LAUNCHES[name]
        p = getattr(tas_kernel, name + "_plain")(*on(args, "cpu"), **kw)
        c = getattr(tas_kernel, name)(*on(args, "cuda"), **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        assert len(p) == len(c), name
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and y.shape == x.shape, (name, kw)
            assert torch.equal(y.cpu(), x), (name, kw)
        seen.add(name)
    assert seen == {"fill_counts", "best_fit_descend", "split_across_roots"}


@pytest.mark.gpu
def test_cuda_tas_sort_in_global_memory(monkeypatch):
    """With no shared memory allowed for the sort, the descent kernels
    sort in global scratch and still equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops import tas_kernel
    monkeypatch.setattr(kernels, "TAS_SMEM_SORT", 0)
    for name, args, kw in tt.tas_cases(0, ("three_levels", "flat")):
        if name == "fill_counts":
            continue
        cpu = [tuple(torch.from_numpy(p) for p in a) if isinstance(a, tuple)
               else torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in args]
        cuda = [tuple(p.cuda() for p in a) if isinstance(a, tuple)
                else a.cuda() if isinstance(a, torch.Tensor) else a
                for a in cpu]
        p = getattr(tas_kernel, name + "_plain")(*cpu, **kw)
        c = getattr(tas_kernel, name)(*cuda, **kw)
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and torch.equal(y.cpu(), x), (name, kw)


PHASE1 = ("kq_cq_avail", "kq_classify_heads", "kq_cycle_order")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_solve_cycle_kernels_match_plain(seed):
    """kq_cq_avail, kq_classify_heads and kq_cycle_order on the card
    against their plain versions on the CPU
    (kueue_tpu_torch.testing.solve_cycle_cases: N on both sides of 64,
    padding heads, uncovered and invalid slots, int32 wraps, ties and
    INT_MIN, the sort in shared memory and, past 8,192 heads, in global
    scratch): values and dtypes exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    plain = {"kq_cq_avail": cycle.cq_avail_plain,
             "kq_classify_heads": cycle.classify_heads_plain,
             "kq_cycle_order": cycle.cycle_order_plain}
    routed = {"kq_cq_avail": cycle.cq_avail,
              "kq_classify_heads": cycle.classify_heads,
              "kq_cycle_order": cycle.cycle_order}
    seen = set()
    for name, args, kw in tt.solve_cycle_cases(seed):
        before = kernels.LAUNCHES[name]
        p = plain[name](*[torch.from_numpy(a) for a in args], **kw)
        c = routed[name](*[torch.from_numpy(a).cuda() for a in args], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        p = p if isinstance(p, tuple) else (p,)
        c = c if isinstance(c, tuple) else (c,)
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and y.shape == x.shape, (name, kw)
            assert torch.equal(y.cpu(), x), (name, kw)
        seen.add(name)
    assert seen == set(PHASE1)


@pytest.mark.gpu
@pytest.mark.parametrize("fungibility", [False, True])
def test_cuda_solve_cycle_matches_plain(fungibility):
    """solve_cycle (with and without the scan) and solve_cycle_forests on
    the card against their plain versions on the CPU; every call launches
    kq_cq_avail and kq_classify_heads once, and kq_cycle_order once with
    the scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    c = tt.solve_cycle_planes(np.random.default_rng(5), n_cqs=80,
                              n_cohorts=10, S=4, R=3, F=12, W=256,
                              n_valid=240, fungibility=fungibility)
    args = tt.solve_args(c, fungibility)
    for run_scan in (True, False):
        before = dict(kernels.LAUNCHES)
        got = cycle.solve_cycle(*[torch.from_numpy(a).cuda() for a in args],
                                depth=c["depth"], run_scan=run_scan)
        want = cycle.solve_cycle_plain(*[torch.from_numpy(a) for a in args],
                                       depth=c["depth"], run_scan=run_scan)
        torch.cuda.synchronize()
        for x, y in zip(want, got):
            assert y.dtype == x.dtype and torch.equal(y.cpu(), x)
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        assert grew["kq_cq_avail"] == grew["kq_classify_heads"] == 1
        assert grew["kq_cycle_order"] == grew["admit_scan"] == int(run_scan)
    fargs = tt.solve_args(c) + (c["forest_of_node"],)
    kw = dict(depth=c["depth"], n_forests=c["n_forests"],
              max_forest_wl=c["max_forest_wl"])
    got = cycle.solve_cycle_forests(*[torch.from_numpy(a).cuda()
                                      for a in fargs], **kw)
    want = cycle.solve_cycle_forests_plain(*[torch.from_numpy(a)
                                             for a in fargs], **kw)
    for x, y in zip(want, got):
        assert y.dtype == x.dtype and torch.equal(y.cpu(), x)


@pytest.mark.gpu
def test_cuda_cycle_order_in_global_memory(monkeypatch):
    """With no shared memory allowed, kq_cycle_order sorts in global
    scratch and still equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    monkeypatch.setattr(kernels, "SORT_SMEM", 0)
    for W in (1, 5, 1000):
        args = tt.order_case(np.random.default_rng(W), W)
        p = cycle.cycle_order_plain(*[torch.from_numpy(a) for a in args])
        c = cycle.cycle_order(*[torch.from_numpy(a).cuda() for a in args])
        assert c.dtype == p.dtype and torch.equal(c.cpu(), p), W


SHAPE_PLAIN = {
    "admit_scan": cycle.admit_scan_plain,
    "admit_scan_forests": cycle.admit_scan_forests_plain,
    "admit_scan_preempt": cycle.admit_scan_preempt_plain,
    "minimal_preemptions_batch":
        preemption_kernel.minimal_preemptions_batch_plain,
    "burst_cycles": burst.burst_cycles_plain,
    "kq_cq_avail": cycle.cq_avail_plain,
    "drs_components": fairsharing_kernel.drs_components_plain,
    "fs_admit_scan": fs_scan.fs_admit_scan_plain,
}


def _flat(out):
    if not isinstance(out, tuple):
        return [out]
    return [t for x in out for t in _flat(x)]


@pytest.mark.gpu
def test_cuda_kernels_past_the_old_limits():
    """Depth 17, fs_admit_scan at F = 65 and 72, admit_scan at F = 1,025
    and admit_scan_forests over one forest of 40,000 heads (its head list
    in global scratch): every launcher takes them, and each kernel equals
    its plain version (kueue_tpu_torch.testing.shape_cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    seen = set()
    for name, args, kw in tt.shape_cases(0, card=True):
        before = kernels.LAUNCHES[name]
        p = SHAPE_PLAIN[name](*[torch.from_numpy(a)
                                if isinstance(a, np.ndarray) else a
                                for a in args], **kw)
        c = getattr(kernels, name)(*[torch.from_numpy(a).cuda()
                                     if isinstance(a, np.ndarray) else a
                                     for a in args], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        for x, y in zip(_flat(p), _flat(c)):
            assert y.dtype == x.dtype and y.shape == x.shape, (name, kw)
            assert torch.equal(y.cpu(), x), (name, kw)
        seen.add(name)
    assert seen == set(SHAPE_PLAIN)


@pytest.mark.gpu
def test_cuda_forest_list_in_global_memory(monkeypatch):
    """With no shared memory allowed for the head lists,
    admit_scan_forests keeps them in global scratch and still equals its
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    monkeypatch.setattr(kernels, "FOREST_SMEM", 0)
    for name, args, kw in tt.kernel_cases(0):
        if name != "admit_scan_forests":
            continue
        p = cycle.admit_scan_forests_plain(
            *[torch.from_numpy(a) for a in args], **kw)
        c = kernels.admit_scan_forests(
            *[torch.from_numpy(a).cuda() for a in args], **kw)
        assert torch.equal(c.cpu(), p), kw


@pytest.mark.gpu
@pytest.mark.parametrize("seed,D", [(0, 1), (1, 3), (2, 9), (3, 12)])
def test_cuda_scatter_and_reduce_match_plain(seed, D):
    """kq_scatter_rows (13 planes in place, padded duplicate rows) and
    kq_reduce_dflags against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.parallel import sharded
    planes, rows, vals = tt.scatter_case(seed, D=D)
    want = sharded.scatter_rows_plain(
        [torch.from_numpy(p.copy()) for p in planes],
        torch.from_numpy(rows), [torch.from_numpy(v) for v in vals])
    before = kernels.LAUNCHES["kq_scatter_rows"]
    got = sharded.scatter_rows(
        [torch.from_numpy(p).cuda() for p in planes],
        torch.from_numpy(rows).cuda(),
        [torch.from_numpy(v).cuda() for v in vals])
    assert kernels.LAUNCHES["kq_scatter_rows"] == before + 1
    for x, y in zip(want, got):
        assert y.dtype == x.dtype and torch.equal(y.cpu(), x)
    window = torch.from_numpy(tt.dflags_blocks(2 + seed, 32))
    want = sharded.reduce_dflags_plain(window)
    got = sharded.reduce_dflags(window.cuda())
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_cuda_sharded_burst_matches_serial(monkeypatch):
    """The sustained drain with a mid-run arrival on a 4-shard virtual
    mesh of the card (one stream per shard): records equal to the serial
    burst on the CPU, resident reuse with the scatter kernel, one
    kq_reduce_dflags launch per sharded dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels, scenarios
    from kueue_tpu_torch.parallel import sharded
    monkeypatch.setenv("KUEUE_TPU_RESIDENT_VERIFY", "1")
    serial = scenarios.sustained_drain(device="cpu")
    before = dict(kernels.LAUNCHES)
    with sharded.virtual_mesh("cuda:0", 4):
        shard = scenarios.sustained_drain(device="cuda", shards=4)
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert shard["records"] == serial["records"]
    st = shard["stats"]
    assert st["burst_sharded_dispatches"] >= 1, st
    assert grew["kq_reduce_dflags"] == st["burst_sharded_dispatches"]
    assert st["burst_resident_hits"] >= 1, st
    assert grew["kq_scatter_rows"] >= 1, grew


# (W, S, n_valid, shards with no head): a single shard, zero-length
# blocks, and north-star width
MESH_CASES = [(1, 1, 1, ()), (30, 1, 30, ()), (40, 8, 33, (2, 5)),
              (64, 4, 0, ()), (1000, 8, 1000, ()), (33, 32, 30, (0, 31))]


@pytest.mark.gpu
@pytest.mark.parametrize("W,S,n_valid,empty", MESH_CASES)
def test_cuda_mesh_kernels_match_plain(W, S, n_valid, empty):
    """kq_gather_heads (a bool and an int32 plane in one launch; the
    zero-length blocks dropped before it) and kq_fs_merge_order against
    their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.parallel import sharded
    rng = np.random.default_rng(W + S)
    planes, head_of, fills = tt.gather_case(rng, W=W, S=S, n_valid=n_valid,
                                            empty=empty)
    cpu = (tuple(tuple(torch.from_numpy(b) for b in p) for p in planes),
           tuple(torch.from_numpy(h) for h in head_of))
    src = torch.from_numpy(sharded.source_map(head_of, W))
    card = tuple(tuple(b.cuda() for b in p) for p in cpu[0])
    want = sharded.gather_heads_plain(*cpu, W, fills)
    before = dict(kernels.LAUNCHES)
    got = sharded.gather_heads(card, src.cuda(), fills)
    assert kernels.LAUNCHES["kq_gather_heads"] == before["kq_gather_heads"] + 1
    for x, y in zip(want, got):
        assert y.dtype == x.dtype and torch.equal(y.cpu(), x)
    for short in ((False, True) if n_valid >= 2 * S else (False,)):
        winners, head_of = tt.merge_case(rng, W=W, S=S, n_valid=n_valid,
                                         empty=empty, short=short)
        cpu = (tuple(torch.from_numpy(w) for w in winners),
               tuple(torch.from_numpy(h) for h in head_of))
        want = sharded.fs_merge_order_plain(*cpu, W)
        got = sharded.fs_merge_order(tuple(w.cuda() for w in cpu[0]),
                                     tuple(h.cuda() for h in cpu[1]), W)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_cuda_mesh_route_matches_plain():
    """The three admit_scan_fns routes, fs_scan_fn and sharded_cycle_fn
    on a virtual 8-cell mesh of the card (2 x 4 and 1 x 8), against the
    unsharded plain versions: one kernel per shard with heads, one
    gather per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.parallel import sharded
    rng = np.random.default_rng(5)
    kw = dict(n_cqs=24, n_cohorts=8, depth=3, F=3, W=48, R=2, n_valid=41,
              roots=5)
    c = tt.preempt_cycle(rng, T=64, MT=4, n_targets=20, in_forest=True,
                         **kw)
    f = tt.fs_cycle(rng, n_cqs=24, n_cohorts=8, depth=3, W=32, n_valid=20,
                    roots=5)
    s = tt.solve_cycle_planes(rng, n_cqs=24, n_cohorts=8, depth=3, W=48,
                              n_valid=40, roots=5, fungibility=False)
    cpu = lambda xs: [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    with sharded.virtual_mesh("cuda:0", 8):
        for mesh in (sharded.make_mesh(8), sharded.make_hybrid_mesh()):
            before = dict(kernels.LAUNCHES)
            fns = sharded.admit_scan_fns(mesh, c["depth"])
            checks = [
                (fns["flat"](*tt.admit_args(c)),
                 cycle.admit_scan_plain(*cpu(tt.admit_args(c)),
                                        depth=c["depth"])),
                (fns["forest"](*tt.admit_args(c),
                               forest_of_node=c["forest_of_node"],
                               n_forests=c["n_forests"],
                               max_forest_wl=c["max_forest_wl"]),
                 cycle.admit_scan_forests_plain(
                     *cpu(tt.forest_args(c)), depth=c["depth"],
                     n_forests=c["n_forests"],
                     max_forest_wl=c["max_forest_wl"])),
                (fns["preempt"](*tt.preempt_args(c)),
                 cycle.admit_scan_preempt_plain(*cpu(tt.preempt_args(c)),
                                                depth=c["depth"])),
                (sharded.fs_scan_fn(mesh, f["depth"], f["n_levels"])(
                    *tt.fs_args(f)),
                 fs_scan.fs_admit_scan_plain(*cpu(tt.fs_args(f)),
                                             depth=f["depth"],
                                             n_levels=f["n_levels"])),
                (sharded.sharded_cycle_fn(mesh, s["depth"])(
                    *tt.solve_args(s)),
                 cycle.solve_cycle_plain(*cpu(tt.solve_args(s)),
                                         depth=s["depth"])),
            ]
            torch.cuda.synchronize()
            for got, want in checks:
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
            grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            assert grew["kq_gather_heads"] == 5, grew
            assert grew["kq_fs_merge_order"] == 1, grew
            assert grew["kq_cycle_order"] == mesh.shape["cq"] - sum(
                1 for h in sharded.CycleShardLayout(
                    s["parent"], 24, mesh.shape["cq"]).heads(s["wl_cq"])
                if not len(h)), grew


# the redesigned reduction at the sharded burst's shapes, and K that are
# not multiples of 8 (one warp per 32 cycle rows)
REDUCE_CASES = [(S, K) for S in (1, 2, 4, 8, 32) for K in (32, 7, 33, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("S,K", REDUCE_CASES)
def test_cuda_reduce_window_matches_plain(S, K):
    """kq_reduce_dflags over one [S, K, 4] window (flags, and values
    that wrap int32), one launch, against ``reduce_dflags_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.parallel import sharded
    rng = np.random.default_rng(S * 1000 + K)
    for window in (tt.dflags_blocks(S, K),
                   rng.integers(2**31 - 9, 2**31, (S, K, 4)).astype(
                       np.int32)):
        window = torch.from_numpy(window)
        want = sharded.reduce_dflags_plain(window)
        before = kernels.LAUNCHES["kq_reduce_dflags"]
        got = kernels.kq_reduce_dflags(window.cuda())
        assert kernels.LAUNCHES["kq_reduce_dflags"] == before + 1
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.kq_reduce_dflags(torch.zeros(
            S * K * 4 + 1, dtype=torch.int32, device="cuda")[1:].view(
                S, K, 4))


# (W, shards, planes): the north-star mesh (1,024 heads on 2 shards, one
# and three planes), 1,000 heads on 8 and on 32 shards, all six planes
GATHER_CASES = [(1024, 2, ("bool",)), (1024, 2, ("bool", "bool", "bool")),
                (1000, 8, ("bool", "bool", "bool")), (1000, 32, ("int32",)),
                (4096, 32, ("bool", "int32", "bool", "bool", "int32",
                            "bool")), (100_000, 8, ("bool", "int32"))]


@pytest.mark.gpu
@pytest.mark.parametrize("W,S,dtypes", GATHER_CASES)
def test_cuda_gather_by_source_map_matches_plain(W, S, dtypes):
    """kq_gather_heads by the layout's source map (heads in no shard,
    shards without heads dropped before the launch, as the mesh route
    drops them) against ``gather_heads_plain`` on the maps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.parallel import sharded
    rng = np.random.default_rng(W + S)
    planes, head_of, fills = tt.gather_case(
        rng, W=W, S=S, n_valid=W - W // 10, empty=(S - 1,), dtypes=dtypes)
    live = [s for s, h in enumerate(head_of) if len(h)]
    head_of = tuple(torch.from_numpy(head_of[s]) for s in live)
    cpu = tuple(tuple(torch.from_numpy(p[s]) for s in live) for p in planes)
    want = sharded.gather_heads_plain(cpu, head_of, W, fills)
    src = torch.from_numpy(sharded.source_map(head_of, W)).cuda()
    before = kernels.LAUNCHES["kq_gather_heads"]
    got = kernels.kq_gather_heads(
        tuple(tuple(b.cuda() for b in p) for p in cpu), src, fills)
    assert kernels.LAUNCHES["kq_gather_heads"] == before + 1
    for x, y in zip(want, got):
        assert y.dtype == x.dtype and torch.equal(y.cpu(), x)
