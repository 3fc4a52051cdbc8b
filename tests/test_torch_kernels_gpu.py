"""Each CUDA kernel of kueue_tpu_torch against its plain PyTorch version
on the same seeded inputs (kueue_tpu_torch.testing.kernel_cases,
burst_cases, burst_one_forest, flat_scan_cases, preempt_route_cases,
fs_cases, tas_cases, solve_cycle_cases, avail_cases, shape_cases,
scatter_case, dflags_blocks, gather_case and merge_case; the two-route kernels on
both routes; admit_scan_preempt under forest tables joined by
testing.preempt_tables, and raising on wrong ones), the
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
        extra = {}
        if name == "admit_scan_preempt":
            # the sweep's targets may lie in other forests: joined tables
            fon, nf = tt.preempt_tables(args)
            extra = dict(forest_of_node=torch.from_numpy(fon).cuda(),
                         n_forests=nf)
        cuda = ROUTED[name](*[torch.from_numpy(a).cuda() for a in args],
                            **kw, **extra)
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
def test_cuda_drs_components_design_matches_plain():
    """drs_components' (node, column) design against its plain version:
    testing.drs_design_cases (depth 1, 2, 3 and 17, F = 1 / 5 / 12 / 65,
    R = 1 / 3 / 5, a resource with no column, planes over the whole
    int32 range, N past the staged route, both routes) and kernel_ab.py's
    seeded
    shapes (phase 9's, the probe's planes, a chain 17 levels deep):
    values and dtypes exactly, one launch each, the route by
    ``kernels.drs_layout``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    import kernel_ab
    from kueue_tpu_torch import kernels, scenarios
    cases = [tuple(a.numpy() for a in args) + (kw,) for args, kw in
             kernel_ab.drs_cases(scenarios, tt).values()]
    cases += [args + (kw,) for args, kw in tt.drs_design_cases(0)]
    seen = set()
    for *args, kw in cases:
        want = fairsharing_kernel.drs_components_plain(
            *[torch.from_numpy(a) for a in args], **kw)
        before = kernels.LAUNCHES["drs_components"]
        got = fairsharing_kernel.drs_components(
            *[torch.from_numpy(a).cuda() for a in args], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["drs_components"] == before + 1
        N, F = args[0].shape
        route = kernels.DRS_ROUTES["drs_components"]
        assert route == kernels.drs_layout(N, F, kw["n_resources"],
                                           kw["depth"])["route"]
        seen.add(route)
        for x, y in zip(want, got):
            assert y.dtype == x.dtype and torch.equal(y.cpu(), x), (N, F, kw)
    assert seen == {"staged", "walk"}


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
    for name, args, kw in tt.tas_cases(0, ("three_levels", "flat",
                                           "shuffled", "wide_runs")):
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


@pytest.mark.gpu
def test_cuda_tas_routes():
    """The descent kernels take the warp route on every level below the
    roots of a tree at the tas-4k shape (runs of at most 32 children in
    id order), the sort route on levels shuffled out of id order, both
    on the trees with runs of 33-128 children, and the warp route for a
    root split of at most 32 roots; each launch writes its routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops import tas_kernel
    below_roots = {"tas4k": {1}, "shuffled": {2}, "wide_runs": {1, 2}}
    for part, want in below_roots.items():
        seen = set()
        for name, args, kw in tt.tas_cases(0, (part,)):
            if name == "fill_counts":
                continue
            cuda = [tuple(torch.from_numpy(p).cuda() for p in a)
                    if isinstance(a, tuple) else torch.from_numpy(a).cuda()
                    if isinstance(a, np.ndarray) else a for a in args]
            getattr(tas_kernel, name)(*cuda, **kw)
            taken = kernels.TAS_ROUTES[name].cpu().tolist()
            sizes = kw["level_sizes"]
            if name == "split_across_roots":
                assert taken[0] == (1 if sizes[0] <= 32 else 2), taken
                first = 1
            else:
                first = kw["level"] + 1
                assert taken[:first] == [0] * first, taken   # not walked
            seen |= set(taken[first:len(sizes)])
        assert seen == want, (part, seen)


PHASE1 = ("kq_cq_avail", "kq_classify_heads", "kq_cycle_order")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_solve_cycle_kernels_match_plain(seed):
    """kq_cq_avail, kq_classify_heads and kq_cycle_order on the card
    against their plain versions on the CPU
    (kueue_tpu_torch.testing.solve_cycle_cases: N on both sides of 64,
    padding heads, uncovered and invalid slots, int32 wraps, ties and
    INT_MIN, lane groups and 40 slots on the loop route, the sort on its
    registers route and, past 16,384 heads, in global scratch): values
    and dtypes exactly."""
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
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_cq_avail_routes_match_plain(seed):
    """kq_cq_avail on its staged route (testing.avail_cases: depth 1, 2,
    3 and 17, one and two warps a CQ, cells at the int32 limits, N =
    12,288) and on its global route (N = 13,000) against cq_avail_plain:
    values and dtypes exactly, the route by N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    seen = set()
    for _, args, kw in tt.avail_cases(seed, card=True):
        want = cycle.cq_avail_plain(*[torch.from_numpy(a) for a in args],
                                    **kw)
        got = cycle.cq_avail(*[torch.from_numpy(a).cuda() for a in args],
                             **kw)
        torch.cuda.synchronize()
        route = kernels.PHASE1_ROUTES["kq_cq_avail"]
        assert route == kernels.cq_avail_route(args[0].shape[0])
        seen.add(route)
        for x, y in zip(want, got):
            assert y.dtype == x.dtype and torch.equal(y.cpu(), x), kw
    assert seen == {"staged", "global"}


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
        assert kernels.PHASE1_ROUTES["kq_cycle_order"] == "global"


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [32, 0], ids=["layout", "loop"])
def test_cuda_classify_routes_match_plain(lanes, monkeypatch):
    """kq_classify_heads on its lane groups and, with CLASSIFY_LANES = 0,
    on its loop route (a warp per head), over testing.SOLVE_SHAPES (40
    slots of one resource among them: two chunks of slots), with and
    without the decision pairs, equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    monkeypatch.setattr(kernels, "CLASSIFY_LANES", lanes)
    routes = set()
    for i, (n_cqs, n_coh, depth, S, R, F, W, n_valid) in enumerate(
            tt.SOLVE_SHAPES):
        case = tt.solve_cycle_planes(np.random.default_rng(i), n_cqs=n_cqs,
                                     n_cohorts=n_coh, depth=depth, S=S, R=R,
                                     F=F, W=W, n_valid=n_valid)
        for name, args, kw in tt.phase1_cases(case):
            if name != "kq_classify_heads":
                continue
            p = cycle.classify_heads_plain(
                *[torch.from_numpy(a) for a in args], **kw)
            c = cycle.classify_heads(
                *[torch.from_numpy(a).cuda() for a in args], **kw)
            for x, y in zip(p, c):
                assert y.dtype == x.dtype and torch.equal(y.cpu(), x), (S, R)
            routes.add(kernels.PHASE1_ROUTES["kq_classify_heads"])
    assert routes == ({"group", "loop"} if lanes else {"loop"})


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
    """With no shared memory allowed for the working set,
    admit_scan_forests keeps its rows and head lists in global scratch
    (every block with heads on the global route) and still equals its
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    monkeypatch.setattr(kernels, "FLAT_SMEM", 0)
    for name, args, kw in tt.kernel_cases(0):
        if name != "admit_scan_forests":
            continue
        p = cycle.admit_scan_forests_plain(
            *[torch.from_numpy(a) for a in args], **kw)
        c = kernels.admit_scan_forests(
            *[torch.from_numpy(a).cuda() for a in args], **kw)
        assert torch.equal(c.cpu(), p), kw
        routes = kernels.FLAT_ROUTES["admit_scan_forests"].cpu().tolist()
        assert {r for r in routes if r} == {2}, kw


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
def test_cuda_forest_scan_routes_match_plain(route, monkeypatch):
    """admit_scan_forests on the flat scan's layout, both routes, over
    tt.FOREST_SHAPES (a forest with heads past max_forest_wl among them)
    and a forest numbered outside the tables, against
    admit_scan_forests_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    if route == "global":
        monkeypatch.setattr(kernels, "FLAT_SMEM", 0)
    cases = [(args, kw) for name, args, kw in tt.kernel_cases(1)
             if name == "admit_scan_forests"]
    args, kw = cases[1]
    fon = args[-1].copy()
    fon[fon == fon[max(args[8][0], 0)]] = kw["n_forests"] + 3
    cases.append((args[:-1] + (fon,), kw))
    for args, kw in cases:
        want = cycle.admit_scan_forests_plain(
            *[torch.from_numpy(a) for a in args], **kw)
        got = kernels.admit_scan_forests(
            *[torch.from_numpy(a).cuda() for a in args], **kw)
        assert torch.equal(got.cpu(), want), (route, kw)
        routes = kernels.FLAT_ROUTES["admit_scan_forests"].cpu().tolist()
        assert {r for r in routes if r} == {1 if route == "shared" else 2}


@pytest.mark.gpu
@pytest.mark.parametrize("label", [c[0] for c in tt.SEARCH_ROUTE_CASES])
def test_cuda_search_layouts_match_plain(label):
    """minimal_preemptions_batch, a warp per search, over
    tt.search_route_cases (S = 13 with padding between real searches,
    K = 1,024, F = 40, a tree past shared memory, candidates past it,
    both) against minimal_preemptions_batch_plain, on the route its
    shapes give."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    _, args, kw, route = next(c for c in tt.search_route_cases(0)
                              if c[0] == label)
    want = preemption_kernel.minimal_preemptions_batch_plain(
        *[torch.from_numpy(a) for a in args], **kw)
    got = kernels.minimal_preemptions_batch(
        *[torch.from_numpy(a).cuda() for a in args], **kw)
    for x, y in zip(want, got):
        assert y.dtype == x.dtype and torch.equal(y.cpu(), x), label
    r = kernels.SEARCH_ROUTES
    taken = (r["tree"] if r["tree"] == r["candidates"]
             else "tree global" if r["tree"] == "global"
             else "candidates global")
    assert taken == route, (label, r)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,D", [(0, 1), (1, 3), (2, 9), (3, 12)])
def test_cuda_scatter_and_reduce_match_plain(seed, D):
    """kq_scatter_rows (13 planes in place from one packed buffer:
    padded duplicate rows, rows past the planes and below -C, a row in
    [-C, 0) written at C + r, 5-byte bool rows, 16-byte rows) and
    kq_reduce_dflags against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops.packing import pack_scatter_rows
    from kueue_tpu_torch.parallel import sharded
    planes, rows, vals = tt.scatter_case(seed, D=D)
    buf = torch.from_numpy(pack_scatter_rows(rows, vals))
    want = sharded.scatter_rows_plain(
        [torch.from_numpy(p.copy()) for p in planes], buf, len(rows))
    before = kernels.LAUNCHES["kq_scatter_rows"]
    got = sharded.scatter_rows(
        [torch.from_numpy(p).cuda() for p in planes], buf.cuda(), len(rows))
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
    # one packed upload and one launch per shard with dirty rows
    assert st["burst_resident_scatter_copies"] == grew["kq_scatter_rows"]
    assert grew["kq_scatter_rows"] <= 4 * st["burst_resident_hits"], st


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


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("tables", [False, True])
def test_cuda_flat_scan_routes_match_plain(route, tables, monkeypatch):
    """The forest-parallel admit_scan on both routes (the working set in
    shared memory, or with no shared memory allowed in global memory),
    with the caller's forest tables and with forests named by their
    roots, over the flat scan's layouts (tt.flat_scan_cases: interleaved
    forests, padding, reserve heads, one forest of every CQ, depth 17,
    F = 65, one forest past a block's shared memory) against
    admit_scan_plain; each block with heads reports its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    if route == "global":
        monkeypatch.setattr(kernels, "FLAT_SMEM", 0)
    for label, args, kw, (fon, nf) in tt.flat_scan_cases(0, card=True):
        want = cycle.admit_scan_plain(*[torch.from_numpy(a) for a in args],
                                      **kw)
        extra = (dict(forest_of_node=torch.from_numpy(fon).cuda(),
                      n_forests=nf) if tables else {})
        before = kernels.LAUNCHES["admit_scan"]
        got = kernels.admit_scan(*[torch.from_numpy(a).cuda() for a in args],
                                 **kw, **extra)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["admit_scan"] == before + 1, label
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), \
            (label, route, tables)
        routes = kernels.FLAT_ROUTES["admit_scan"].cpu()
        taken = {kernels.FLAT_ROUTE_NAMES[r] for r in routes.tolist() if r}
        expect = "global" if route == "global" or label == "over_smem" \
            else "shared"
        assert taken == {expect}, (label, taken)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
def test_cuda_burst_routes_match_plain(route, monkeypatch):
    """burst_cycles with its forest state in shared memory and, with none
    allowed, in its global rows, over the burst sweep and one forest of
    every CQ (tt.burst_one_forest), against burst_cycles_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    if route == "global":
        monkeypatch.setattr(kernels, "BURST_STATE_SMEM", 0)
    cases = list(tt.burst_cases(0)) + [("one_forest",
                                        *tt.burst_one_forest(0))]
    for label, args, kw in cases:
        cpu = [torch.from_numpy(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else int(a) for a in args]
        plain = burst.burst_cycles_plain(*cpu, **kw)
        cuda = burst.burst_cycles(*[a.cuda() if isinstance(a, torch.Tensor)
                                    else a for a in cpu], **kw)
        torch.cuda.synchronize()
        assert kernels.BURST_ROUTES["burst_cycles"] == route, label
        for i, (p, c) in enumerate(zip(_flat(plain), _flat(cuda))):
            assert c.dtype == p.dtype and c.shape == p.shape, (label, i)
            assert torch.equal(c.cpu(), p), (label, i)


def _preempt_cases():
    """(label, positional arrays, depth, tables or None): the preempt
    sweep with joined tables, then tt.preempt_route_cases (cohorts of
    five, nested forests, depth 17, F = 12, one forest, the cross-forest
    case joined) with their tables and, but the cross-forest case, with
    forests named by roots."""
    for i, (name, args, kw) in enumerate(tt.kernel_cases(0)):
        if name == "admit_scan_preempt":
            yield f"sweep_{i}", args, kw["depth"], tt.preempt_tables(args)
    for label, args, depth, tables in tt.preempt_route_cases(0):
        yield label, args, depth, tables
        if label != "cross_forest":
            yield label + "_roots", args, depth, None


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
def test_cuda_preempt_routes_match_plain(route, monkeypatch):
    """The warp-per-forest admit_scan_preempt with its three planes in
    shared memory and, with none allowed, in global memory, against
    admit_scan_preempt_plain: the sweep, cycles with the forest tables
    and by roots, the cross-forest case under joined tables; every
    block with heads reports its route and the error word stays 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    if route == "global":
        monkeypatch.setattr(kernels, "FLAT_SMEM", 0)
    for label, args, depth, tables in _preempt_cases():
        want = cycle.admit_scan_preempt_plain(
            *[torch.from_numpy(a) for a in args], depth=depth)
        extra = {}
        if tables is not None:
            extra = dict(forest_of_node=torch.from_numpy(tables[0]).cuda(),
                         n_forests=tables[1])
        error = torch.zeros(1, dtype=torch.int32, device="cuda")
        before = kernels.LAUNCHES["admit_scan_preempt"]
        got = kernels.admit_scan_preempt(
            *[torch.from_numpy(a).cuda() for a in args], depth=depth,
            error=error, **extra)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["admit_scan_preempt"] == before + 1, label
        assert int(error.item()) == 0, label
        for x, y in zip(want, got):
            assert y.dtype == x.dtype and torch.equal(y.cpu(), x), \
                (label, route)
        routes = kernels.FLAT_ROUTES["admit_scan_preempt"].cpu().tolist()
        taken = {kernels.FLAT_ROUTE_NAMES[r] for r in routes if r}
        if route == "global":
            assert taken == {"global"}, (label, taken)


@pytest.mark.gpu
def test_cuda_preempt_wrong_labels_raise():
    """A target outside its head's forest under the given tables (the
    cross-forest case with its own, unjoined labels) sets the error word
    and raises; it never decides silently."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    c = tt.cross_forest_case()
    args = [torch.from_numpy(a).cuda() for a in tt.preempt_args(c)]
    fon = torch.from_numpy(c["forest_of_node"]).cuda()
    with pytest.raises(RuntimeError, match="cohort forest"):
        kernels.admit_scan_preempt(*args, depth=c["depth"],
                                   forest_of_node=fon,
                                   n_forests=c["n_forests"])
    with pytest.raises(RuntimeError, match="cohort forest"):
        kernels.admit_scan_preempt(*args, depth=c["depth"])   # by roots
    error = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.admit_scan_preempt(*args, depth=c["depth"], forest_of_node=fon,
                               n_forests=c["n_forests"], error=error)
    assert int(error.item()) == 1
    with pytest.raises(RuntimeError, match="cohort forest"):
        kernels.check_preempt_error(error)


@pytest.mark.gpu
@pytest.mark.parametrize("W,S", [(1000, 2), (1000, 8), (100_000, 2),
                                 (100_000, 8)])
def test_cuda_merge_order_by_rank_matches_plain(W, S):
    """kq_fs_merge_order at 1,000 and 100,000 rounds (the keys in
    global scratch past MERGE_SMEM), permutations and a sequence that
    ends early, against fs_merge_order_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.parallel import sharded
    rng = np.random.default_rng(W + S)
    assert (13 * W > kernels.MERGE_SMEM) == (W == 100_000)
    for short in (False, True):
        winners, head_of = tt.merge_case(rng, W=W, S=S, short=short)
        cpu = (tuple(torch.from_numpy(w) for w in winners),
               tuple(torch.from_numpy(h) for h in head_of))
        want = sharded.fs_merge_order_plain(*cpu, W)
        got = kernels.kq_fs_merge_order(tuple(w.cuda() for w in cpu[0]),
                                        tuple(h.cuda() for h in cpu[1]), W)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 1000, 100_000])
def test_cuda_add_one_matches_plain(n):
    """kq_add_one, the router's round-trip probe, against ``x + 1`` on
    the probe's eight values and on seeded values that wrap at the int32
    limits; one launch a call, and the probe's round trip on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops import rtt
    rng = np.random.default_rng(n)
    x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    x[:2] = (2**31 - 1, -2**31)
    for a in (rtt.PROBE, x):
        want = rtt.add_one_plain(torch.from_numpy(a))
        before = kernels.LAUNCHES["kq_add_one"]
        got = rtt.add_one(torch.from_numpy(a).cuda())
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["kq_add_one"] == before + 1
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    assert (rtt.round_trip("cuda") == rtt.PROBE + 1).all()
    assert rtt.round_trip_s("cuda") > 0
