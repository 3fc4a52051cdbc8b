"""The port's topology-aware-scheduling programs against the JAX
package's: kueue_tpu_torch.ops.tas_kernel's plain PyTorch versions
(``fill_counts``, ``best_fit_descend``, ``split_across_roots``) and
kueue_tpu.ops.tas_kernel's jitted programs (XLA on the CPU, as
tests/test_tas_kernel.py runs them) on the same seeded inputs
(kueue_tpu_torch.testing.tas_cases), exact in values and dtypes."""

import random

import numpy as np
import pytest
import torch

from kueue_tpu.cache.tas_cache import NodeInfo as JNodeInfo
from kueue_tpu.cache.tas_snapshot import TASFlavorSnapshot as JSnapshot
from kueue_tpu.ops import tas_kernel as jtk
from kueue_tpu_torch import kernels
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.api.types import PodSetTopologyRequest
from kueue_tpu_torch.cache.tas_cache import NodeInfo
from kueue_tpu_torch.cache.tas_snapshot import TASFlavorSnapshot
from kueue_tpu_torch.ops import tas_kernel as ptk

JAX = {"fill_counts": jtk.fill_counts,
       "best_fit_descend": jtk.best_fit_descend,
       "split_across_roots": jtk.split_across_roots}
PLAIN = {"fill_counts": ptk.fill_counts_plain,
         "best_fit_descend": ptk.best_fit_descend_plain,
         "split_across_roots": ptk.split_across_roots_plain}
ROUTED = {"fill_counts": ptk.fill_counts,
          "best_fit_descend": ptk.best_fit_descend,
          "split_across_roots": ptk.split_across_roots}


def _torch(args):
    return [tuple(torch.from_numpy(p) for p in a) if isinstance(a, tuple)
            else torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _assert_same(jax_out, port_out, what):
    assert len(jax_out) == len(port_out), what
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        p = p.numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, (what, p.dtype,
                                                           j.dtype)
        assert np.array_equal(p, j), (what, p, j)


def _run(name, args, kw):
    jax_out = JAX[name](*args, **kw)
    plain = PLAIN[name](*_torch(args), **kw)
    _assert_same(jax_out, plain, (name, kw))
    return jax_out, plain


@pytest.mark.parametrize("part", tt.TAS_PARTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax(seed, part):
    """Every function, level, profile (Mixed's unconstrained variant
    included), request shape and count of the seeded sweep: 1-3 levels,
    ragged trees, ties, zero capacities, nothing requested, a resource no
    leaf has, a count above the total and 0, a wrapping int32 sum and a
    flat level of 80 roots."""
    n = 0
    for name, args, kw in tt.tas_cases(seed, (part,)):
        _run(name, args, kw)
        n += 1
    assert n > 0


def test_routed_cpu_functions_run_the_plain_versions():
    """numpy inputs with device="cpu" (and CPU tensors) run the plain
    versions, launch nothing, and agree with the JAX programs; the
    launchers refuse CPU tensors."""
    before = dict(kernels.LAUNCHES)
    cases = list(tt.tas_cases(0, ("three_levels",)))
    for name, args, kw in cases[::7]:
        jax_out = JAX[name](*args, **kw)
        _assert_same(jax_out, ROUTED[name](*args, **kw, device="cpu"), name)
        _assert_same(jax_out, ROUTED[name](*_torch(args), **kw), name)
    assert kernels.LAUNCHES == before
    name, args, kw = cases[1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.best_fit_descend(*_torch(args), **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.fill_counts(*_torch(cases[0][1]), **cases[0][2])
    with pytest.raises(ValueError, match="profile"):
        ptk.best_fit_descend(*args, level_sizes=kw["level_sizes"], level=0,
                             profile="worstfit", device="cpu")


def test_ties_break_by_id_and_reverse_under_leastfree():
    """Four equal roots: one pod goes to the lowest index, except under
    LeastFree, whose walk runs ties in id-descending order; the single
    best domain breaks ties by index under every profile."""
    leaf_free = np.full((4, 1), 8, np.int32)
    per_pod = np.ones(1, np.int32)
    got = {}
    for profile in ptk.PROFILES:
        args, kw = (leaf_free, per_pod, (), 1), dict(level_sizes=(4,),
                                                     profile=profile)
        _, (ok, counts) = _run("split_across_roots", args, kw)
        got[profile] = counts.tolist()
        _, (ok, counts) = _run("best_fit_descend", args, dict(kw, level=0))
        assert bool(ok) and counts.tolist() == [1, 0, 0, 0], profile
    assert got == {"bestfit": [1, 0, 0, 0], "mostfree": [1, 0, 0, 0],
                   "leastfree": [0, 0, 0, 1]}
    # 11 pods over roots of 8: BestFit gives the remainder of 3 to the
    # tightest fitting root, the greedy profiles to the next in order
    args = (leaf_free, per_pod, (), 11)
    _, (_, counts) = _run("split_across_roots", args,
                          dict(level_sizes=(4,), profile="bestfit"))
    assert counts.tolist() == [8, 3, 0, 0]
    _, (_, counts) = _run("split_across_roots", args,
                          dict(level_sizes=(4,), profile="leastfree"))
    assert counts.tolist() == [0, 0, 3, 8]


def test_count_edges_and_empty_requests():
    """A count above the total fails with zero counts; a count of 0
    succeeds with zero counts; nothing requested gives every domain a
    state of 0."""
    leaf_free, per_pod, parents, sizes = tt.tas_wrap_case()
    leaf_free = np.minimum(leaf_free, 9)
    total = int(leaf_free.sum())
    for count, want_ok in ((total + 1, False), (0, True)):
        for name in ("best_fit_descend", "split_across_roots"):
            kw = dict(level_sizes=sizes)
            if name == "best_fit_descend":
                kw["level"] = 0
            _, (ok, counts) = _run(name, (leaf_free, per_pod, parents,
                                          count), kw)
            assert bool(ok) == want_ok and not counts.any(), (name, count)
    _, states = _run("fill_counts", (leaf_free, np.zeros(1, np.int32),
                                     parents), dict(level_sizes=sizes))
    assert all(not s.any() for s in states)


def test_wrapping_sums_match_xla():
    """Leaves of 2**31 - 1 pods: the level sums and the root total wrap
    as XLA's int32 adds do."""
    leaf_free, per_pod, parents, sizes = tt.tas_wrap_case()
    _, states = _run("fill_counts", (leaf_free, per_pod, parents),
                     dict(level_sizes=sizes))
    assert states[0].tolist() == [3, -2**31 + 2]
    for count in range(7):
        _run("split_across_roots", (leaf_free, per_pod, parents, count),
             dict(level_sizes=sizes, profile="bestfit"))


def _snapshots(seed):
    """The same nodes as a snapshot of each package."""
    rng = random.Random(seed)
    specs = []
    for b in range(3):
        for r in range(rng.randint(1, 3)):
            for h in range(rng.randint(1, 4)):
                specs.append((f"n-{b}-{r}-{h}",
                              {"block": f"b{b}", "rack": f"r{b}-{r}",
                               "host": f"h{b}-{r}-{h}"},
                              {"cpu": rng.choice([0, 4000, 8000]),
                               "tpu": rng.choice([0, 4, 8])}))
    levels = ["block", "rack", "host"]
    port = TASFlavorSnapshot.build(
        "f", levels, [NodeInfo(name=n, labels=lb, capacity=dict(c))
                      for n, lb, c in specs], {})
    ref = JSnapshot.build(
        "f", levels, [JNodeInfo(name=n, labels=lb, capacity=dict(c))
                      for n, lb, c in specs], {})
    return port, ref


@pytest.mark.parametrize("seed", [3, 4])
def test_pack_tas_is_the_reference_packing(seed):
    port, ref = _snapshots(seed)
    a, b = ptk.pack_tas(port), jtk.pack_tas(ref)
    assert a.level_sizes == b.level_sizes
    assert a.resource_names == b.resource_names
    assert a.leaf_ids == b.leaf_ids and a.domain_ids == b.domain_ids
    assert np.array_equal(a.leaf_free, b.leaf_free)
    assert a.leaf_free.dtype == b.leaf_free.dtype == np.int32
    for p, q in zip(a.parents, b.parents):
        assert np.array_equal(p, q) and p.dtype == q.dtype
    planes = ptk.tas_planes(a, "cpu")
    assert len(planes) == len(a.parents)
    for t, p in zip(planes, a.parents):
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), p)


@pytest.mark.parametrize("seed", [3, 4])
def test_snapshot_queries_on_cpu_match_the_reference(seed):
    """find_topology_assignment of a CPU snapshot (the plain versions)
    and of the JAX package's snapshot: the same assignments and messages
    for every request shape, an unknown resource and counts 0-40."""
    port, ref = _snapshots(seed)
    port.device = "cpu"
    requests = [dict(required="rack"), dict(required="block"),
                dict(preferred="host"), dict(preferred="rack"),
                dict(unconstrained=True), {}]
    from kueue_tpu.api.types import PodSetTopologyRequest as JRequest
    for req in requests:
        for per_pod in ({"cpu": 2000}, {"cpu": 1000, "tpu": 1},
                        {"cpu": 1000, "gpu": 1}):
            for count in (0, 1, 3, 7, 40):
                a, ma = port.find_topology_assignment(
                    count, per_pod, PodSetTopologyRequest(**req))
                b, mb = ref.find_topology_assignment(count, per_pod,
                                                     JRequest(**req))
                assert ma == mb, (req, per_pod, count)
                assert (a is None) == (b is None), (req, per_pod, count)
                if a is not None:
                    assert [(d.values, d.count) for d in a.domains] == [
                        (d.values, d.count) for d in b.domains]


def test_per_pod_above_int32_raises_in_both():
    """A per-pod request above 2**31 - 1 (memory in bytes) does not fit
    the int32 per-pod vector of _find_device: both packages raise
    OverflowError, a limit of the reference the port keeps."""
    from kueue_tpu.api.types import PodSetTopologyRequest as JRequest
    specs = [(f"n{i}", {"rack": f"r{i // 2}", "host": f"h{i}"},
              {"cpu": 8000, "memory": 2**40}) for i in range(4)]
    port = TASFlavorSnapshot.build(
        "f", ["rack", "host"], [NodeInfo(name=n, labels=lb, capacity=c)
                                for n, lb, c in specs], {})
    ref = JSnapshot.build(
        "f", ["rack", "host"], [JNodeInfo(name=n, labels=lb, capacity=c)
                                for n, lb, c in specs], {})
    port.device = "cpu"
    per_pod = {"cpu": 1000, "memory": 2**31}
    with pytest.raises(OverflowError):
        ref.find_topology_assignment(1, per_pod, JRequest(required="rack"))
    with pytest.raises(OverflowError):
        port.find_topology_assignment(
            1, per_pod, PodSetTopologyRequest(required="rack"))
    ok, _ = port.find_topology_assignment(
        1, {"cpu": 1000, "memory": 2**31 - 1},
        PodSetTopologyRequest(required="rack"))
    assert ok is not None
