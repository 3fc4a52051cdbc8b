"""The one-call cycle solvers: kueue_tpu_torch.ops.cycle ``solve_cycle`` /
``solve_cycle_forests`` (and ``add_usage_chain_batched``,
``cycle_order_plain``) against the JAX package's kueue_tpu.ops.cycle on
the same numpy inputs — exact equality of every output's values and
dtype.  Inputs: the packed first cycle of the entry scenario (plain,
contended, preemption), the north-star probe's synthetic cycle on both
sides of N = 64, seeded random planes with the FlavorFungibility
arguments set, int32-wrapping requests and INT_MIN priorities, and the
float32-timestamp case.  Shapes are fixed per test and seeds vary, so
JAX compiles once per shape.  The CUDA kernels are held against the
plain versions in tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.ops import cycle as jc
from kueue_tpu_torch import scenarios
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import cycle as tc
from kueue_tpu_torch.parallel import cycle_args

torch.set_num_threads(1)


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _same(jax_out, torch_out):
    assert len(jax_out) == len(torch_out) == 6
    for a, b in zip(jax_out, torch_out):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        assert np.array_equal(a, b), (a.astype(int), b.astype(int))


@pytest.mark.parametrize("run_scan", [True, False])
@pytest.mark.parametrize("kw", [{}, dict(contended=True),
                                dict(contended=True, preemption=True)],
                         ids=["plain", "contended", "preemption"])
def test_entry_packed_cycle_matches_jax(kw, run_scan):
    import __graft_entry__ as ge
    from kueue_tpu.parallel import cycle_args as j_cycle_args
    _, _, _, jpacked = ge._packed_cycle(**kw)
    _, _, _, packed = scenarios.packed_cycle(device="cpu", **kw)
    jargs = j_cycle_args(jpacked)
    targs = cycle_args(packed, device="cpu")
    for a, b in zip(jargs, targs):     # the same planes in both packages
        assert np.array_equal(np.asarray(a, dtype=b.numpy().dtype),
                              b.numpy())
    out = tc.solve_cycle(*targs, depth=packed.depth, run_scan=run_scan)
    _same(jc.solve_cycle(*jargs, depth=jpacked.depth, run_scan=run_scan),
          out)
    _same(jc.solve_cycle(*jargs, depth=jpacked.depth, run_scan=run_scan),
          tc.solve_cycle_plain(*targs, depth=packed.depth,
                               run_scan=run_scan))
    if run_scan:
        assert out[0].any()


def test_entry_step_runs_on_cpu():
    import __graft_entry__ as ge
    step, args = scenarios.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    jstep, jargs = ge.entry()
    _same(jstep(*jargs), step(*args))


# (W, C, cohorts): N = C + cohorts on both sides of 64
PROBE_SHAPES = [(256, 16, 4), (256, 80, 8)]


@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_probe_synth_matches_jax(shape):
    W, C, cohorts = shape
    for seed in (0, 1):
        args, depth = scenarios.probe_synth(W=W, C=C, cohorts=cohorts,
                                            seed=seed)
        for run_scan in (True, False):
            _same(jc.solve_cycle(*args, depth=depth, run_scan=run_scan),
                  tc.solve_cycle(*_t(args), depth=depth, run_scan=run_scan))


@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_probe_forests_match_jax(shape):
    """The probe's three calls (kueue_tpu_torch.probe.probe_calls) at a
    small size, the forest scan included."""
    from kueue_tpu_torch.probe import probe_calls
    W, C, cohorts = shape
    for label, name, args, kw in probe_calls(W, C, cohorts):
        _same(getattr(jc, name)(*args, **kw),
              getattr(tc, name)(*_t(args), **kw))


# (n_cqs, n_cohorts, depth, S, R, F, W, n_valid)
FUNG_SHAPE = (12, 4, 3, 3, 2, 6, 64, 50)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fungibility_arguments_match_jax(seed):
    """cq_wcb_borrow, cq_wcp_preempt and a nonzero start_slot, passed
    positionally and by keyword; slots with slot_fr = -1 and invalid
    slots; padding heads; requests whose use + req wraps int32; INT_MIN
    priorities and float32 timestamp ties."""
    n_cqs, n_coh, depth, S, R, F, W, n_valid = FUNG_SHAPE
    c = tt.solve_cycle_planes(np.random.default_rng(seed), n_cqs=n_cqs,
                              n_cohorts=n_coh, depth=depth, S=S, R=R, F=F,
                              W=W, n_valid=n_valid)
    assert c["start_slot"].any() and not c["cq_wcb_borrow"].all()
    args = tt.solve_args(c, fungibility=True)
    for run_scan in (True, False):
        ref = jc.solve_cycle(*args, depth=c["depth"], run_scan=run_scan)
        _same(ref, tc.solve_cycle(*_t(args), depth=c["depth"],
                                  run_scan=run_scan))
        names = tt.FUNGIBILITY_ARGS
        kw = dict(zip(names, _t(args[14:])))
        _same(ref, tc.solve_cycle(*_t(args[:14]), depth=c["depth"],
                                  run_scan=run_scan, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_planes_match_jax(seed):
    """N > 64 with F = 12 and the int32 wrap of usage near INT_MAX."""
    c = tt.solve_cycle_planes(np.random.default_rng(seed), n_cqs=80,
                              n_cohorts=10, S=4, R=3, F=12, W=256,
                              n_valid=240)
    args = tt.solve_args(c, fungibility=True)
    _same(jc.solve_cycle(*args, depth=c["depth"]),
          tc.solve_cycle(*_t(args), depth=c["depth"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_cycle_forests_drops_heads_past_max_forest_wl(seed):
    c = tt.solve_cycle_planes(np.random.default_rng(seed), n_cqs=24,
                              n_cohorts=3, depth=2, S=2, R=2, F=4, W=64,
                              n_valid=60, big=False, fungibility=False)
    largest = c["max_forest_wl"] - 1
    assert largest > 4
    args = tt.solve_args(c) + (c["forest_of_node"],)
    for mfw in (4, largest + 1):
        kw = dict(depth=c["depth"], n_forests=c["n_forests"],
                  max_forest_wl=mfw)
        ref = jc.solve_cycle_forests(*args, **kw)
        _same(ref, tc.solve_cycle_forests(*_t(args), **kw))
        _same(ref, tc.solve_cycle_forests_plain(*_t(args), **kw))
    # with room for every head the forest scan decides as the flat one
    flat = tc.solve_cycle(*_t(args[:14]), depth=c["depth"])
    _same(ref, flat)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_usage_chain_batched_matches_jax(seed):
    rng = np.random.default_rng(seed)
    parent, forest_of, n_forests, depth = tt.forest(rng, 24, 6, 3)
    q = tt.quota_planes(rng, 30, 3)
    # one chain per forest (disjoint), a few no-ops
    nodes = np.full(n_forests + 2, -1, dtype=np.int32)
    for f in range(n_forests):
        cqs = np.nonzero(forest_of[:24] == f)[0]
        if len(cqs) and rng.random() < 0.8:
            nodes[f] = rng.choice(cqs)
    deltas = rng.integers(0, 25, (len(nodes), 3)).astype(np.int32)
    ref = jc.add_usage_chain_batched(
        jnp.asarray(q["usage0"]), jnp.asarray(nodes), jnp.asarray(deltas),
        jnp.asarray(q["guaranteed"]), jnp.asarray(parent), depth)
    got = tc.add_usage_chain_batched(*_t((q["usage0"], nodes, deltas,
                                          q["guaranteed"], parent)), depth)
    assert np.asarray(ref).dtype == got.numpy().dtype
    assert np.array_equal(np.asarray(ref), got.numpy())
    assert not np.array_equal(got.numpy(), q["usage0"])


def _two_heads(timestamps, priorities=(5, 5)):
    """Two heads on one CQ whose capacity admits only one."""
    args, depth = scenarios.probe_synth(W=2, C=1, S=1, R=1, cohorts=1)
    args = [np.array(a) for a in args]
    args[0][:] = 0                 # usage0
    args[1][:] = 1000              # subtree
    args[2][:] = 0                 # guaranteed
    args[6][:] = 1000              # nominal
    args[11][:] = 1000             # requests
    args[12] = np.asarray(priorities, dtype=np.int32)
    args[13] = np.asarray(timestamps, dtype=np.float64)
    return args, depth


def test_float32_timestamps_decide_the_order():
    """JAX runs without x64: 1e9 + 1 and 1e9 tie as float32, so index
    order admits head 0, where the float64 order (the host's
    cycle_order_np) would admit head 1."""
    args, depth = _two_heads([1e9 + 1, 1e9])
    ref = jc.solve_cycle(*args, depth=depth)
    assert np.asarray(ref[0]).tolist() == [True, False]
    assert tc.cycle_order_np(np.zeros(2, bool), args[12],
                             args[13]).tolist() == [1, 0]
    _same(ref, tc.solve_cycle(*_t(args), depth=depth))
    _same(ref, tc.solve_cycle_plain(*_t(args), depth=depth))
    # a float64 tensor is cast on entry, as the jit boundary casts it
    assert _t(args)[13].dtype == torch.float64


def test_int_min_priority():
    """-INT_MIN wraps to INT_MIN in int32, so a head of priority INT_MIN
    sorts before a head of priority 0 (both packages)."""
    args, depth = _two_heads([2.0, 1.0], priorities=(-2**31, 0))
    ref = jc.solve_cycle(*args, depth=depth)
    assert np.asarray(ref[0]).tolist() == [True, False]
    _same(ref, tc.solve_cycle(*_t(args), depth=depth))


@pytest.mark.parametrize("W", [1, 7, 300])
def test_cycle_order_matches_lexsort(W):
    """cycle_order_plain against jnp.lexsort on float32 keys with -0.0,
    +0.0, NaN, -inf and ties, and priorities with INT_MIN and INT_MAX."""
    borrows, prio, ts = tt.order_case(np.random.default_rng(W), W)
    ref = jnp.lexsort((jnp.arange(W), jnp.asarray(ts), -jnp.asarray(prio),
                       jnp.asarray(borrows).astype(jnp.int32)))
    got = tc.cycle_order_plain(*_t((borrows, prio, ts)))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(ref), got.numpy())
