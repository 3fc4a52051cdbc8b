"""The launch path of the port's kernels and the host side of its two
mesh kernels, on the CPU.

- ``kernels._launch`` with a stub C function: no CUDA event is made, the
  launch is counted once, a nonzero status raises and counts nothing;
- ``kernels.launcher_of`` and ``profiling.DeviceClock``'s reading of the
  profiler's device activity (per kernel, other work, busy union);
- the head gather's source map (``CycleShardLayout.heads`` builds it):
  applied with numpy it gives what ``gather_heads_plain`` gives on the
  maps, for 1, 2, 8 and 32 shards, empty shards, heads in no shard, bool
  and int32 planes; ``gather_src_plain`` and the CPU route agree;
- ``CycleMesh.move`` of a list on the CPU hands the tensors back;
- the sharded burst's [S, K, 4] dirty-flag window summed by
  ``reduce_dflags`` against the JAX ``psum`` (kueue_tpu/ops/burst.py
  :789-790) on the conftest's virtual XLA CPU devices, wrapping values
  included.

Tolerance: exact, dtypes asserted (every value is an integer or a
bool)."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kueue_tpu_torch import kernels
from kueue_tpu_torch.parallel import sharded as tsh
from kueue_tpu_torch.profiling import DeviceClock

torch.set_num_threads(1)


def _same(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (label, a.dtype, b.dtype)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    assert np.array_equal(a, b), label


# -- the launch ----------------------------------------------------------

class _NoEvent:
    made = 0

    def __init__(self, *a, **kw):
        _NoEvent.made += 1
        raise AssertionError("a launch made a CUDA event")


@pytest.mark.parametrize("status", [0, 7])
def test_launch_makes_no_event_and_counts_once(monkeypatch, status):
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=1234))
    calls = []

    def c_fn(*args):
        calls.append(args)
        return status

    before = dict(kernels.LAUNCHES)
    if status:
        with pytest.raises(RuntimeError, match="status 7"):
            kernels._launch("kq_gather_heads", c_fn, 1, 2)
    else:
        kernels._launch("kq_gather_heads", c_fn, 1, 2)
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert grew["kq_gather_heads"] == (0 if status else 1)
    assert sum(grew.values()) == grew["kq_gather_heads"]
    assert _NoEvent.made == 0
    assert len(calls) == 1 and calls[0][:2] == (1, 2)
    assert calls[0][2].value == 1234        # the current stream, last


def test_every_kernel_symbol_names_its_launcher():
    for sym, name in kernels.SYMBOLS.items():
        assert kernels.launcher_of(f"{sym}(int, int*)") == name
        assert kernels.launcher_of(f"void {sym}<64>(GatherSlots<64>)") == name
        assert kernels.launcher_of(
            f"void (anonymous namespace)::{sym}<3>(Args)") == name
        assert kernels.launcher_of(
            f"(anonymous namespace)::{sym}(BurstArgs)") == name
    assert set(kernels.SYMBOLS.values()) == set(kernels.KERNELS)
    for other in ("Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
                  "void at::native::vectorized_elementwise_kernel<4>()",
                  "at::cuda::(anonymous namespace)::spin_kernel(long)"):
        assert kernels.launcher_of(other) is None


def test_device_clock_reads_kernels_other_work_and_busy_union():
    from torch.autograd import DeviceType

    def ev(name, t0, t1, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=t0, end=t1))

    clk = DeviceClock()
    clk._read([
        ev("kq_reduce_dflags_kernel(int4 const*, int, int, int4*)", 0, 2),
        ev("void kq_gather_heads_kernel<8>(GatherSlots<8>)", 1, 4),
        ev("Memcpy HtoD (Pinned -> Device)", 10, 13),
        ev("kq_reduce_dflags_kernel(int4 const*, int, int, int4*)", 12, 14),
        ev("aten::add", 0, 100, DeviceType.CPU),
    ])
    assert clk.kernel_count["kq_reduce_dflags"] == 2
    assert clk.kernel_ms["kq_reduce_dflags"] == pytest.approx(4e-3)
    assert clk.kernel_ms["kq_gather_heads"] == pytest.approx(3e-3)
    assert clk.other_ms == pytest.approx(3e-3)
    assert clk.busy_ms == pytest.approx(8e-3)   # [0, 4] and [10, 14]
    assert clk.activities == 4


# -- the head gather's source map --------------------------------------

def _structure(n_forests: int, per: int = 2):
    """``n_forests`` cohorts of ``per`` CQs: parent [C + G], C."""
    C = n_forests * per
    parent = np.concatenate([C + np.arange(C) // per,
                             np.full(n_forests, -1)]).astype(np.int32)
    return parent, C


def _np_apply(planes, src, fills):
    """out[p][w] = planes[p][l][r] for src[w] = l << SRC_SHIFT | r."""
    hit = src >= 0
    slot = src[hit] >> kernels.SRC_SHIFT
    row = src[hit] & ((1 << kernels.SRC_SHIFT) - 1)
    out = []
    for blocks, fill in zip(planes, fills):
        off = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
        o = np.full(len(src), fill, dtype=blocks[0].dtype)
        o[hit] = np.concatenate(blocks)[off[slot] + row]
        out.append(o)
    return out


# (shards, forests, heads, heads routed): more shards than forests,
# fewer heads than shards, every head routed
SRC_CASES = [(1, 5, 50, 40), (2, 7, 40, 31), (8, 40, 60, 3),
             (8, 9, 100, 100), (32, 12, 100, 70), (32, 64, 300, 280)]


@pytest.mark.parametrize("dtypes", [("bool", "int32"), ("int32",),
                                    ("bool", "bool", "bool")])
@pytest.mark.parametrize("n_shards,n_forests,W,n_routed", SRC_CASES)
def test_source_map_gives_gather_heads_plain(n_shards, n_forests, W,
                                             n_routed, dtypes):
    rng = np.random.default_rng(n_shards * 1000 + W)
    parent, C = _structure(n_forests)
    layout = tsh.CycleShardLayout(parent, C, n_shards)
    wl_cq = rng.integers(0, C, W).astype(np.int32)
    routed = np.zeros(W, dtype=bool)
    routed[rng.choice(W, n_routed, replace=False)] = True
    wl_cq[~routed & (rng.random(W) < 0.5)] = -1     # heads in no shard
    heads = layout.heads(wl_cq, routed)
    src = layout.src
    live = [heads[s] for s in layout.live]
    assert src.dtype == np.int32 and src.shape == (W,)
    assert int((src >= 0).sum()) == n_routed
    assert len(live) == n_shards - layout.empty_shards
    if n_shards > n_forests or n_routed < n_shards:
        assert layout.empty_shards > 0
    planes, fills = [], []
    for dt in dtypes:
        if dt == "bool":
            planes.append(tuple(rng.random(len(h)) < 0.5 for h in live))
            fills.append(False)
        else:
            planes.append(tuple(rng.integers(-9, 99, len(h)).astype(
                np.int32) for h in live))
            fills.append(-1)
    t_planes = tuple(tuple(torch.from_numpy(b) for b in p) for p in planes)
    want = tsh.gather_heads_plain(t_planes,
                                  tuple(torch.from_numpy(h) for h in live),
                                  W, fills)
    t_src = torch.from_numpy(src)
    for w, got_np, got_src, got_route in zip(
            want, _np_apply(planes, src, fills),
            tsh.gather_src_plain(t_planes, t_src, fills),
            tsh.gather_heads(t_planes, t_src, fills)):
        _same(w.numpy(), got_np, "numpy")
        _same(w.numpy(), got_src.numpy(), "gather_src_plain")
        _same(w.numpy(), got_route.numpy(), "gather_heads")
    _same(src, tsh.source_map(live, W), "source_map")
    for m, h in zip(tsh.maps_of_source(t_src, [len(h) for h in live]), live):
        _same(h, m.numpy(), "maps_of_source")


def test_move_of_a_list_on_the_cpu_hands_back_the_tensors():
    with tsh.virtual_mesh("cpu", 4):
        mesh = tsh.make_mesh(4)
    ts = (torch.arange(3), torch.zeros(2, dtype=torch.bool))
    moved = mesh.move(ts, 1, 0)
    assert isinstance(moved, list) and len(moved) == 2
    assert all(a is b for a, b in zip(moved, ts))


# -- the dirty-flag window ----------------------------------------------

def _psum(window: np.ndarray) -> np.ndarray:
    try:
        from jax import shard_map
    except ImportError:     # older JAX
        from jax.experimental.shard_map import shard_map
    S, K = window.shape[:2]
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("cq",))
    psum = jax.jit(shard_map(lambda x: jax.lax.psum(x, "cq"), mesh=mesh,
                             in_specs=P("cq"), out_specs=P()))
    return np.asarray(psum(jnp.asarray(window.reshape(S * K, 4))))


@pytest.mark.parametrize("wrap", [False, True], ids=["flags", "wrap"])
@pytest.mark.parametrize("S,K", [(1, 32), (2, 32), (4, 32), (8, 32),
                                 (3, 7), (8, 1)])
def test_window_reduction_matches_jax_psum(S, K, wrap):
    rng = np.random.default_rng(S * 100 + K)
    if wrap:
        window = rng.integers(2**31 - 9, 2**31, (S, K, 4)).astype(np.int32)
        window[:, :, 1] = -2**31 + rng.integers(0, 5, (S, K))
    else:
        window = (rng.random((S, K, 4)) < 0.2).astype(np.int32)
        window[:, :, 3] = 0
    want = _psum(window)
    got = tsh.reduce_dflags(torch.from_numpy(window))
    _same(want, got.numpy(), "reduce_dflags")
    _same(want, tsh.reduce_dflags_plain(torch.from_numpy(window)).numpy(),
          "reduce_dflags_plain")
