"""The Hopper designs of ``kq_cq_avail`` and ``kq_scatter_rows``
against the JAX package, on the CPU.

- ``kq_cq_avail`` (kernels/solve_cycle.cu, staged route): every block
  stages ``parent``, each thread (the F cells of a CQ in one warp)
  resolves its CQ's chain from the staged copy a segment at a time (the
  depth rounded up to 1, 2, 4, 8 or 16 levels), gathers every level's
  five cells in one step and folds top-down, emulated in torch step by
  step, against JAX ``available_all`` for usage0 and for zero usage,
  with wrapping int32 (cells at the int32 limits), at depth 1, 2, 3, 6
  and 17.
- ``kq_scatter_rows`` (kernels/scatter_rows.cu): the packed buffer
  (``ops.packing.pack_scatter_rows``: every segment 16-byte aligned) and
  ``parallel.sharded.scatter_rows_plain`` on it against JAX
  ``BurstSolver._scatter_rows_fn``, with padded duplicate rows, 5-byte
  bool rows, 16-byte rows and a row past the planes; the resident drain
  uploads one buffer per shard with dirty rows.

Exact in values and dtypes; every case is its own parametrised test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.ops import burst as jburst
from kueue_tpu.ops.quota_kernel import available_all as javailable
from kueue_tpu_torch import kernels as tkernels
from kueue_tpu_torch import scenarios
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops.packing import pack_scatter_rows, scatter_layout
from kueue_tpu_torch.parallel import sharded as tsh

THREADS = 256            # KQ_AVAIL_THREADS in solve_cycle.cu


def w32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value that wrapping arithmetic gives."""
    return ((x + 2**31) % 2**32) - 2**31


def avail_cells(C: int, F: int):
    """The staged route's cell of every thread of its grid → (c, f) of
    the live threads, as the launcher and the kernel map them: the F
    cells of a CQ in one warp, 32 // F CQs a warp for F <= 32, else
    ceil(F / 32) warps a CQ."""
    per, wpc = (32 // F, 1) if F <= 32 else (1, -(-F // 32))
    warps = -(-C // per) if F <= 32 else C * wpc
    T = -(-warps * 32 // THREADS) * THREADS
    g = torch.arange(T)
    warp, lane = g // 32, g % 32
    if F <= 32:
        c, f, live = warp * per + lane // F, lane % F, lane < per * F
    else:
        c, f = warp // wpc, (warp % wpc) * 32 + lane
        live = f < F
    live &= c < C
    return c[live], f[live]


def avail_step(root, sub, g, bc, hb, u, a, p):
    """kq_avail_step on int64 tensors holding int32 values."""
    pa = torch.where(hb, torch.minimum(
        w32(bc - torch.clamp(w32(u - g), min=0)), a), a)
    pp = torch.where(hb, torch.minimum(
        w32(bc - torch.clamp(w32(-g), min=0)), p), p)
    na = torch.where(root, w32(sub - u),
                     w32(torch.clamp(w32(g - u), min=0) + pa))
    np_ = torch.where(root, sub, w32(torch.clamp(g, min=0) + pp))
    return na, np_


def emu_cq_avail_staged(usage0, subtree, guaranteed, borrow_cap, has_blim,
                        parent, *, n_cqs: int, depth: int):
    """The staged kq_cq_avail → (avail0, potential0) [C, F] int32."""
    N, F = usage0.shape
    SEG = tkernels.cq_avail_segment(depth)
    c, f = avail_cells(n_cqs, F)
    written = torch.zeros((n_cqs, F), dtype=torch.int64)
    written.index_put_((c, f), torch.ones_like(c), accumulate=True)
    assert bool((written == 1).all()), "a cell not written exactly once"
    s_par = parent.clone()                        # the block's staged copy
    planes = [x.reshape(-1).long() for x in (usage0, subtree, guaranteed,
                                             borrow_cap, has_blim)]
    a = torch.zeros(c.shape[0], dtype=torch.int64)
    p = torch.zeros_like(a)
    for lo in range(((depth - 1) // SEG) * SEG, -1, -SEG):
        n_seg = min(depth - lo, SEG)
        n = c.clone()
        for _ in range(lo):
            n = torch.where(n >= 0, s_par[n.clamp(min=0)].long(), -1)
        nodes, roots = [], []
        for i in range(SEG):                      # the chain from smem
            live = (n >= 0) & (i < n_seg)
            up = torch.where(live, s_par[n.clamp(min=0)].long(), -1)
            nodes.append(torch.where(live, n, -1))
            roots.append(up < 0)
            n = up
        node, root = torch.stack(nodes, 1), torch.stack(roots, 1)
        o = node.clamp(min=0) * F + f[:, None]    # every level's cells:
        u, sub, g, bc, hb = (x[o] for x in planes)   # one gather each
        for i in range(SEG - 1, -1, -1):          # the fold, top-down
            na, np_ = avail_step(root[:, i], sub[:, i], g[:, i], bc[:, i],
                                 hb[:, i] != 0, u[:, i], a, p)
            m = node[:, i] >= 0
            a, p = torch.where(m, na, a), torch.where(m, np_, p)
    out = []
    for x in (a, p):
        y = torch.empty((n_cqs, F), dtype=torch.int32)
        y[c, f] = x.to(torch.int32)
        out.append(y)
    return tuple(out)


def _jax_avail(planes, n_cqs, depth):
    q = [jnp.asarray(x) for x in planes]
    return (np.asarray(javailable(*q, depth))[:n_cqs],
            np.asarray(javailable(jnp.zeros_like(q[0]), *q[1:],
                                  depth))[:n_cqs])


def _check_avail(planes, kw):
    want = _jax_avail(planes, kw["n_cqs"], kw["depth"])
    got = emu_cq_avail_staged(*[torch.from_numpy(np.ascontiguousarray(x))
                                for x in planes], **kw)
    for w, g, label in zip(want, got, ("avail0", "potential0")):
        assert g.dtype == torch.int32 and w.dtype == np.int32, label
        np.testing.assert_array_equal(g.numpy(), w, err_msg=label)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("row", range(len(tt.AVAIL_SHAPES)))
def test_staged_cq_avail_matches_jax(row, seed):
    """Forests at depth 1, 2, 3 and 17, one or two warps a CQ, cells at
    the int32 limits: usage0 and zeros."""
    planes, kw = tt.avail_case(np.random.default_rng(seed),
                               *tt.AVAIL_SHAPES[row])
    _check_avail(planes, kw)


@pytest.mark.parametrize("row", range(len(tt.SOLVE_SHAPES)))
def test_staged_cq_avail_on_solve_cycle_planes(row):
    """The solve-cycle planes (usage near INT_MAX in some CQ cells)."""
    n_cqs, n_coh, depth, S, R, F, W, n_valid = tt.SOLVE_SHAPES[row]
    c = tt.solve_cycle_planes(np.random.default_rng(row), n_cqs=n_cqs,
                              n_cohorts=n_coh, depth=depth, S=S, R=R, F=F,
                              W=W, n_valid=n_valid)
    _check_avail([c[k] for k in tt.SOLVE_ARGS[:6]],
                 dict(n_cqs=n_cqs, depth=c["depth"]))


def test_staged_cq_avail_depth_17_on_the_solve_cycle_planes():
    """testing.shape_cases' chain 17 levels deep (the launchers' old
    limit), whose kq_cq_avail case the card also runs."""
    (planes, kw), = [(a, k) for name, a, k in tt.shape_cases(0)
                     if name == "kq_cq_avail"]
    assert kw["depth"] == 17
    _check_avail(planes, kw)


def test_cq_avail_routes():
    """The staged route while parent[] fits in 48 KB of shared memory
    (N <= 12,288), the global route past it; the F cells of a CQ in one
    warp."""
    assert tkernels.cq_avail_route(1) == "staged"
    assert tkernels.cq_avail_route(12_288) == "staged"
    assert tkernels.cq_avail_route(12_289) == "global"
    assert 4 * tkernels.AVAIL_STAGE_MAX == 48 * 1024
    Ns = [sum(s[:2]) for s in tt.AVAIL_CARD_SHAPES]
    assert [tkernels.cq_avail_route(N) for N in Ns] == ["staged", "global"]
    assert [tkernels.cq_avail_route(sum(s[:2])) for s in tt.AVAIL_SHAPES] \
        == ["staged"] * len(tt.AVAIL_SHAPES)
    assert [tkernels.cq_avail_segment(d) for d in (1, 2, 3, 4, 5, 9, 16,
                                                     17, 40)] \
        == [1, 2, 4, 4, 8, 16, 16, 16, 16]
    for C, F in ((1, 1), (5, 12), (7, 33), (3, 64), (100, 7)):
        c, f = avail_cells(C, F)
        assert sorted(zip(c.tolist(), f.tolist())) == [
            (i, j) for i in range(C) for j in range(F)]


# -- kq_scatter_rows: the packed buffer ----------------------------------

@pytest.mark.parametrize("seed,D", [(0, 1), (1, 3), (2, 9), (3, 12),
                                    (4, 250)])
def test_packed_scatter_matches_jax(seed, D):
    """One buffer, unpacked on the CPU, against ``a.at[rows].set(v)``:
    padded duplicate rows, a row past the planes and one below -C
    (dropped), one in [-C, 0) (written at C + r), 5-byte bool rows and
    16-byte rows; every segment 16-byte aligned."""
    C = 256 if D == 250 else 12
    planes, rows, vals = tt.scatter_case(seed, C=C, D=D)
    assert len(rows) > D + 1, len(rows)           # padded duplicates
    assert int(rows.max()) >= C and int(rows.min()) < -C   # dropped
    assert ((rows >= -C) & (rows < 0)).sum() == 1          # wrapped
    offsets, row_bytes, n = scatter_layout(planes, len(rows))
    assert 5 in row_bytes and 16 in row_bytes and 1 in row_bytes
    assert all(o % 16 == 0 for o in offsets) and n % 16 == 0
    buf = pack_scatter_rows(rows, vals)
    assert buf.dtype == np.uint8 and buf.shape == (n,)
    fn = jburst.BurstSolver(backend="cpu")._scatter_rows_fn()
    want = jax.device_get(fn(tuple(jnp.asarray(p) for p in planes),
                             jnp.asarray(rows),
                             tuple(jnp.asarray(v) for v in vals)))
    got = tsh.scatter_rows([torch.from_numpy(p.copy()) for p in planes],
                           torch.from_numpy(buf), len(rows))
    assert len(got) == len(want) == 13
    for name, w, g in zip(tsh.SCATTER_PLANES, want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_packed_buffer_round_trips():
    """``unpack_scatter_rows`` gives back the rows and values packed (in a
    caller's buffer too), and refuses a buffer of the wrong size."""
    planes, rows, vals = tt.scatter_case(5, D=4)
    tplanes = [torch.from_numpy(p) for p in planes]
    out = np.full(4096, 7, dtype=np.uint8)
    buf = pack_scatter_rows(rows, vals, out=out)
    assert np.shares_memory(buf, out)
    r, v = tsh.unpack_scatter_rows(tplanes, torch.from_numpy(buf),
                                   len(rows))
    assert r.dtype == torch.int32 and np.array_equal(r.numpy(), rows)
    for x, y in zip(vals, v):
        assert y.numpy().dtype == x.dtype and np.array_equal(y.numpy(), x)
    with pytest.raises(ValueError):
        tsh.unpack_scatter_rows(tplanes, torch.from_numpy(buf[:-16]),
                                len(rows))


def test_resident_drain_uploads_one_buffer_per_shard():
    """The sustained drain on an 8-shard virtual CPU mesh: records equal
    to the serial drain, resident hits, one packed buffer per shard with
    dirty rows (at most one per shard per hit)."""
    serial = scenarios.sustained_drain(device="cpu")
    with tsh.virtual_mesh("cpu", 8):
        shard = scenarios.sustained_drain(device="cpu", shards=8)
    assert shard["records"] == serial["records"]
    st = shard["stats"]
    assert st["burst_resident_hits"] >= 1, st
    assert 1 <= st["burst_resident_scatter_copies"] \
        <= 8 * st["burst_resident_hits"], st
    assert st["burst_resident_scatter_copies"] \
        <= st["burst_resident_scatter_rows"], st
