"""drs_components' Hopper design (kueue_tpu_torch/kernels/drs_components.cu)
emulated in numpy against the JAX package's ``drs_components``: the
(node, column) lanes of each warp as ``kernels.drs_layout`` lays them
out (``per`` nodes a warp for F <= 32, a node a warp in chunks of 32
columns past it), each lane's borrowed term and its parent's potential
on a zero usage plane (the chain in segments of the route's length,
each level's four cells loaded with its parent pointer, then the
top-down fold), each lane's two terms added into its (node, resource)'s
cells of the warp's [2, per, R] sums as unsigned 32-bit words, every
output cell written once.  Over
``testing.DRS_DESIGN_SHAPES``: depth 1, 2, 3 and 17, F = 1 / 5 / 12 /
65, R = 1 / 3 / 5, a resource with no column, planes over the whole
int32 range (negative guaranteed, wrapping sums), N past the staged
route.  Also the plain route (``ops.fairsharing_kernel.drs_components``
on CPU tensors) at the same shapes.  Exact in values and dtypes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.ops import fairsharing_kernel as jfk
from kueue_tpu_torch import kernels
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import fairsharing_kernel as tfk

SHAPES = list(enumerate(tt.DRS_DESIGN_SHAPES))


def cases():
    """The seeded cases of ``testing.drs_design_cases``, built once."""
    if not hasattr(cases, "memo"):
        cases.memo = list(tt.drs_design_cases(0))
    return cases.memo


def jax_drs(args, kw):
    got = jfk.drs_components(*(jnp.asarray(a) for a in args), **kw)
    return tuple(np.asarray(jax.device_get(g)) for g in got)


def u32(x):
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def i32(x):
    return u32(x).view(np.int32)


def potential_step(root, sub, g, bc, hb, p):
    """quota.cuh kq_potential_step on arrays (wrapping int32)."""
    cap = i32(u32(bc) - u32(np.maximum(0, i32(u32(0) - u32(g)))))
    pp = np.where(hb, np.minimum(cap, p), p)
    return np.where(root, sub, i32(u32(np.maximum(0, g)) + u32(pp)))


def potential(planes, parent, p, f, depth, S):
    """The parent p's potential in column f for every lane (p >= 0): its
    chain in segments of S levels, top segment first; each level's cells
    loaded with its parent pointer, then the segment folded top-down."""
    _, sub_pl, g_pl, bc_pl, hb_pl = planes
    pot = np.zeros(len(p), np.int32)
    for lo in range(((depth - 1) // S) * S, -1, -S):
        n_seg = min(depth - lo, S)
        n = p.copy()
        for _ in range(lo):
            n = np.where(n >= 0, parent[np.maximum(n, 0)], -1)
        nodes, roots, cells = [], [], []
        for _ in range(n_seg):
            at, live = np.maximum(n, 0), n >= 0
            cells.append(tuple(np.where(live, pl[at, f], 0)
                               for pl in (sub_pl, g_pl, bc_pl, hb_pl)))
            up = np.where(live, parent[at], -1)
            nodes.append(n)
            roots.append(up < 0)
            n = up
        for i in range(n_seg - 1, -1, -1):
            sub, g, bc, hb = cells[i]
            pot = np.where(nodes[i] >= 0, potential_step(
                roots[i], sub, g, bc, hb.astype(bool), pot), pot)
    return pot


def emulate(args, kw):
    """The kernel's launch on numpy: → (borrowing, lendable, writes)."""
    usage, subtree, guaranteed, borrow_cap, has_blim, parent, fr = args[:7]
    wl_req = args[7] if len(args) > 7 else None
    N, F = usage.shape
    R, depth = kw["n_resources"], kw["depth"]
    lay = kernels.drs_layout(N, F, R, depth)
    per = lay["per"]
    S = kernels.cq_avail_segment(depth)
    n_warps = -(-N // per) if F <= 32 else N
    chunks = 1 if F <= 32 else -(-F // 32)
    lane = np.arange(32)
    acc = np.zeros((n_warps, 2, per * R), np.uint32)
    for c in range(chunks):
        warp = np.repeat(np.arange(n_warps), 32)
        ln = np.tile(lane, n_warps)
        n0 = warp * per
        if F <= 32:
            q = ln // max(F, 1)
            n, f = n0 + q, ln - q * F
            live = (ln < per * F) & (n < N)
        else:
            n, f = n0, c * 32 + ln
            live = (f < F) & (n < N)
        r = np.where(live, fr[np.minimum(f, F - 1)], -1)
        r = np.where(r < R, r, -1)
        on = r >= 0
        n, f, r, warp, n0 = n[on], f[on], r[on], warp[on], n0[on]
        u = usage[n, f]
        if wl_req is not None:
            u = i32(u32(u) + u32(wl_req[n, f]))
        b = u32(np.maximum(0, i32(u32(u) - u32(subtree[n, f]))))
        p = parent[n]
        lend = np.zeros(len(n), np.int32)
        has_p = p >= 0
        lend[has_p] = potential(
            (usage, subtree, guaranteed, borrow_cap, has_blim), parent,
            p[has_p], f[has_p], depth, S)
        key = (n - n0) * R + r
        # each lane's terms into its (node, resource)'s cells
        np.add.at(acc, (warp, 0, key), b)
        np.add.at(acc, (warp, 1, key), u32(lend))
    borrowing = np.full((N, R), 7, np.int32)      # never read unwritten
    lendable = np.full((N, R), 7, np.int32)
    writes = np.zeros((N, R), np.int64)
    for w in range(n_warps):
        for j in range(per * R):
            node = w * per + j // R
            if node < N:
                borrowing[node, j % R] = acc[w, 0, j].view(np.int32)
                lendable[node, j % R] = acc[w, 1, j].view(np.int32)
                writes[node, j % R] += 1
    return borrowing, lendable, writes


@pytest.mark.parametrize("i,shape", SHAPES)
def test_design_matches_jax(i, shape):
    args, kw = cases()[i]
    want = jax_drs(args, kw)
    borrowing, lendable, writes = emulate(args, kw)
    assert (writes == 1).all()
    for w, g in zip(want, (borrowing, lendable)):
        assert w.dtype == g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("i,shape", SHAPES)
def test_plain_route_matches_jax(i, shape):
    args, kw = cases()[i]
    want = jax_drs(args, kw)
    got = tfk.drs_components(*(torch.from_numpy(a) for a in args), **kw)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_the_shapes_cover_the_design():
    """The shapes cover the design: both routes, F on
    both sides of 32, depth 1 / 2 / 17, R = 1 and 5, a resource with no
    column, values at the int32 limits and negative guaranteed."""
    routes, Fs, depths, Rs, empty, wraps, neg = set(), set(), set(), \
        set(), False, False, False
    for args, kw in cases():
        N, F = args[0].shape
        routes.add(kernels.drs_layout(N, F, kw["n_resources"],
                                      kw["depth"])["route"])
        Fs.add(F)
        depths.add(kw["depth"])
        Rs.add(kw["n_resources"])
        empty |= len(set(args[6].tolist())) < kw["n_resources"]
        wraps |= bool((np.abs(args[1].astype(np.int64)) > 2**30).any())
        neg |= bool((args[2] < 0).any())
    assert routes == {"staged", "walk"}
    assert {1, 65} <= Fs and {1, 2, 17} <= depths and {1, 5} <= Rs
    assert empty and wraps and neg


def test_layout():
    """``drs_layout``: staged for a chain deeper than 2 up to 12,288
    nodes, else the walk; 32 / F nodes a warp for F <= 32, one past it;
    the warps and then the nodes of a warp halve while the sums outgrow
    shared memory; a resource count whose single node's sums do not fit
    raises."""
    lay = kernels.drs_layout(kernels.DRS_STAGE_MAX, 1, 1, 3)
    assert lay == dict(route="staged", per=32, warps=8,
                       smem=8 * 32 * 8 + 4 * kernels.DRS_STAGE_MAX)
    assert kernels.drs_layout(kernels.DRS_STAGE_MAX + 1, 1, 1, 3) \
        == dict(route="walk", per=32, warps=8, smem=8 * 32 * 8)
    assert kernels.drs_layout(1200, 1, 1, 2)["route"] == "walk"
    assert kernels.drs_layout(100, 12, 3, 2)["per"] == 2
    assert kernels.drs_layout(100, 33, 3, 2)["per"] == 1
    big = kernels.drs_layout(100, 1, 2000, 3)
    assert big["smem"] <= kernels.SMEM_LIMIT and big["warps"] < 8
    with pytest.raises(ValueError, match="n_resources"):
        kernels.drs_layout(100, 1, kernels.SMEM_LIMIT // 8 + 1, 2)
