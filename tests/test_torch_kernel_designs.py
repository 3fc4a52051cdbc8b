"""The two redesigned CUDA kernels' algorithms, emulated in numpy step
by step as the card runs them, against the JAX package's programs.

- ``best_fit_descend`` / ``split_across_roots`` (kernels/tas.cuh): the
  fill by segmented sums over runs of 32 consecutive children, the route
  check (parents nondecreasing, in range, no run past 32 children), the
  warp route (each child's rank by comparisons with its run, the scatter
  into sorted order, an exclusive wrapping scan, the BestFit picks by
  first / last set lane) and the sort route (a sort by (parent, key,
  tie) and a serial walk of each parent's run), against
  ``kueue_tpu.ops.tas_kernel``.
- ``fs_admit_scan`` (kernels/fs_admit_scan.cu): every cohort forest
  plays its own rounds with the forest's lowest remaining entry as e0,
  then the rounds are put in the reference's order by their rank
  (key m_f(k), offset k - the first k with that key), against
  ``kueue_tpu.ops.fs_scan.fs_admit_scan`` (XLA on the CPU, as
  tests/test_fs_device.py runs it).
- ``kq_cycle_order`` and ``kq_classify_heads`` (kernels/solve_cycle.cu):
  the order's bitonic stages in registers, by shuffles within a warp and
  through shared memory across warps on 96-bit keys (and the global
  route's), against ``jnp.lexsort``; the classify's lane groups, their
  ballots and the walk on slot masks (a warp per head looping over the
  pairs past 32), against the JAX ``solve_cycle(run_scan=False)`` and
  ``decision_pairs_from_slots``.

Exact in values; every case is its own parametrised test."""

import jax.numpy as jnp
import numpy as np
import pytest

from kueue_tpu.ops import fs_scan as jfs
from kueue_tpu.ops import tas_kernel as jtk
from kueue_tpu_torch import testing as tt

I32_MAX = 2**31 - 1
RUN = 32                      # TAS_WARP_RUN: the warp route's widest run
WARP, SORT = 1, 2             # tas.cuh TasRoute


def w32(x: int) -> int:
    """Wrap to int32, as the kernels' unsigned adds do."""
    return ((int(x) + 2**31) % 2**32) - 2**31


# -- TAS ---------------------------------------------------------------------

def tas_fill(leaf_free, per_pod, parents, sizes):
    """tas_fill_leaves + tas_fill_levels: leaf states, then per level each
    warp's 32 consecutive children summed run by run (runs of equal
    parent) into the parent, with wrapping adds."""
    need = per_pod > 0
    if need.any():
        leaf = np.array([min(int(row[r]) // int(per_pod[r])
                             for r in np.nonzero(need)[0])
                         for row in leaf_free], dtype=np.int64)
    else:
        leaf = np.zeros(sizes[-1], dtype=np.int64)
    states = [None] * len(sizes)
    states[-1] = [w32(v) for v in leaf]
    for lvl in range(len(sizes) - 2, -1, -1):
        par, child = parents[lvl], states[lvl + 1]
        acc = [0] * sizes[lvl]
        for base in range(0, len(child), 32):
            k = base
            while k < min(base + 32, len(child)):
                e = k
                while e + 1 < min(base + 32, len(child)) and \
                        par[e + 1] == par[k]:
                    e += 1
                p = int(par[k])
                if 0 <= p < sizes[lvl]:
                    acc[p] = w32(acc[p] + sum(child[k:e + 1]))
                k = e + 1
        states[lvl] = acc
    return states


def tas_route(par, n_parent) -> int:
    """tas_check_routes for one level."""
    par = np.asarray(par, dtype=np.int64)
    ok = ((par >= 0) & (par < n_parent)).all() and (np.diff(par) >= 0).all()
    ok = ok and not (len(par) > RUN and (par[RUN:] == par[:-RUN]).any())
    return WARP if ok else SORT


def warp_walk(state, children, cnt, profile, out):
    """tas_warp_walk: one run (<= 32 children) on one warp."""
    m = len(children)
    assert m <= RUN
    least = profile == "leastfree"
    key = [state[c] if least else w32(-state[c]) for c in children]
    tie = [-c if least else c for c in children]
    rank = [sum((key[j], tie[j]) < (key[i], tie[i]) for j in range(m))
            for i in range(m)]
    s, ch = [0] * m, [0] * m
    for i in range(m):                       # the scatter through the slot
        s[rank[i]], ch[rank[i]] = state[children[i]], children[i]
    inc, rem = 0, []
    for r in range(m):                       # exclusive wrapping scan
        rem.append(w32(cnt - inc))
        inc = w32(inc + s[r])
    take = [min(s[r], max(0, rem[r])) for r in range(m)]
    if profile == "bestfit":
        ab = [r for r in range(m) if rem[r] > 0 and s[r] >= rem[r]]
        if ab:
            j = ab[0]                        # __ffs of the ballot
            rem_j = rem[j]
            cand = [r for r in range(j, m) if s[r] >= rem_j]
            tight = s[cand[-1]]              # __clz of the ballot
            pick = next(r for r in cand if s[r] == tight)
            for r in range(j, m):
                take[r] = rem_j if r == pick else 0
    for r in range(m):
        out[ch[r]] = take[r]


def sort_walk(state, order, cnt, profile, out):
    """tas_walk_segment: one parent's run in sorted order on one
    thread."""
    exc, j, rem_j = 0, -1, 0
    for k, c in enumerate(order):
        rem = w32(cnt - exc)
        if j < 0 and rem > 0 and state[c] >= rem:
            j, rem_j = k, rem
        out[c] = min(state[c], max(0, rem))
        exc = w32(exc + state[c])
    if profile != "bestfit" or j < 0:
        return
    last = max(k for k in range(j, len(order)) if state[order[k]] >= rem_j)
    tight = state[order[last]]
    picked = False
    for k in range(j, len(order)):
        c = order[k]
        take = 0
        if not picked and state[c] >= rem_j and state[c] == tight:
            take, picked = rem_j, True
        out[c] = take


def sort_key(state, i, n, profile):
    least = profile == "leastfree"
    return (state[i] if least else w32(-state[i]), n - 1 - i if least else i)


def allocate_level(parent_counts, par, state, profile, route):
    """Level d's counts on its route."""
    n, np_ = len(state), len(parent_counts)
    out = [0] * n
    if route == WARP:
        for p in range(np_):                 # a warp per parent's run
            children = [k for k in range(n) if par[k] == p]
            assert not children or children == list(
                range(children[0], children[-1] + 1))
            warp_walk(state, children, parent_counts[p], profile, out)
        return out
    order = sorted(range(n), key=lambda i: (int(par[i]) % 2**32,)
                   + sort_key(state, i, n, profile))
    for p in range(np_):
        run = [i for i in order if par[i] == p]
        sort_walk(state, run, parent_counts[p], profile, out)
    return out


def emu_best_fit_descend(leaf_free, per_pod, parents, count, sizes, level,
                         profile):
    states = tas_fill(leaf_free, per_pod, parents, sizes)
    st = states[level]
    fits = [s >= count for s in st]
    key = [(s if profile != "mostfree" else w32(-s)) if f else I32_MAX
           for s, f in zip(st, fits)]
    ok = any(fits)
    best = min(range(len(st)), key=lambda i: (key[i], i))
    counts = [count if ok and i == best else 0 for i in range(len(st))]
    routes = []
    for d in range(level + 1, len(sizes)):
        routes.append(tas_route(parents[d - 1], sizes[d - 1]))
        counts = allocate_level(counts, parents[d - 1], states[d], profile,
                                routes[-1])
    return ok, np.array(counts, np.int32), routes


def emu_split_across_roots(leaf_free, per_pod, parents, count, sizes,
                           profile, descend_profile):
    states = tas_fill(leaf_free, per_pod, parents, sizes)
    ok = w32(sum(states[0])) >= count
    n0 = sizes[0]
    routes = [WARP if n0 <= RUN else SORT]
    counts = allocate_level([count], [0] * n0, states[0], profile, routes[0])
    if not ok:
        counts = [0] * n0
    for d in range(1, len(sizes)):
        routes.append(tas_route(parents[d - 1], sizes[d - 1]))
        counts = allocate_level(counts, parents[d - 1], states[d],
                                descend_profile, routes[-1])
    return ok, np.array(counts, np.int32), routes


def _tas_tree(name):
    rng = np.random.default_rng(7)
    if name == "runs_1_16_32":
        return tt.tas_runs_case(rng, (None, (1, 16, 32, 5))), (WARP,)
    if name == "runs_3_levels":
        return tt.tas_runs_case(rng, ((1, 3), (16, 1, 32, 2))), (WARP, WARP)
    if name == "runs_past_32":
        return tt.tas_runs_case(rng, (None, (33, 64, 1, 128))), (SORT,)
    if name == "ties":
        leaf_free = np.full((48, 2), 8, np.int32)
        par = np.repeat(np.arange(3), 16).astype(np.int32)
        return (leaf_free, np.array([2, 1], np.int32), (par,), (3, 48)), \
            (WARP,)
    if name == "wrap":
        return tt.tas_wrap_case(), (WARP,)
    if name == "shuffled":
        lf, per_pod, parents, sizes = tt.tas_runs_case(
            rng, ((3, 4), (4, 9, 1, 6, 3, 2, 5)))
        lf, parents = tt.tas_shuffled(rng, lf, parents, sizes)
        return (lf, per_pod, parents, sizes), (SORT, SORT)
    raise KeyError(name)


TAS_TREES = ("runs_1_16_32", "runs_3_levels", "runs_past_32", "ties", "wrap",
             "shuffled")


@pytest.mark.parametrize("profile", ("bestfit", "mostfree", "leastfree"))
@pytest.mark.parametrize("tree", TAS_TREES)
def test_tas_warp_and_sort_routes_match_jax(tree, profile):
    """Every level and count of best_fit_descend and the root split
    (Mixed's unconstrained variant beside BestFit), emulated on the
    routes the kernel takes, equal the JAX programs; the routes are the
    ones the tree's runs call for."""
    (leaf_free, per_pod, parents, sizes), want = _tas_tree(tree)
    parents = tuple(np.asarray(p, np.int32) for p in parents)
    counts = tt._tas_counts(leaf_free, per_pod, parents, sizes)
    if tree == "wrap":
        counts = range(7)
    splits = [(profile, profile)] + ([("leastfree", "bestfit")]
                                     if profile == "bestfit" else [])
    kw = dict(level_sizes=tuple(sizes))
    for count in counts:
        for level in range(len(sizes)):
            ok, out, routes = emu_best_fit_descend(
                leaf_free, per_pod, parents, int(count), sizes, level,
                profile)
            j_ok, j_out = jtk.best_fit_descend(
                leaf_free, per_pod, parents, int(count), level=level,
                profile=profile, **kw)
            assert ok == bool(j_ok), (tree, count, level)
            assert np.array_equal(out, np.asarray(j_out)), (tree, count,
                                                            level)
            assert tuple(routes) == want[level:], (tree, level, routes)
        for prof, desc in splits:
            ok, out, routes = emu_split_across_roots(
                leaf_free, per_pod, parents, int(count), sizes, prof, desc)
            j_ok, j_out = jtk.split_across_roots(
                leaf_free, per_pod, parents, int(count), profile=prof,
                descend_profile=desc, **kw)
            assert ok == bool(j_ok), (tree, count, prof)
            assert np.array_equal(out, np.asarray(j_out)), (tree, count,
                                                            prof)
            assert routes[0] == (WARP if sizes[0] <= RUN else SORT)
            assert tuple(routes[1:]) == want, (tree, routes)


def test_tas_route_check():
    """The route check: runs of 1, 16 and 32 children in order take the
    warp route; a run of 33, parents out of order and a parent outside
    the level take the sort route."""
    par = np.repeat(np.arange(3), (1, 16, 32))
    assert tas_route(par, 3) == WARP
    assert tas_route(np.repeat(np.arange(2), (33, 1)), 2) == SORT
    assert tas_route(np.array([0, 1, 0]), 2) == SORT
    assert tas_route(np.array([0, 0, 2]), 2) == SORT
    assert tas_route(np.array([0, 2, 2]), 3) == WARP     # parent 1: no run


# -- fair sharing ---------------------------------------------------------

def chain(parent, node, depth):
    out = []
    while node >= 0 and len(out) < depth:
        out.append(node)
        node = int(parent[node])
    return out


def available(c, usage, node, f, depth):
    """kq_available_at over a chain, top-down."""
    avail = 0
    for n in reversed(chain(c["parent"], node, depth)):
        u = int(usage[n, f])
        if c["parent"][n] < 0:
            avail = w32(int(c["subtree"][n, f]) - u)
        else:
            g = int(c["guaranteed"][n, f])
            local = max(0, w32(g - u))
            pa = avail
            if c["has_blim"][n, f]:
                pa = min(w32(int(c["borrow_cap"][n, f]) - max(0, w32(u - g))),
                         avail)
            avail = w32(local + pa)
    return avail


def add_usage(c, usage, node, delta, f, depth):
    """flat_forest.cuh AddStep, up a chain."""
    carry = delta
    for n in chain(c["parent"], node, depth):
        u = int(usage[n, f])
        local = max(0, w32(int(c["guaranteed"][n, f]) - u))
        usage[n, f] = w32(u + carry)
        carry = max(0, w32(carry - local))


def entry_drs(c, usage, j, depth):
    """fs_entry_drs: DRS at each level of the entry's path."""
    F, R = c["u_e"].shape[1], c["onehot"].shape[1]
    carry = [int(v) for v in c["u_e"][j]]
    node = max(int(c["wl_cq"][j]), 0)
    out = []
    for _ in range(depth):
        dws = 0
        if node >= 0:
            has_borrow, drs_raw = False, -2**31
            for r in range(R):
                b = 0
                for f in range(F):
                    oh = int(c["onehot"][f, r])
                    if oh == 0:
                        continue
                    after = w32(int(usage[node, f]) + carry[f])
                    bf = max(0, w32(after - int(c["subtree"][node, f])))
                    if not c["sq_mask"][node, f]:
                        bf = 0
                    b = w32(b + w32(bf * oh))
                has_borrow |= b > 0
                lend = int(c["lendable_r"][node, r])
                lend1 = max(lend, 1)
                ratio = (w32(min(b, lend1) * 1000) // lend1
                         if b > 0 and lend > 0 else -1)
                drs_raw = max(drs_raw, ratio)
            w = int(c["weights"][node])
            dws = w32(drs_raw * 1000) // max(w, 1) if has_borrow else 0
            if w == 0:
                dws = 2**31 - 2
            if c["parent"][node] < 0:
                dws = 0
            for f in range(F):
                local = max(0, w32(int(c["guaranteed"][node, f])
                                   - int(usage[node, f])))
                carry[f] = max(0, w32(carry[f] - local))
            node = int(c["parent"][node])
        out.append(dws)
    return out


def forest_rounds(c, f, depth, n_levels, usage, out):
    """One block: forest f's rounds with its own lowest remaining entry
    as e0.  Writes admitted / processed, key_of / off_of per winner and
    the per-key round counts."""
    W = len(c["wl_cq"])
    parent, level = c["parent"], c["node_level"]
    cq = np.maximum(c["wl_cq"], 0)
    ents = [j for j in range(W) if c["valid"][j]
            and c["forest_of_node"][cq[j]] == f]
    nodes = np.nonzero(c["forest_of_node"] == f)[0]
    remaining = list(ents)
    k, key_prev, first_k = 0, -1, 0
    for j in ents:
        out["cnt"][j] = 0
    while remaining:
        e0 = remaining[0]
        drs = {j: entry_drs(c, usage, j, depth) for j in remaining}
        nwin = {int(n): -1 for n in nodes}
        for j in remaining:
            nwin[int(cq[j])] = j
        for lvl in range(n_levels - 1, 0, -1):
            best = {}
            for n in nodes:
                w, p = nwin[int(n)], int(parent[n])
                if level[n] != lvl or w < 0 or p < 0:
                    continue
                li = min(max(int(level[cq[w]]) - lvl, 0), depth - 1)
                key = (drs[w][li], w32(-int(c["prio"][w])),
                       int(c["ts_rank"][w]), int(c["child_order"][n]))
                # the four atomicMin passes, then atomicMax of the entry
                if p not in best or (key, -w) < best[p]:
                    best[p] = (key, -w)
            for n in nodes:
                if level[n] == lvl - 1 and int(n) in best:
                    nwin[int(n)] = -best[int(n)][1]
        root = int(cq[e0])
        for _ in range(depth - 1):
            if parent[root] >= 0:
                root = int(parent[root])
        tw = nwin[root]
        win = e0 if parent[cq[e0]] < 0 or tw < 0 else tw
        wu = c["u_e"][win]
        fit = all(not wu[g] > 0 or wu[g] <= available(c, usage, cq[win], g,
                                                      depth)
                  for g in range(len(wu)))
        admit = bool(not c["nofit"][win] and fit)
        if admit:
            for g in range(len(wu)):
                add_usage(c, usage, int(cq[win]), int(wu[g]), g, depth)
        remaining.remove(win)
        out["admitted"][win], out["processed"][win] = admit, True
        if e0 != key_prev:
            if key_prev >= 0:
                out["cnt"][key_prev] = k - first_k
            key_prev, first_k = e0, k
        out["key_of"][win], out["off_of"][win] = e0, k - first_k
        k += 1
    if key_prev >= 0:
        out["cnt"][key_prev] = k - first_k


def emu_fs_admit_scan(c, depth, n_levels, n_forests):
    """Every forest's block, then the last block's merge by rank."""
    W = len(c["wl_cq"])
    out = dict(cnt=np.zeros(W, np.int64), key_of=np.zeros(W, np.int64),
               off_of=np.zeros(W, np.int64), admitted=np.zeros(W, bool),
               processed=np.zeros(W, bool))
    usage = c["usage0"].astype(np.int64)
    for f in range(n_forests):
        forest_rounds(c, f, depth, n_levels, usage, out)
    held = c["valid"].copy()
    base = np.concatenate([[0], np.cumsum(np.where(held, out["cnt"], 0))])
    order = np.full(W, -1, np.int32)
    for j in np.nonzero(held)[0]:
        order[base[out["key_of"][j]] + out["off_of"][j]] = j
    assert (order[:base[-1]] >= 0).all()
    return order, out["admitted"], out["processed"]


FS_DESIGN_CASES = {
    "one_forest": dict(n_cqs=12, n_cohorts=4, depth=4, F=2, R=2, W=16,
                       roots=1, ties=True),
    "forests_of_5": dict(n_cqs=1000, n_cohorts=200, depth=2, F=1, R=1,
                         W=1024, n_valid=1000, per=5),
    "parentless": dict(n_cqs=20, n_cohorts=3, depth=2, F=2, R=1, W=24,
                       per=4),
    "invalid_entries": dict(n_cqs=16, n_cohorts=4, depth=3, F=2, R=2, W=32,
                            n_valid=14),
    "nested": dict(n_cqs=30, n_cohorts=10, depth=4, F=2, R=2, W=32,
                   ties=True),
    "depth_17": dict(n_cqs=6, n_cohorts=16, depth=3, F=2, R=1, W=8,
                     chain=True),
    "F_65": dict(n_cqs=8, n_cohorts=3, depth=3, F=65, R=5, W=16),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(FS_DESIGN_CASES))
def test_fs_forest_blocks_and_rank_order_match_jax(case, seed):
    """Forest-local rounds merged by (m_f(k), k) give the JAX scan's
    order, admitted and processed."""
    c = tt.fs_cycle(np.random.default_rng(seed), **FS_DESIGN_CASES[case])
    if case == "invalid_entries":
        c["valid"][:14:3] = False            # heads with a CQ, not valid
        c["nofit"] &= c["valid"]
        assert (c["wl_cq"] == -1).any()
    kw = dict(depth=c["depth"], n_levels=c["n_levels"])
    order, admitted, processed = emu_fs_admit_scan(c, n_forests=c[
        "n_forests"], **kw)
    j = jfs.fs_admit_scan(*[jnp.asarray(a) for a in tt.fs_args(c)[:-1]],
                          **kw)
    assert np.array_equal(order, np.asarray(j[0])), case
    assert np.array_equal(admitted, np.asarray(j[1])), case
    assert np.array_equal(processed, np.asarray(j[2])), case
    assert int(processed.sum()) == int(c["valid"].sum())
    if case == "forests_of_5":
        assert c["n_forests"] == 200 and c["max_forest"] == 6
    if case == "one_forest":
        assert c["n_forests"] == 1


def test_fs_rank_order_interleaves_forests():
    """The merge is not the concatenation of the forests' rounds: three
    cohorts of three CQs and three parentless CQs, whose rounds the rank
    order interleaves (a forest's rounds fall in two stretches or more)
    and whose heads it reorders, as the JAX scan does."""
    c = tt.fs_cycle(np.random.default_rng(1), n_cqs=12, n_cohorts=3,
                    depth=2, F=1, R=1, W=12, per=3, ties=True)
    kw = dict(depth=c["depth"], n_levels=c["n_levels"])
    order, _, _ = emu_fs_admit_scan(c, n_forests=c["n_forests"], **kw)
    j = jfs.fs_admit_scan(*[jnp.asarray(a) for a in tt.fs_args(c)[:-1]],
                          **kw)
    assert np.array_equal(order, np.asarray(j[0]))
    assert (order != np.sort(order)).any()
    forest = c["forest_of_node"][c["wl_cq"][order]].tolist()
    starts = [f for k, f in enumerate(forest) if k == 0 or forest[k - 1] != f]
    assert len(starts) > len(set(starts)), forest


# -- the flat admit_scan (kernels/admit_scan.cu) ------------------------------

from kueue_tpu.ops import cycle as jcycle   # noqa: E402

FLAT_WARPS = 8                # FLAT_THREADS / 32
FLAT_GRIDS = (1, 3, 132)      # one block, forests sharing blocks, the card


def flat_forest_ids(c, tables: bool) -> np.ndarray:
    """flat_forests: forest_of_node (clamped at 0), or each node's root."""
    if tables:
        return np.maximum(c["forest_of_node"], 0)
    parent = c["parent"]
    out = np.arange(len(parent))
    for n in range(len(parent)):
        while parent[out[n]] >= 0:
            out[n] = parent[out[n]]
    return out


def emu_flat_admit_scan(c, depth: int, tables: bool, B: int, rng,
                        rank_cap=None):
    """Block b = fid % B stages its nodes in any order (the atomic
    counter's) as local rows — usage, guaranteed, subtree at roots or
    borrow cap below, has-borrow-limit bits in 32-bit words — and lists
    its heads in cycle order; warp (fid // B) % 8 decides its entries;
    the warps of all blocks interleave at random.  An entry: each pair
    checked against available() on the local rows, the vote, the charge
    summed per column and walked up the chain for each nonzero column.
    ``rank_cap`` = (max_forest_wl, n_forests), admit_scan_forests' cap:
    the warp counts each forest's heads as it decides them, and a head
    of rank max_forest_wl or more, or outside [0, n_forests), is
    neither admitted nor charged."""
    N, F = c["usage0"].shape
    W = len(c["wl_cq"])
    fid = flat_forest_ids(c, tables)
    words = -(-F // 32)
    admitted = np.zeros(W, dtype=bool)
    queues = []
    for b in range(B):
        nodes = rng.permutation(np.nonzero(fid % B == b)[0])
        local = {int(n): i for i, n in enumerate(nodes)}
        par = np.array([local[int(c["parent"][n])] if c["parent"][n] >= 0
                        else -1 for n in nodes], dtype=np.int64)
        cap = np.where((c["parent"][nodes] < 0)[:, None],
                       c["subtree"][nodes], c["borrow_cap"][nodes])
        bits = np.zeros((len(nodes), words), dtype=np.int64)
        for f in range(F):
            bits[:, f // 32] |= c["has_blim"][nodes, f].astype(np.int64) \
                << (f % 32)
        rows = dict(parent=par, subtree=cap, borrow_cap=cap,
                    guaranteed=c["guaranteed"][nodes],
                    has_blim=np.array([[(bits[i, f // 32] >> (f % 32)) & 1
                                        for f in range(F)]
                                       for i in range(len(nodes))],
                                      dtype=bool).reshape(len(nodes), F))
        usage = c["usage0"][nodes].astype(np.int64)
        lists = [[] for _ in range(FLAT_WARPS)]
        for wi in c["order"]:
            cq = int(c["wl_cq"][wi])
            if cq >= 0 and fid[cq] % B == b:
                lists[(fid[cq] // B) % FLAT_WARPS].append((int(wi),
                                                            local[cq]))
        if rank_cap is not None:
            # the warp's counter of the head's forest, by its table value
            for q in lists:
                q[:] = [(wi, node, int(c["forest_of_node"][
                    c["wl_cq"][wi]])) for wi, node in q]
        queues += [(rows, usage, q) for q in lists if q]
    ranks = {}
    while queues:
        k = int(rng.integers(len(queues)))
        rows, usage, q = queues[k]
        wi, node, *raw = q.pop(0)
        if not q:
            queues.pop(k)
        fit, res = bool(c["fit_mask"][wi]), bool(c["res_mask"][wi])
        if rank_cap is not None:
            r = rank_cap[0]
            if 0 <= raw[0] < rank_cap[1]:
                r = ranks.get(raw[0], 0)
                ranks[raw[0]] = r + 1
            if r >= rank_cap[0]:
                fit = res = False
        ok = True
        if fit:
            for fr, amt in zip(c["dec_fr"][wi], c["dec_amt"][wi]):
                if 0 <= fr < F and amt > available(rows, usage, node, fr,
                                                   depth):
                    ok = False
        admit = fit and ok
        if admit or res:
            col = [0] * F
            if admit:
                for fr, amt in zip(c["dec_fr"][wi], c["dec_amt"][wi]):
                    if 0 <= fr < F:
                        col[fr] = w32(col[fr] + int(amt))
            if res:
                cq = int(c["wl_cq"][wi])
                for fr, amt in zip(c["res_fr"][wi], c["res_amt"][wi]):
                    if not 0 <= fr < F:
                        continue
                    cur = int(usage[node, fr])
                    if c["res_borrows"][wi]:
                        d = min(int(amt), w32(int(c["npb_cq"][cq, fr]) - cur))
                    else:
                        d = max(0, min(int(amt), w32(
                            int(c["nominal_cq"][cq, fr]) - cur)))
                    col[fr] = w32(col[fr] + d)
            for f in range(F):
                if col[f] != 0:
                    add_usage(rows, usage, node, col[f], f, depth)
        admitted[wi] = admit
    return admitted


@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("case", [label for label, _ in tt.FLAT_CASES])
def test_flat_scan_forest_warps_match_jax(case, tables):
    """The flat scan decided forest by forest — heads grouped stably with
    no cap, each forest's entries on one warp, forests named by the
    tables or by their roots, one to 132 blocks — gives the JAX scan's
    admitted."""
    label, args, kw, _ = next(x for x in tt.flat_scan_cases(0)
                              if x[0] == case)
    c = dict(zip(tt.ADMIT_ARGS + ("order",), args))
    c["forest_of_node"] = next(x for x in tt.flat_scan_cases(0)
                               if x[0] == case)[3][0]
    want = np.asarray(jcycle.admit_scan(*[jnp.asarray(a) for a in args],
                                        **kw))
    rng = np.random.default_rng(1)
    for B in FLAT_GRIDS:
        got = emu_flat_admit_scan(c, kw["depth"], tables, B, rng)
        assert np.array_equal(got, want), (case, tables, B)
    if case == "padding":
        assert (c["wl_cq"] < 0).sum() == 18 and not want[c["wl_cq"] < 0].any()
    if case == "reserve":
        assert c["res_mask"].sum() > 0
    if case == "one_forest":
        assert len(set(flat_forest_ids(c, False).tolist())) == 1
    if case == "interleaved":
        fo = flat_forest_ids(c, False)[np.maximum(c["wl_cq"], 0)][c["order"]]
        assert (np.diff(fo) != 0).sum() > 12


def _forest_case(i: int):
    """testing.FOREST_SHAPES' row i, drawn as testing.kernel_cases draws
    it (seed 0, the rows before it drawn first)."""
    cases = [x for x in tt.kernel_cases(0) if x[0] == "admit_scan_forests"]
    _, args, kw = cases[i]
    return args, kw


@pytest.mark.parametrize("row", range(len(tt.FOREST_SHAPES)))
def test_forest_scan_flat_layout_with_cap_matches_jax(row):
    """admit_scan_forests on the flat scan's layout — forests named by
    the tables, each forest's heads on one warp in cycle order, one to
    132 blocks, a head of rank max_forest_wl or more neither admitted nor
    charged — gives the JAX forest scan's admitted."""
    args, kw = _forest_case(row)
    c = dict(zip(tt.ADMIT_ARGS + ("order", "forest_of_node"), args))
    want = np.asarray(jcycle.admit_scan_forests(
        *[jnp.asarray(a) for a in args], **kw))
    rng = np.random.default_rng(row)
    cap = (kw["max_forest_wl"], kw["n_forests"])
    for B in FLAT_GRIDS:
        got = emu_flat_admit_scan(c, kw["depth"], True, B, rng, cap)
        assert np.array_equal(got, want), (row, B)
    heads = np.bincount(c["forest_of_node"][c["wl_cq"][c["wl_cq"] >= 0]],
                        minlength=kw["n_forests"])
    if tt.FOREST_SHAPES[row][-1] is not None:
        # the cap row: forests with heads past the cap, and a head past it
        # that the uncapped flat scan admits
        assert heads.max() > kw["max_forest_wl"]
        flat = emu_flat_admit_scan(c, kw["depth"], True, 3, rng)
        assert (flat & ~want).any()


def test_forest_scan_heads_outside_the_tables():
    """The heads of a forest numbered outside [0, n_forests) (one tree
    numbered past the count, another below 0) are never admitted and take
    no rank, as the plain version's schedule skips them."""
    import torch
    from kueue_tpu_torch.ops import cycle as tcycle
    args, kw = _forest_case(1)
    c = dict(zip(tt.ADMIT_ARGS + ("order", "forest_of_node"), args))
    fon = c["forest_of_node"].copy()
    first = fon[c["wl_cq"][0]]
    other = fon[c["wl_cq"][c["wl_cq"] >= 0]]
    other = other[other != first][0]
    fon = np.where(fon == first, kw["n_forests"] + 5,
                   np.where(fon == other, -1, fon)).astype(np.int32)
    c["forest_of_node"] = fon
    args = tt.admit_args(c) + (fon,)
    want = tcycle.admit_scan_forests_plain(
        *[torch.from_numpy(a) for a in args], **kw).numpy()
    outside = (fon[np.maximum(c["wl_cq"], 0)] < 0) | (
        fon[np.maximum(c["wl_cq"], 0)] >= kw["n_forests"])
    assert outside[0] and not want[outside].any() and want.any()
    cap = (kw["max_forest_wl"], kw["n_forests"])
    for B in FLAT_GRIDS:
        got = emu_flat_admit_scan(c, kw["depth"], True, B,
                                  np.random.default_rng(B), cap)
        assert np.array_equal(got, want), B


# -- burst_cycles' chain-only update and rank order (burst_cycles.cu) -------

def jax_rebuild(u_cq, parent, level, guaranteed, n_levels):
    """burst.py rebuild_usage, line for line in jnp."""
    N, F = guaranteed.shape
    C = u_cq.shape[0]
    usage = jnp.zeros((N, F), dtype=jnp.int32).at[:C].set(u_cq)
    parent_safe = jnp.maximum(parent, 0)
    for lvl in range(n_levels - 1, 0, -1):
        is_l = (level == lvl) & (parent >= 0)
        contrib = jnp.where(is_l[:, None],
                            jnp.maximum(0, usage - guaranteed), 0)
        usage = usage.at[parent_safe].add(contrib)
    return np.asarray(usage)


def retarget(nu, p, f, was, now, parent, guaranteed):
    """burst_cycles.cu retarget: the CQ node moves by now - was, each
    ancestor by the change of its child's term max(0, usage -
    guaranteed), until a term stays the same (wrapping int32)."""
    if was == now:
        return
    before = int(nu[p, f])
    after = w32(before + now - was)
    nu[p, f] = after
    up = parent[p]
    while up >= 0:
        g = int(guaranteed[p, f])
        t0, t1 = max(0, w32(before - g)), max(0, w32(after - g))
        if t0 == t1:
            break
        before = int(nu[up, f])
        after = w32(before + t1 - t0)
        nu[up, f] = after
        p, up = up, parent[up]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_rebuild_matches_jax_rebuild(seed):
    """Entry after entry, updating only the ancestors of the changed CQ
    rows (the kernel's retarget, row after row, column by column) leaves
    the plane the JAX rebuild gives, bit for bit, on random trees whose
    sums wrap int32."""
    rng = np.random.default_rng(seed)
    parent, _, _, depth = tt.forest(rng, 24, 8, 4)
    level = np.zeros(len(parent), dtype=np.int32)
    for n in range(len(parent)):
        p = parent[n]
        while p >= 0:
            level[n] += 1
            p = parent[p]
    n_levels = int(level.max()) + 1
    C, F = 24, 3
    big = 2**31 - 1
    guaranteed = rng.integers(-2**30, 2**30, (len(parent), F)).astype(
        np.int32)
    rows = rng.integers(-big, big, (C, F)).astype(np.int32)
    nu = jax_rebuild(rows, parent, level, guaranteed, n_levels).astype(
        np.int64)
    wrapped = False
    for _ in range(30):
        changed = rng.choice(C, int(rng.integers(1, 4)), replace=False)
        was = rows[changed].copy()
        rows[changed] = rng.integers(-big, big, (len(changed), F))
        for m, old in zip(changed, was):
            for f in range(F):
                retarget(nu, m, f, int(old[f]), int(rows[m, f]), parent,
                         guaranteed)
        want = jax_rebuild(rows, parent, level, guaranteed, n_levels)
        assert np.array_equal(nu, want)
        over = np.maximum(0, rows.astype(np.int64) - guaranteed[:C])
        wrapped |= bool((np.abs(over.sum(0)) > big).any())
    assert wrapped and n_levels >= 3


def insertion_order(keys):
    """burst_cycles' former order(): thread 0's insertion sort, entries
    with the INF key left out, ties after their equals."""
    mat, key = [], []
    for l, kv in enumerate(keys):
        if kv == I32_MAX:
            continue
        i = len(key)
        key.append(kv)
        mat.append(l)
        while i > 0 and key[i - 1] > kv:
            key[i], mat[i] = key[i - 1], mat[i - 1]
            i -= 1
        key[i], mat[i] = kv, l
    return mat + [-1] * (len(keys) - len(mat))


def rank_order(keys):
    """order(): each entry's place is the count of entries with a smaller
    key or an equal key at a lower member position."""
    mat = [-1] * len(keys)
    for l, kv in enumerate(keys):
        if kv != I32_MAX:
            mat[sum(1 for m, km in enumerate(keys)
                    if km < kv or (km == kv and m < l))] = l
    return mat


@pytest.mark.parametrize("L", [1, 5, 40, 300])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_order_matches_insertion_sort(seed, L):
    """The rank by comparisons equals the insertion sort and the JAX
    program's stable argsort of the member keys (INF last, cut to -1),
    with ties."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, L // 3), L).astype(np.int64)
    keys[rng.random(L) < 0.2] = I32_MAX
    keys[rng.random(L) < 0.1] += 1 << 30                 # borrowing heads
    keys = np.minimum(keys, I32_MAX).tolist()
    got = rank_order(keys)
    assert got == insertion_order(keys)
    kj = jnp.asarray(np.array(keys, dtype=np.int32))
    ordj = np.asarray(jnp.argsort(kj))
    want = [int(l) if keys[int(l)] < I32_MAX else -1 for l in ordj]
    assert got == want
    assert L < 5 or len(set(k for k in keys if k < I32_MAX)) < sum(
        1 for k in keys if k < I32_MAX)


# -- admit_scan_preempt, a warp per cohort forest (admit_scan_preempt.cu) ----

from kueue_tpu_torch.ops.cycle import join_target_forests   # noqa: E402
from kueue_tpu_torch.parallel import sharded as psh         # noqa: E402


def remove_usage(c, usage, node, delta, f, depth):
    """flat_forest.cuh RemoveStep, up a chain."""
    carry = delta
    for n in chain(c["parent"], node, depth):
        u = int(usage[n, f])
        stored = w32(u - int(c["guaranteed"][n, f]))
        usage[n, f] = w32(u - carry)
        carry = min(carry, stored) if stored > 0 else 0


def emu_preempt_scan(c, depth: int, fid, B: int, rng):
    """Block b = fid % B stages its nodes (in the counter's order) with
    three usage planes and lists its heads in cycle order; while it lists
    a preempt head it checks each target's forest against the head's
    (a mismatch sets the error word and drops the target); warp
    (fid // B) % 8 decides its entries, the warps of all blocks
    interleaved at random: the fit against check, the overlap with
    ``used``, the targets removed into trial along their chains (column
    by column, target after target), the fit after removal, the used
    marks, the targets' chains copied trial → check (success) or check →
    trial (failure), the charge walked up usage and check and copied to
    trial.  Trial equals check after every entry.  Returns (admitted,
    preempting, overlap_skip, error)."""
    N, F = c["usage0"].shape
    W = len(c["wl_cq"])
    out = [np.zeros(W, dtype=bool) for _ in range(3)]
    used = np.zeros(len(c["tu_cq"]), dtype=bool)
    error = False
    queues = []
    for b in range(B):
        nodes = rng.permutation(np.nonzero(fid % B == b)[0])
        local = {int(n): i for i, n in enumerate(nodes)}
        par = np.array([local[int(c["parent"][n])] if c["parent"][n] >= 0
                        else -1 for n in nodes], dtype=np.int64)
        rows = dict(parent=par, guaranteed=c["guaranteed"][nodes],
                    subtree=np.where((c["parent"][nodes] < 0)[:, None],
                                     c["subtree"][nodes],
                                     c["borrow_cap"][nodes]),
                    has_blim=c["has_blim"][nodes])
        rows["borrow_cap"] = rows["subtree"]
        planes = [c["usage0"][nodes].astype(np.int64) for _ in range(3)]
        lists = [[] for _ in range(FLAT_WARPS)]
        for wi in c["order"]:
            cq = int(c["wl_cq"][wi])
            if cq < 0 or fid[cq] % B != b:
                continue
            tg = []
            if c["preempt_mask"][wi]:
                for tk in c["tgt_mat"][wi]:
                    if tk < 0:
                        continue
                    tcq = int(c["tu_cq"][tk])
                    if fid[tcq] != fid[cq]:
                        error = True
                        continue
                    tg.append((int(tk), local[tcq]))
            lists[(fid[cq] // B) % FLAT_WARPS].append((int(wi), local[cq],
                                                        tg))
        queues += [(rows, planes, q) for q in lists if q]
    while queues:
        k = int(rng.integers(len(queues)))
        rows, (usage, check, trial), q = queues[k]
        wi, node, tg = q.pop(0)
        if not q:
            queues.pop(k)

        def fits(fr_row, amt_row, plane):
            return all(not (0 <= fr < F) or amt <= available(
                rows, plane, node, fr, depth)
                for fr, amt in zip(fr_row, amt_row))
        admit = bool(c["fit_mask"][wi]) and fits(c["dec_fr"][wi],
                                                 c["dec_amt"][wi], check)
        is_pre = bool(c["preempt_mask"][wi])
        overlap = is_pre and any(used[tk] for tk, _ in tg)
        preempting = False
        if is_pre and not overlap:
            for f in range(F):
                for tk, tn in tg:
                    d = int(c["tu_delta"][tk, f])
                    if d:
                        remove_usage(rows, trial, tn, d, f, depth)
            preempting = fits(c["pre_fr"][wi], c["pre_amt"][wi], trial)
            for tk, _ in tg:
                used[tk] |= preempting
            src, dst = (trial, check) if preempting else (check, trial)
            for _, tn in tg:
                for n in chain(rows["parent"], tn, depth):
                    dst[n] = src[n]
        col = [0] * F
        if admit:
            for fr, amt in zip(c["dec_fr"][wi], c["dec_amt"][wi]):
                if 0 <= fr < F:
                    col[fr] = w32(col[fr] + int(amt))
        if preempting:
            for fr, amt in zip(c["pre_fr"][wi], c["pre_amt"][wi]):
                if 0 <= fr < F:
                    col[fr] = w32(col[fr] + int(amt))
        if c["res_mask"][wi]:
            cq = int(c["wl_cq"][wi])
            for fr, amt in zip(c["res_fr"][wi], c["res_amt"][wi]):
                if not 0 <= fr < F:
                    continue
                cur = int(usage[node, fr])
                if c["res_borrows"][wi]:
                    d = min(int(amt), w32(int(c["npb_cq"][cq, fr]) - cur))
                else:
                    d = max(0, min(int(amt), w32(
                        int(c["nominal_cq"][cq, fr]) - cur)))
                col[fr] = w32(col[fr] + d)
        for f in range(F):
            if col[f] != 0:
                add_usage(rows, usage, node, col[f], f, depth)
                add_usage(rows, check, node, col[f], f, depth)
                for n in chain(rows["parent"], node, depth):
                    trial[n, f] = check[n, f]
        assert np.array_equal(trial, check)
        out[0][wi], out[1][wi], out[2][wi] = admit, preempting, \
            is_pre and overlap
    return (*out, error)


PREEMPT_ARG_NAMES = tt.ADMIT_ARGS + tt.PREEMPT_ARGS + ("order",)


def _jax_preempt(args, depth):
    return [np.asarray(x) for x in jcycle.admit_scan_preempt(
        *[jnp.asarray(a) for a in args], depth=depth)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", [label for label, _ in
                                  tt.PREEMPT_ROUTE_CASES] + ["cross_forest"])
def test_preempt_forest_warps_match_jax(case, seed):
    """The preempt scan decided forest by forest — a warp per forest,
    forests by the tables (joined where a target crosses) or by roots,
    one to 132 blocks, warps interleaved at random, trial rows restored
    along the targets' chains — gives the JAX scan's admitted,
    preempting and overlap_skip, values and dtypes."""
    label, args, depth, (fon, nf) = next(
        x for x in tt.preempt_route_cases(seed) if x[0] == case)
    c = dict(zip(PREEMPT_ARG_NAMES, args))
    want = _jax_preempt(args, depth)
    rng = np.random.default_rng(seed + 1)
    ids = [np.maximum(fon, 0)]
    if case != "cross_forest":
        ids.append(flat_forest_ids(c, False))        # forests by roots
    for fid in ids:
        for B in FLAT_GRIDS:
            *got, error = emu_preempt_scan(c, depth, fid, B, rng)
            assert not error, (case, B)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), \
                    (case, B)
    if case == "cross_forest":
        assert want[1][0]          # the head preempts across two cohorts
    else:
        assert want[1].any() or seed, case


def test_preempt_depth_17_and_wide_targets_match_jax():
    """A cohort chain 17 levels deep (shape_cases' preempt cycle: every
    target in the one forest) and the sweep's widest cycle (1,024 heads,
    4,096 targets, up to 16 a head, targets anywhere: joined tables)."""
    for args, depth in (
            next((a, k["depth"]) for n, a, k in tt.shape_cases(0)
                 if n == "admit_scan_preempt"),
            [(a, k["depth"]) for n, a, k in tt.kernel_cases(0)
             if n == "admit_scan_preempt"][5]):
        c = dict(zip(PREEMPT_ARG_NAMES, args))
        fon, _ = tt.preempt_tables(args)
        want = _jax_preempt(args, depth)
        *got, error = emu_preempt_scan(c, depth, fon, 3,
                                       np.random.default_rng(0))
        assert not error
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert want[1].any()


def test_preempt_join_and_wrong_labels():
    """join_target_forests merges the forests a preempting head and its
    targets connect (each group under its least label, the other trees
    untouched) and leaves Kueue-like labels as given; under the unjoined
    labels the design sets the error word instead of deciding."""
    c = tt.cross_forest_case()
    labels, joined = join_target_forests(c["forest_of_node"],
                                         c["n_forests"], c["wl_cq"],
                                         c["preempt_mask"], c["tgt_mat"],
                                         c["tu_cq"])
    assert joined and labels.tolist() == [0] * 6
    *_, error = emu_preempt_scan(c, c["depth"], c["forest_of_node"], 2,
                                 np.random.default_rng(0))
    assert error
    for seed in range(4):
        rng = np.random.default_rng(seed)
        s = tt.preempt_cycle(rng, n_cqs=30, n_cohorts=10, depth=3, F=2,
                             W=40, R=2, T=64, MT=4, n_targets=20, roots=6)
        fon, n = s["forest_of_node"], s["n_forests"]
        labels, joined = join_target_forests(fon, n, s["wl_cq"],
                                             s["preempt_mask"], s["tgt_mat"],
                                             s["tu_cq"])
        pre = np.nonzero(s["preempt_mask"] & (s["wl_cq"] >= 0))[0]
        for w in pre:
            for t in s["tgt_mat"][w]:
                if t >= 0:
                    assert labels[s["tu_cq"][t]] == labels[s["wl_cq"][w]]
        assert joined == bool((labels != fon).any())
        # a label is one of its group's, and trees stay whole
        assert all(len(set(labels[fon == f].tolist())) == 1
                   for f in range(n))
        assert all(labels[fon == f][0] <= f for f in range(n))
        k = tt.preempt_cycle(rng, n_cqs=30, n_cohorts=10, depth=3, F=2,
                             W=40, R=2, T=64, MT=4, n_targets=20, roots=6,
                             in_forest=True)
        same, joined = join_target_forests(
            k["forest_of_node"], k["n_forests"], k["wl_cq"],
            k["preempt_mask"], k["tgt_mat"], k["tu_cq"])
        assert not joined and same is k["forest_of_node"]


# -- kq_fs_merge_order by rank (mesh_gather.cu) -------------------------------

I32_MAX_KEY = 2**31 - 1


def emu_merge_rank(winners, head_of, W: int) -> np.ndarray:
    """A warp per shard: the valid prefix (the first winner outside [0,
    n) ends it), the emitted ids marked and the least never emitted, the
    keys head_of[min(winners[k:len], never)] by 32-wide tiles from the
    end (a suffix minimum within the tile, then the carry); then each
    emission at k + the keys below its key in every other shard (lower
    bounds), positions past W dropped, -1 after the last."""
    keys, lens = [], []
    for w, h in zip(winners, head_of):
        w, n = [int(x) for x in w], len(h)
        bad = [k for k in range(n) if not 0 <= w[k] < n]
        ln = bad[0] if bad else n
        seen = [False] * n
        for k in range(ln):
            seen[w[k]] = True
        never = next((i for i in range(n) if not seen[i]), n)
        key = [0] * ln
        carry = never
        for base in range(((ln - 1) >> 5) << 5, -1, -32):
            vals = [w[base + l] if base + l < ln else I32_MAX_KEY
                    for l in range(32)]
            suff = [min(vals[l:]) for l in range(32)]
            v = [min(x, carry) for x in suff]
            for l in range(32):
                if base + l < ln:
                    key[base + l] = int(h[v[l]])
            carry = v[0]
        assert key == sorted(key)
        keys.append(key)
        lens.append(ln)
    order = np.full(W, -1, dtype=np.int32)
    for s, key in enumerate(keys):
        for k in range(lens[s]):
            pos = k + sum(int(np.searchsorted(keys[q], key[k], "left"))
                          for q in range(len(keys)) if q != s)
            if pos < W:
                order[pos] = head_of[s][winners[s][k]]
    assert (order[:min(W, sum(lens))] >= 0).all()
    return order


# (W, S, n_valid, shards with no head, short)
MERGE_DESIGN_CASES = [(1, 1, 1, (), False), (40, 1, 40, (), True),
                      (64, 2, 64, (), False), (64, 2, 50, (), True),
                      (200, 8, 190, (2, 5), False), (200, 8, 200, (), True),
                      (100, 32, 90, (0, 31), False),
                      (300, 32, 300, (), True), (1000, 8, 1000, (), False)]


@pytest.mark.parametrize("W,S,n_valid,empty,short", MERGE_DESIGN_CASES)
def test_merge_rank_matches_round_merge(W, S, n_valid, empty, short):
    """Suffix-minimum keys and merge-path positions give
    fs_merge_order_plain's round-by-round order: permutations, a
    sequence that ends early, shards without heads, heads in no shard."""
    import torch
    rng = np.random.default_rng(W * 37 + S)
    winners, head_of = tt.merge_case(rng, W=W, S=S, n_valid=n_valid,
                                     empty=empty, short=short)
    want = psh.fs_merge_order_plain(
        tuple(torch.from_numpy(w) for w in winners),
        tuple(torch.from_numpy(h) for h in head_of), W).numpy()
    got = emu_merge_rank(winners, head_of, W)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _fs_cases():
    return [(i, a, k) for i, (n, a, k) in enumerate(tt.fs_cases(0))
            if n == "fs_admit_scan"]


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("i", [i for i, _, _ in _fs_cases()])
def test_merge_rank_of_forest_shards_is_the_jax_order(i, S):
    """The fair-sharing sweep split by forest over S shards: the JAX
    scan of each shard's heads (the others invalid), merged by rank,
    gives the JAX scan of all heads' order."""
    _, args, kw = next(x for x in _fs_cases() if x[0] == i)
    from kueue_tpu_torch.ops.fs_scan import FS_ARGS
    c = dict(zip(FS_ARGS, args))
    jkw = dict(depth=kw["depth"], n_levels=kw["n_levels"])
    W = len(c["wl_cq"])

    def jax_order(valid):
        a = [c[k] if k != "valid" else valid for k in FS_ARGS[:-1]]
        return np.asarray(jfs.fs_admit_scan(*[jnp.asarray(x) for x in a],
                                            **jkw)[0])
    want = jax_order(c["valid"])
    shard = c["forest_of_node"][np.maximum(c["wl_cq"], 0)] % S
    winners, head_of = [], []
    for s in range(S):
        valid = c["valid"] & (shard == s)
        h = np.flatnonzero(valid).astype(np.int32)
        order = jax_order(valid)
        local = {int(g): j for j, g in enumerate(h)}
        w = np.full(len(h), -1, dtype=np.int32)
        seq = [local[int(g)] for g in order if g >= 0]
        w[:len(seq)] = seq
        winners.append(w)
        head_of.append(h)
    got = emu_merge_rank(winners, head_of, W)
    assert np.array_equal(got, want), (i, S)


# -- minimal_preemptions_batch, a warp per search (minimal_preemptions.cu) ---

from kueue_tpu.ops import preemption_kernel as jpk   # noqa: E402
from kueue_tpu_torch import kernels as tkernels      # noqa: E402

OTHER, ABOVE = 1 << 29, 1 << 30
CQ_MASK = OTHER - 1


def undo_add(c, usage, node, delta, f, depth):
    """flat_forest.cuh UndoAddStep, up a chain."""
    carry = delta
    for n in chain(c["parent"], node, depth):
        u = w32(int(usage[n, f]) - carry)
        usage[n, f] = u
        carry = max(0, w32(carry - max(0, w32(int(c["guaranteed"][n, f])
                                              - u))))


def search_rows(c, s: int, staged: bool) -> dict:
    """Search s's tree as its warp reads it: the staged slice (cap =
    subtree at roots, borrow cap below; has-borrow-limit bits in 32-bit
    words) or the input planes (the global route)."""
    keys = ("parent", "subtree", "guaranteed", "borrow_cap", "has_blim")
    rows = {k: c[k][s] for k in keys}
    if not staged:
        return rows
    par = rows["parent"]
    NL, F = rows["guaranteed"].shape
    cap = np.where((par < 0)[:, None], rows["subtree"], rows["borrow_cap"])
    words = np.zeros((NL, -(-F // 32)), dtype=np.int64)
    for f in range(F):
        words[:, f // 32] |= rows["has_blim"][:, f].astype(np.int64) \
            << (f % 32)
    blim = np.array([[(words[n, f // 32] >> (f % 32)) & 1 for f in range(F)]
                     for n in range(NL)], dtype=bool).reshape(NL, F)
    return dict(parent=par, subtree=cap, borrow_cap=cap,
                guaranteed=rows["guaranteed"], has_blim=blim)


def emu_search(c, s: int, depth: int, staged: bool):
    """One warp's search: the candidates' code words up to the last real
    one; the forward loop (the borrowing skip on the subtree rows, the
    threshold flip, remove_usage, the vote of workloadFits) marking the
    removed bits; the reverse loop word by word from the top, each word's
    bits from the highest (the last removed one's word below it), adding
    back, keeping a fill-back that still fits and undoing the others;
    the mask written from each word."""
    rows = search_rows(c, s, staged)
    sub = c["subtree"][s]
    usage = c["usage0"][s].astype(np.int64).copy()
    K = c["cand_cq"].shape[1]
    F = usage.shape[1]
    code = [-1 if c["cand_cq"][s, k] < 0 else int(c["cand_cq"][s, k])
            | (OTHER if c["cand_other_cq"][s, k] else 0)
            | (ABOVE if c["cand_above_threshold"][s, k] else 0)
            for k in range(K)]
    n_k = max([k + 1 for k in range(K) if code[k] >= 0], default=0)
    delta = c["cand_delta"][s]
    pcq = int(c["pre_cq"][s])
    wu, need = c["wl_usage"][s], c["frs_mask"][s]

    def fits(allow_b):
        ok, borrow = True, False
        for f in range(F):
            w = int(wu[f])
            if w <= 0:
                continue
            if not w <= available(rows, usage, pcq, f, depth):
                ok = False
            if w32(int(usage[pcq, f]) + w) > sub[pcq, f]:
                borrow = True
        return ok and (allow_b or not borrow)

    bits = [0] * -(-n_k // 32)
    allow_b = bool(c["allow_borrowing0"][s])
    thr = bool(c["threshold_enabled"][s])
    fitted, last = False, -1
    for k in range(n_k):
        if fitted:
            break
        if code[k] < 0:
            continue
        cq = code[k] & CQ_MASK
        if code[k] & OTHER:
            if not any(need[f] and usage[cq, f] > sub[cq, f]
                       for f in range(F)):
                continue
            if thr and code[k] & ABOVE:
                allow_b = False
        for f in range(F):
            if delta[k, f]:
                remove_usage(rows, usage, cq, int(delta[k, f]), f, depth)
        bits[k >> 5] |= 1 << (k & 31)
        last = k
        fitted = fits(allow_b)
    mask = np.zeros(K, dtype=bool)
    if not fitted:
        return False, mask
    top = last >> 5
    for wd in range(top, -1, -1):
        below = (last & 31) if wd == top else 32
        word = bits[wd] & ((1 << below) - 1)
        keep = word
        while word:
            b = word.bit_length() - 1
            word &= ~(1 << b)
            k = wd * 32 + b
            cq = code[k] & CQ_MASK
            for f in range(F):
                if delta[k, f]:
                    add_usage(rows, usage, cq, int(delta[k, f]), f, depth)
            if fits(allow_b):
                keep &= ~(1 << b)
            else:
                for f in range(F):
                    if delta[k, f]:
                        undo_add(rows, usage, cq, int(delta[k, f]), f, depth)
        if wd == top:
            keep |= 1 << (last & 31)
        for lane in range(32):
            if wd * 32 + lane < K:
                mask[wd * 32 + lane] = (keep >> lane) & 1
    return True, mask


def _search_case(row: int, seed: int):
    """testing.SEARCH_SHAPES' row, its searches shuffled so that padding
    searches lie between real ones."""
    S, n_valid, K, n_c, n_cqs, n_coh, depth, F = tt.SEARCH_SHAPES[row]
    rng = np.random.default_rng(seed)
    c = tt.preemption_searches(rng, S=S, n_valid=n_valid, K=K, n_cands=n_c,
                               n_cqs=n_cqs, n_cohorts=n_coh, depth=depth, F=F)
    perm = rng.permutation(S)
    for k in tt.SEARCH_ARGS:
        c[k] = np.ascontiguousarray(c[k][perm])
    return c


@pytest.mark.parametrize("staged", [True, False], ids=["shared", "global"])
@pytest.mark.parametrize("row", range(len(tt.SEARCH_SHAPES)))
def test_search_warps_match_jax(row, staged):
    """minimal_preemptions_batch a warp at a time — padding searches
    between real ones, each search on its staged slice or on the input
    planes — gives the JAX batch's fitted and target masks."""
    c = _search_case(row, row)
    args = tt.search_args(c)
    want_f, want_m = (np.asarray(x) for x in jpk.minimal_preemptions_batch(
        *[jnp.asarray(a) for a in args], depth=c["depth"]))
    S = len(c["pre_cq"])
    for s in range(S):
        if c["pre_cq"][s] < 0:
            got = (False, np.zeros(c["cand_cq"].shape[1], dtype=bool))
        else:
            got = emu_search(c, s, c["depth"], staged)
        assert got[0] == want_f[s], (row, s)
        assert np.array_equal(got[1], want_m[s]), (row, s)
    if S > 1:
        real = np.flatnonzero(c["pre_cq"] >= 0)
        assert (c["pre_cq"] < 0).sum() == 0 or real.max() > np.flatnonzero(
            c["pre_cq"] < 0).min()
    assert want_f.any() and (want_m.sum(1) > 1).any() or S == 1


def test_search_deep_chain_and_k_1024_match_jax():
    """The warp's search on a cohort chain 17 levels deep (the walks past
    four levels) and at K = 1,024 (32 words of removed bits), both
    routes."""
    rng = np.random.default_rng(5)
    deep = tt.preemption_searches(rng, S=8, K=16, n_cands=12, F=2, n_cqs=6,
                                  n_cohorts=16, depth=2, chain=True)
    wide = tt.preemption_searches(rng, S=4, K=1024, n_cands=1000, F=2,
                                  n_cqs=6, n_cohorts=3, depth=3)
    for c in (deep, wide):
        args = tt.search_args(c)
        want_f, want_m = (np.asarray(x) for x in
                          jpk.minimal_preemptions_batch(
                              *[jnp.asarray(a) for a in args],
                              depth=c["depth"]))
        for staged in (True, False):
            for s in range(len(c["pre_cq"])):
                f, m = emu_search(c, s, c["depth"], staged)
                assert f == want_f[s] and np.array_equal(m, want_m[s]), s
    assert deep["depth"] == 17


def test_search_layout_routes():
    """search_layout stages the tree and the candidates of every search
    of testing.SEARCH_SHAPES but the last (29,000 CQs: its tree global,
    its candidates staged), stages K = 1,024 at F = 2 four searches to a
    block, and halves the searches per block before a part goes
    global."""
    for S, _, K, _, n_cqs, n_coh, _, F in tt.SEARCH_SHAPES[:-1]:
        warps, tree, cands = tkernels.search_layout(n_cqs + n_coh, F, K)
        assert (warps, bool(tree), bool(cands)) == (4, True, True)
    _, _, K, _, n_cqs, n_coh, _, F = tt.SEARCH_SHAPES[-1]
    warps, tree, cands = tkernels.search_layout(n_cqs + n_coh, F, K)
    assert tree == 0 and cands > 0
    assert tkernels.search_layout(8, 2, 1024)[0] == 4
    warps, tree, cands = tkernels.search_layout(8, 32, 1024)
    assert warps == 1 and tree and cands
    budget = tkernels.SMEM_LIMIT // 4
    warps, tree, cands = tkernels.search_layout(3000, 3, 16)
    assert warps == 1 and warps * (tree + cands) <= budget and tree


# -- the phase-1 kernels: kq_cycle_order, kq_classify_heads (solve_cycle.cu) -

from kueue_tpu.ops.quota_kernel import available_all as javailable  # noqa

U32 = 0xffffffff


def ts_key(ts) -> np.ndarray:
    """kq_ts_key: float32 → uint32 in XLA's sort order (-0 as +0, every
    NaN one NaN after +inf)."""
    ts = np.asarray(ts, dtype=np.float32)
    b = ts.view(np.uint32).astype(np.uint64)
    b = np.where(ts == 0, 0, b)
    b = np.where(np.isnan(ts), 0x7fc00000, b)
    return np.where(b & 0x80000000, ~b & U32, b | 0x80000000)


def prio_key(prio) -> np.ndarray:
    """kq_prio_key: -priority wrapping at INT_MIN, in unsigned order."""
    return (((-np.asarray(prio, dtype=np.int64)) & U32)
            ^ 0x80000000).astype(np.uint64)


def key_less(bh, bl, ah, al):
    return (bh < ah) | ((bh == ah) & (bl < al))


def emu_order_registers(borrows, prio, ts, P: int, E: int):
    """The registers route, thread t's register r holding head r * T + t
    in position t * E + r → (order [W], shared stages).  Each stage checks
    where its partner lies: this thread, a lane of this warp (a shuffle),
    or another warp (both through the shared buffer laid out r * T + t,
    behind one barrier)."""
    W, T = len(borrows), P // E
    assert T >= 32 and T % 32 == 0
    tid = np.arange(T)[:, None]
    r = np.arange(E)[None, :]
    head = r * T + tid                                    # [T, E]
    real = head < W
    h = np.minimum(head, W - 1)
    tk = ts_key(ts)[h]
    hi = ((np.asarray(borrows)[h].astype(np.uint64) << 63)
          | (prio_key(prio)[h] << 31) | (tk >> 1))
    lo = ((tk & 1) << 31) | head.astype(np.uint64)
    hi = np.where(real, hi, np.uint64(2**64 - 1)).astype(np.uint64)
    lo = np.where(real, lo, U32).astype(np.uint64)
    pos = tid * E + r
    warp = np.arange(T) // 32
    cross, shared, k = 32 * E, 0, 2
    while k <= P:
        up = (pos & k) == 0
        j = k // 2
        while j >= cross:                        # another warp
            x = j // E
            other = np.arange(T) ^ x
            assert (warp[other] != warp).all()
            buf_h = np.empty(P, np.uint64)
            buf_l = np.empty(P, np.uint64)
            buf_h[r * T + tid] = hi
            buf_l[r * T + tid] = lo
            at = r * T + other[:, None]
            oh, ol = buf_h[at], buf_l[at]
            lower = (tid & x) == 0
            take = key_less(oh, ol, hi, lo) == (lower == up)
            hi, lo = np.where(take, oh, hi), np.where(take, ol, lo)
            shared += 1
            j //= 2
        j = min(k // 2, cross // 2)
        while j >= E:                            # a lane of this warp
            x = j // E
            other = np.arange(T) ^ x
            assert (warp[other] == warp).all()
            oh, ol = hi[other], lo[other]
            lower = (tid & x) == 0
            take = key_less(oh, ol, hi, lo) == (lower == up)
            hi, lo = np.where(take, oh, hi), np.where(take, ol, lo)
            j //= 2
        j = E // 2
        while j >= 1:                            # this thread
            if j < k:
                for a in range(E):
                    b = a ^ j
                    if b > a:
                        swap = key_less(hi[:, b], lo[:, b], hi[:, a],
                                        lo[:, a]) == up[:, a]
                        for arr in (hi, lo):
                            x_a, x_b = arr[:, a].copy(), arr[:, b].copy()
                            arr[:, a] = np.where(swap, x_b, x_a)
                            arr[:, b] = np.where(swap, x_a, x_b)
            j //= 2
        k *= 2
    hi, lo = hi.reshape(-1), lo.reshape(-1)             # by position
    assert (hi[W:] == 2**64 - 1).all() and (lo[W:] == U32).all()
    return (lo[:W] & 0x7fffffff).astype(np.int32), shared


def emu_order_global(borrows, prio, ts, P: int):
    """The global route: the bitonic network over P two-word keys (hi =
    borrows << 32 | priority key, lo = ts key << 32 | index)."""
    W = len(borrows)
    i = np.arange(P)
    h = np.minimum(i, W - 1)
    hi = (np.asarray(borrows)[h].astype(np.uint64) << 32) | prio_key(prio)[h]
    lo = (ts_key(ts)[h] << 32) | i.astype(np.uint64)
    hi = np.where(i < W, hi, np.uint64(2**64 - 1)).astype(np.uint64)
    lo = np.where(i < W, lo, np.uint64(2**64 - 1)).astype(np.uint64)
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            a = i[(i ^ j) > i]
            b = a ^ j
            up = (a & k) == 0
            after = (hi[a] > hi[b]) | ((hi[a] == hi[b]) & (lo[a] > lo[b]))
            s = after == up
            for arr in (hi, lo):
                x_a, x_b = arr[a].copy(), arr[b].copy()
                arr[a] = np.where(s, x_b, x_a)
                arr[b] = np.where(s, x_a, x_b)
            j //= 2
        k *= 2
    return (lo[:W] & U32).astype(np.int32)


def emu_cycle_order(borrows, prio, ts):
    """kq_cycle_order on the route order_layout gives → (order, route,
    shared stages)."""
    P, E, smem = tkernels.order_layout(len(borrows))
    if E == 0:
        return emu_order_global(borrows, prio, ts, P), "global", 0
    buffers = 2 if E < 16 else 1
    assert smem == (12 * buffers * P if P > 32 * E else 0) \
        <= tkernels.SMEM_LIMIT
    order, shared = emu_order_registers(borrows, prio, ts, P, E)
    return order, "registers", shared


def jax_order(borrows, prio, ts):
    W = len(borrows)
    return np.asarray(jnp.lexsort((jnp.arange(W), jnp.asarray(ts),
                                   -jnp.asarray(prio),
                                   jnp.asarray(borrows).astype(jnp.int32))))


# W: 1 and 2 (one warp of padding), 31 / 33 / 128 / 129 (the one-warp
# boundary), 1,000 and 1,025, 4,096 / 4,097 (E = 4 → 8), 8,192 / 8,193
# (E = 8 → 16, one buffer), 16,384 (the widest registers sort) and 16,385
# (the global route)
ORDER_DESIGN_WIDTHS = (1, 2, 31, 33, 128, 129, 1000, 1025, 4096, 4097,
                       8192, 8193, 16384, 16385)


@pytest.mark.parametrize("W", ORDER_DESIGN_WIDTHS)
def test_cycle_order_stages_match_lexsort(W):
    """kq_cycle_order's stages on testing.order_case's keys (INT_MIN,
    -0.0, NaN, ties) give jnp.lexsort's order; 1,000 heads take 6 stages
    behind a barrier; past 16,384 heads the global route."""
    borrows, prio, ts = tt.order_case(np.random.default_rng(W), W)
    got, route, shared = emu_cycle_order(borrows, prio, ts)
    assert got.dtype == np.int32
    assert np.array_equal(got, jax_order(borrows, prio, ts)), W
    assert route == ("global" if W > tkernels.ORDER_CHIP_MAX
                     else "registers")
    if W == 1000:
        assert shared == 6
    if W <= 128:
        assert shared == 0


@pytest.mark.parametrize("W", [1, 5, 1000])
def test_cycle_order_global_route_matches_lexsort(W, monkeypatch):
    """With no shared memory allowed (SORT_SMEM = 0, as chip_smoke's 3f
    forces it) every width takes the global route, and it gives
    jnp.lexsort's order."""
    monkeypatch.setattr(tkernels, "SORT_SMEM", 0)
    borrows, prio, ts = tt.order_case(np.random.default_rng(W), W)
    got, route, _ = emu_cycle_order(borrows, prio, ts)
    assert route == "global"
    assert np.array_equal(got, jax_order(borrows, prio, ts)), W


def test_cycle_order_keys_split_at_bit_32():
    """The registers route's 96-bit key orders as (borrows, -priority,
    timestamp, index): a head differing only in the timestamp's lowest
    bit, or only in the index, sorts by it."""
    ts = np.array([1.0, np.nextafter(np.float32(1.0), np.float32(2.0)),
                   1.0, -0.0, 0.0, np.nan, np.inf], dtype=np.float32)
    prio = np.array([3, 3, 3, -2**31, -2**31, 2**31 - 1, 0], np.int32)
    borrows = np.array([1, 1, 1, 0, 0, 0, 1], dtype=bool)
    got, _, _ = emu_cycle_order(borrows, prio, ts)
    assert np.array_equal(got, jax_order(borrows, prio, ts))
    assert got.tolist() == [3, 4, 5, 0, 2, 1, 6]


def emu_classify_heads(c, avail0, potential0, pairs: bool):
    """kq_classify_heads a warp at a time, the 32 lanes as vectors: G
    lanes a head (kernels.classify_layout), lane g owning slot s0 + g of
    each chunk of G slots; a lane folds its slot's pair votes
    KQ_CLASSIFY_RC resources at a time, four ballots cut to the group's
    bits give the slot masks, the walk takes their lowest set bits; lane 0
    writes the head, lanes g, g + G, ... the chosen slot's pairs."""
    wl_cq, req = c["wl_cq"], c["wl_requests"].astype(np.int64)
    start, slot_fr, slot_valid = c["start_slot"], c["slot_fr"], \
        c["slot_valid"]
    nominal, usage0, subtree = c["nominal_cq"], c["usage0"], c["subtree"]
    can_pb, wcb, wcp = c["cq_can_preempt_borrow"], c["cq_wcb_borrow"], \
        c["cq_wcp_preempt"]
    W = len(wl_cq)
    _, S, R = slot_fr.shape
    G, _ = tkernels.classify_layout(S)
    RC = 4                                    # KQ_CLASSIFY_RC
    lane = np.arange(32)
    g, base = lane % G, lane - lane % G
    gmask = (1 << G) - 1

    def ballot(v):
        bits = int(np.sum(v.astype(np.int64) << lane))
        return np.array([(bits >> int(b)) & gmask for b in base], np.int64)

    def ffs(m):                               # lowest set bit, -1 for none
        return np.where(m != 0, np.log2(np.maximum(m & -m, 1)).astype(int),
                        -1)

    fit_slot0 = np.full(W, -7, np.int32)
    borrows0 = np.zeros(W, bool)
    preempt0 = np.zeros(W, bool)
    dec_fr = np.full((W, R), -7, np.int32)
    dec_amt = np.full((W, R), -7, np.int32)
    fit_mask = np.zeros(W, bool)
    for wp in range(-(-W * G // 32)):
        w = (wp * 32 + lane) // G
        live = w < W
        wc = np.minimum(w, W - 1)
        q = np.where(live, wl_cq[wc], -1)
        valid, cq = q >= 0, np.maximum(q, 0)
        st = np.where(live, start[wc], 0)
        has_parent = c["parent"][cq] >= 0
        stop_idx = np.full(32, -1)
        stop_mode = np.zeros(32, int)
        best_idx, best_mode = np.zeros(32, int), np.full(32, -1)
        stop_b, best_b = np.zeros(32, bool), np.zeros(32, bool)
        for s0 in range(0, S, G):
            s = s0 + g
            inn = live & (s < S)
            sc = np.minimum(s, S - 1)
            slot_ok = inn & slot_valid[cq, sc]
            missing, notfit, nofit, borrow = (np.zeros(32, bool)
                                              for _ in range(4))
            for r0 in range(0, R, RC):
                for i in range(RC):           # the lane's loads, then votes
                    ok = inn & (r0 + i < R)
                    r = min(r0 + i, R - 1)
                    fr = np.where(ok, slot_fr[cq, sc, r], -1)
                    rq = np.where(ok, req[wc, r], 0)
                    rel = (fr >= 0) & (rq > 0)
                    o = (cq, np.maximum(fr, 0))
                    fit_r = rq <= avail0[o]
                    missing |= (rq > 0) & (fr < 0)
                    notfit |= rel & ~fit_r
                    nofit |= rel & ((rq > potential0[o]) | (
                        ~fit_r & ~((rq <= nominal[o]) | can_pb[cq])))
                    borrow |= rel & (np.array([w32(x) for x in
                                               usage0[o] + rq]) > subtree[o])
            fit = ~notfit & ~missing & slot_ok
            pre = ~fit & ~(nofit | missing | ~slot_ok)
            bor = borrow & has_parent
            active = s >= st
            stop = active & (fit | (pre & wcp[cq])) & (~bor | wcb[cq])
            m_fit, m_pre, m_stop, m_bor = (ballot(v) for v in (
                inn & active & fit, inn & active & pre, inn & stop,
                inn & bor))
            first = (stop_idx < 0) & (m_stop != 0)
            i = np.maximum(ffs(m_stop), 0)
            stop_idx = np.where(first, s0 + i, stop_idx)
            stop_mode = np.where(first, np.where((m_fit >> i) & 1, 2, 1),
                                 stop_mode)
            stop_b = np.where(first, ((m_bor >> i) & 1) != 0, stop_b)
            mode = np.where(m_fit != 0, 2, np.where(m_pre != 0, 1, 0))
            i = np.where(mode == 2, ffs(m_fit),
                         np.where(mode == 1, ffs(m_pre), 0))
            better = mode > best_mode
            best_idx = np.where(better, s0 + i, best_idx)
            best_mode = np.where(better, mode, best_mode)
            best_b = np.where(better, ((m_bor >> i) & 1) != 0, best_b)
        has_stop = stop_idx >= 0
        mode = np.where(has_stop, stop_mode, best_mode)
        has_fit = valid & (mode == 2)
        fit_slot = np.where(has_fit, np.where(has_stop, stop_idx, best_idx),
                            -1)
        for ln in np.flatnonzero(live):
            wi = w[ln]
            if g[ln] == 0:
                fit_slot0[wi] = fit_slot[ln]
                borrows0[wi] = has_fit[ln] and (stop_b[ln] if has_stop[ln]
                                                else best_b[ln])
                preempt0[wi] = valid[ln] and mode[ln] == 1
                fit_mask[wi] = has_fit[ln]
            if not pairs:
                continue
            cs = max(fit_slot[ln], 0)
            for r in range(g[ln], R, G):
                fr = slot_fr[cq[ln], cs, r]
                ok = has_fit[ln] and fr >= 0 and req[wi, r] > 0
                dec_fr[wi, r] = fr if ok else -1
                dec_amt[wi, r] = req[wi, r] if ok else 0
    out = (fit_slot0, borrows0, preempt0)
    return out + (dec_fr, dec_amt, fit_mask) if pairs else out


def _classify_case(shape, seed: int):
    """A solve_cycle_planes case of ``shape`` (testing.SOLVE_SHAPES'
    columns) with the fungibility planes, and the CQ rows of both
    availabilities from the JAX ``available_all``."""
    n_cqs, n_coh, depth, S, R, F, W, n_valid = shape
    c = tt.solve_cycle_planes(np.random.default_rng(seed), n_cqs=n_cqs,
                              n_cohorts=n_coh, depth=depth, S=S, R=R, F=F,
                              W=W, n_valid=n_valid)
    q = [jnp.asarray(c[k]) for k in tt.SOLVE_ARGS[:6]]
    avail0 = np.asarray(javailable(*q, c["depth"]))[:n_cqs]
    potential0 = np.asarray(javailable(jnp.zeros_like(q[0]), *q[1:],
                                       c["depth"]))[:n_cqs]
    return c, avail0, potential0


def _jax_classify(c):
    """The JAX solve_cycle's classify (run_scan=False) → (fit_slot0,
    borrows0, preempt0) and decision_pairs_from_slots of it."""
    out = jcycle.solve_cycle(
        *[jnp.asarray(a) for a in tt.solve_args(c)], depth=c["depth"],
        run_scan=False, cq_wcb_borrow=jnp.asarray(c["cq_wcb_borrow"]),
        cq_wcp_preempt=jnp.asarray(c["cq_wcp_preempt"]),
        start_slot=jnp.asarray(c["start_slot"]))
    fit_slot0, borrows0, preempt0 = (np.asarray(out[i]) for i in (4, 5, 3))
    pairs = jcycle.decision_pairs_from_slots(
        c["slot_fr"], c["wl_cq"], c["wl_requests"], fit_slot0)
    return (fit_slot0, borrows0, preempt0) + tuple(np.asarray(x)
                                                   for x in pairs)


@pytest.mark.parametrize("loop", [False, True], ids=["layout", "loop"])
@pytest.mark.parametrize("row", range(len(tt.SOLVE_SHAPES)))
def test_classify_groups_match_jax(row, loop, monkeypatch):
    """kq_classify_heads' lane groups (G = S rounded up: 4 lanes for 3
    slots, 1 for 1 — 32 heads a warp — padding groups past W, seven
    resources in two loads of four) or, past 32 slots or with
    CLASSIFY_LANES = 0, a warp per head looping over chunks of slots: the
    JAX classify and its decision pairs exactly, with resume slots,
    whenCanBorrow / whenCanPreempt, wrapping adds and padding heads."""
    if loop:
        monkeypatch.setattr(tkernels, "CLASSIFY_LANES", 0)
    shape = tt.SOLVE_SHAPES[row]
    c, avail0, potential0 = _classify_case(shape, row)
    S = shape[3]
    assert tkernels.classify_layout(S)[1] == (loop or S > 32)
    want = _jax_classify(c)
    got = emu_classify_heads(c, avail0, potential0, pairs=True)
    for x, y in zip(want, got):
        assert x.dtype == y.dtype and np.array_equal(x, y), row
    assert want[0].max() >= 0
    no_pairs = emu_classify_heads(c, avail0, potential0, pairs=False)
    for x, y in zip(got[:3], no_pairs):
        assert np.array_equal(x, y)


def test_classify_layout_routes():
    """Lanes a head: S rounded up to a power of two, the loop route past 32
    slots (testing.SOLVE_SHAPES holds both, and groups of 1, 4 and 8),
    every shape on the loop route with CLASSIFY_LANES = 0."""
    got = {tkernels.classify_layout(s[3]) for s in tt.SOLVE_SHAPES}
    assert {(1, False), (4, False), (8, False), (32, True)} <= got
    assert tkernels.classify_layout(32) == (32, False)
    assert tkernels.classify_layout(33) == (32, True)
    assert tkernels.classify_layout(3) == (4, False)
